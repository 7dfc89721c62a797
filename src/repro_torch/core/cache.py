"""Remote-feature caching (the paper's §5 future-work item) and the hot-set
scorer registry — the shared "who's hot" ranking.

Counterpart of ``repro.core.cache`` with the ``degree`` scorer and the
``degree`` cache policy (``frequency`` and ``blend`` are not ported yet).
The serving traffic generator, the arrival-rate calibration and the cache
policies rank hot nodes through the scorer registry.

A ``FeatureCache`` holds, per worker, the sorted ids of the remote nodes it
caches and their feature rows, stacked on the worker axis.  Cache
construction is a registry of policies selected by
``PlanSpec(cache_policy=...)``; the feature fetch serves hits locally and
sends only misses through the exchange (``repro_torch.core.dist``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

SENTINEL = 2 ** 31 - 1


def rank_by_score(scores, k: int | None = None) -> np.ndarray:
    """Node ids ranked hottest-first: score desc, ties broken by id asc.
    Returns the top ``k`` ids (all nodes if ``k`` is None)."""
    scores = np.asarray(scores)
    ids = np.arange(scores.shape[0])
    ranked = ids[np.lexsort((ids, -scores))].astype(np.int32)
    return ranked if k is None else ranked[:k]


class HotSetScorer:
    """Base class of registry entries: maps a graph to per-node hotness
    scores; ``top_ids`` applies the shared ``rank_by_score`` tie-break."""

    name: str = "?"

    def scores(self, graph) -> np.ndarray:
        """(num_nodes,) hotness scores, higher = hotter."""
        raise NotImplementedError

    def top_ids(self, graph, k: int | None = None) -> np.ndarray:
        """Top-``k`` hottest node ids (all nodes if ``k`` is None)."""
        return rank_by_score(self.scores(graph), k)


class DegreeScorer(HotSetScorer):
    """Static: hotness = in-degree."""

    name = "degree"

    def scores(self, graph) -> np.ndarray:
        return graph.degrees().cpu().numpy()


_HOT_SCORERS: dict[str, Callable[..., HotSetScorer]] = {}


def register_hot_scorer(name: str, factory: Callable[..., HotSetScorer],
                        *, overwrite: bool = False) -> None:
    """Register ``factory(*params) -> HotSetScorer`` under ``name``."""
    if not overwrite and name in _HOT_SCORERS \
            and _HOT_SCORERS[name] is not factory:
        raise ValueError(f"hot-set scorer {name!r} already registered; "
                         f"pass overwrite=True to replace it")
    _HOT_SCORERS[name] = factory


def available_hot_scorers() -> tuple[str, ...]:
    """Sorted names of registered hot-set scorers."""
    return tuple(sorted(_HOT_SCORERS))


def resolve_hot_scorer(name: str) -> HotSetScorer:
    """Instantiate the scorer registered under ``name``."""
    from repro_torch.data.naming import parse_param_name
    base, params = parse_param_name(name, "hot-set scorer")
    try:
        factory = _HOT_SCORERS[base]
    except KeyError:
        raise KeyError(f"unknown hot-set scorer {name!r}; "
                       f"available: {available_hot_scorers()}") from None
    return factory(*params)


def _degree_factory(*params):
    if params:
        raise ValueError(f"scorer 'degree' takes no parameters, "
                         f"got {params}")
    return DegreeScorer()


register_hot_scorer("degree", _degree_factory)


# --------------------------------------------------------------------------
# feature caches
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FeatureCache:
    """Per-worker cache of hot remote features, stacked on the worker axis.

    ids:  (P, K) int32 sorted global ids, padded at the end with
          ``SENTINEL`` (larger than any id) so lookup is one searchsorted.
    rows: (P, K, D) the cached feature rows (zero in padded slots).
    """
    ids: torch.Tensor
    rows: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.ids.shape[-1]


def _assemble_cache(layout, capacity: int, per_worker_ids) -> FeatureCache:
    """Stack per-worker remote-id picks into a ``FeatureCache``.

    ``per_worker_ids[p]`` is a (<= capacity,) int array of remote global
    node ids worker p caches; rows are copied from the owners' feature
    shards on the layout's device.
    """
    offsets = layout.offsets.cpu().numpy()
    P = layout.num_parts
    feats = layout.features

    ids_out = np.full((P, capacity), -1, np.int32)
    own = np.zeros((P, capacity), np.int64)
    local = np.zeros((P, capacity), np.int64)
    for p in range(P):
        remote = np.sort(np.asarray(per_worker_ids[p])[:capacity])
        k = remote.size
        ids_out[p, :k] = remote
        own[p, :k] = np.searchsorted(offsets, remote, side="right") - 1
        local[p, :k] = remote - offsets[own[p, :k]]
    dev = feats.device
    rows = feats[torch.from_numpy(own).to(dev),
                 torch.from_numpy(local).to(dev)]
    filled = torch.from_numpy(ids_out >= 0).to(dev)
    rows = torch.where(filled[..., None], rows,
                       torch.zeros((), dtype=feats.dtype, device=dev))
    # keep the padding AFTER the valid ids for searchsorted: replace -1
    # with a sentinel larger than any id
    ids_sorted = np.where(ids_out < 0, np.int32(SENTINEL), ids_out)
    return FeatureCache(ids=torch.from_numpy(ids_sorted).to(dev), rows=rows)


def degree_caches(layout, capacity: int, **_ignored) -> FeatureCache:
    """Per worker, cache the top-``capacity`` highest-in-degree nodes owned
    by OTHER workers.  Returns stacked (P, K) ids / (P, K, D) rows."""
    offsets = layout.offsets.cpu().numpy()
    P = layout.num_parts
    all_ids = resolve_hot_scorer("degree").top_ids(layout.graph)
    owner = np.searchsorted(offsets, all_ids, side="right") - 1
    picks = [all_ids[owner != p][:capacity] for p in range(P)]
    return _assemble_cache(layout, capacity, picks)


# --------------------------------------------------------------------------
# cache-policy registry
# --------------------------------------------------------------------------
# A cache policy is any ``policy(layout, capacity, *, fanouts=None, ...) ->
# FeatureCache``; ``PlanSpec(cache_policy=...)`` selects one by name.

_CACHE_POLICIES: dict[str, Callable] = {}


def register_cache_policy(name: str, policy: Callable, *,
                          overwrite: bool = False) -> None:
    """Register ``policy(layout, capacity, *, fanouts=None, ...)`` under
    ``name``."""
    if not overwrite and name in _CACHE_POLICIES \
            and _CACHE_POLICIES[name] is not policy:
        raise ValueError(f"cache policy {name!r} already registered; "
                         f"pass overwrite=True to replace it")
    _CACHE_POLICIES[name] = policy


def available_cache_policies() -> tuple[str, ...]:
    """Sorted names of registered cache policies."""
    return tuple(sorted(_CACHE_POLICIES))


def resolve_cache_policy(name: str) -> Callable:
    """Look up a cache policy by registry name (KeyError lists names)."""
    try:
        return _CACHE_POLICIES[name]
    except KeyError:
        raise KeyError(f"unknown cache policy {name!r}; "
                       f"available: {available_cache_policies()}") from None


register_cache_policy("degree", degree_caches)
