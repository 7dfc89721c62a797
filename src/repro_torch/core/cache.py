"""Remote-feature caching (the paper's §5 future-work item) and the hot-set
scorer registry — the shared "who's hot" ranking.

Counterpart of ``repro.core.cache``: the ``degree``, ``frequency(decay)``
and ``blend(w)`` scorers, the online ``FrequencyTracker``, and the
``degree`` and ``frequency`` cache policies.  The serving traffic
generator, the recycler's admission, the arrival-rate calibration and the
cache policies rank hot nodes through the scorer registry.  Host-side
numpy, like ``repro``'s, so rankings and cached ids are bit-identical.

A ``FeatureCache`` holds, per worker, the sorted ids of the remote nodes it
caches and their feature rows, stacked on the worker axis.  Cache
construction is a registry of policies selected by
``PlanSpec(cache_policy=...)``; the feature fetch serves hits locally and
sends only misses through the exchange (``repro_torch.core.dist``).

``repro``'s seed API is kept beside it: the deprecated aliases
``degree_hot_ids`` and ``build_degree_caches``, and the cached train step
(``make_cached_worker_step``, ``run_stacked_cached``).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable

import numpy as np
import torch

from repro_torch.core import dist
# the cache-aware fetch lives in dist, a stage of the feature fetch;
# re-exported here, as repro's module does
from repro_torch.core.dist import fetch_features_cached  # noqa: F401

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

    def observe(self, ids) -> None:
        """Fold an access batch into the scorer (no-op when static)."""


class DegreeScorer(HotSetScorer):
    """Static: hotness = in-degree."""

    name = "degree"

    def scores(self, graph) -> np.ndarray:
        return graph.degrees().cpu().numpy()


class FrequencyTracker:
    """Online exponentially-decayed access counts over node ids: counts
    decay by ``decay`` per ``observe`` call, so the hot set follows the
    recent access distribution."""

    def __init__(self, num_nodes: int, *, decay: float = 1.0):
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        self.num_nodes = int(num_nodes)
        self.decay = float(decay)
        self.counts = np.zeros(self.num_nodes, np.float64)
        self.total_observed = 0

    def observe(self, ids) -> None:
        """Fold one batch of node ids into the decayed counts (ids outside
        ``[0, num_nodes)`` are dropped)."""
        ids = np.asarray(ids).ravel()
        ids = ids[(ids >= 0) & (ids < self.num_nodes)]
        if self.decay < 1.0:
            self.counts *= self.decay
        np.add.at(self.counts, ids, 1.0)
        self.total_observed += ids.size

    def topk(self, k: int) -> np.ndarray:
        """Top-``k`` ids by decayed count (``rank_by_score`` tie-break)."""
        return rank_by_score(self.counts, k)

    def is_hot(self, ids, k: int) -> np.ndarray:
        """Boolean mask: is each id in the current top-``k`` set?"""
        return np.isin(np.asarray(ids).ravel(), self.topk(k))


class FrequencyScorer(HotSetScorer):
    """Dynamic: hotness = a ``FrequencyTracker``'s decayed counts.  The
    tracker is made at the first ``scores(graph)`` call unless one is
    passed in; with no observations every score is 0 and ``top_ids``
    falls back to id order."""

    name = "frequency"

    def __init__(self, tracker: FrequencyTracker | None = None, *,
                 decay: float = 1.0):
        self.tracker = tracker
        self._decay = float(decay)

    def observe(self, ids) -> None:
        if self.tracker is None:
            raise ValueError(
                "frequency scorer has no tracker yet: call scores() or "
                "top_ids() once, or pass FrequencyTracker(num_nodes)")
        self.tracker.observe(ids)

    def scores(self, graph) -> np.ndarray:
        if self.tracker is None:
            self.tracker = FrequencyTracker(graph.num_nodes,
                                            decay=self._decay)
        if self.tracker.num_nodes != graph.num_nodes:
            raise ValueError(
                f"frequency scorer's tracker covers "
                f"{self.tracker.num_nodes} nodes, graph has "
                f"{graph.num_nodes}")
        return self.tracker.counts


class BlendScorer(HotSetScorer):
    """``w * degree + (1 - w) * frequency``, each divided by its max.  With
    no observations the frequency term is 0, so ``blend(w > 0)`` starts at
    the degree ranking."""

    name = "blend"

    def __init__(self, weight: float = 0.5, *extra,
                 tracker: FrequencyTracker | None = None,
                 decay: float = 1.0):
        if extra:
            raise ValueError(f"blend takes at most one parameter (the "
                             f"degree weight), got {(weight,) + extra}")
        weight = float(weight)
        if not 0.0 <= weight <= 1.0:
            raise ValueError(f"blend weight must be in [0, 1], got {weight}")
        self.weight = weight
        self.degree = DegreeScorer()
        self.frequency = FrequencyScorer(tracker, decay=decay)

    def observe(self, ids) -> None:
        self.frequency.observe(ids)

    def scores(self, graph) -> np.ndarray:
        d = self.degree.scores(graph).astype(np.float64)
        f = np.asarray(self.frequency.scores(graph), np.float64)
        if d.size and d.max() > 0:
            d = d / d.max()
        if f.size and f.max() > 0:
            f = f / f.max()
        return self.weight * d + (1.0 - self.weight) * f


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


def _frequency_factory(*params):
    if len(params) > 1:
        raise ValueError(f"scorer 'frequency' takes at most one parameter "
                         f"(the decay), got {params}")
    return FrequencyScorer(decay=params[0] if params else 1.0)


register_hot_scorer("degree", _degree_factory)
register_hot_scorer("frequency", _frequency_factory)
register_hot_scorer("blend", lambda *p: BlendScorer(*p))


def degree_hot_ids(graph, k: int | None = None) -> np.ndarray:
    """Deprecated alias of the ``"degree"`` hot-set scorer: prefer
    ``resolve_hot_scorer("degree").top_ids(graph, k)`` (the same
    ranking)."""
    warnings.warn(
        "repro_torch.core.cache.degree_hot_ids is deprecated; use "
        "resolve_hot_scorer('degree').top_ids(graph, k) from the hot-set "
        "scorer registry",
        DeprecationWarning, stacklevel=2)
    return resolve_hot_scorer("degree").top_ids(graph, k)


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


def frequency_caches(layout, capacity: int, *, fanouts,
                     trace_steps: int = 4, trace_batch: int = 64,
                     seed: int = 0, **_ignored) -> FeatureCache:
    """Per worker, cache the remote nodes it fetched most often over
    ``trace_steps`` steps of the seed stream (``seeds_per_worker`` with
    salt ``seed + s``) sampled by the ``reference`` backend, as ``repro``
    traces them, so the cached ids are bit-identical to ``repro``'s.
    Only accessed nodes are cached; ties go to the lower id."""
    from repro_torch.core.partition import seeds_per_worker
    from repro_torch.core.sampler import sample_mfgs

    if fanouts is None:
        raise ValueError("frequency cache policy needs the sampler fanouts "
                         "(pass fanouts=... or use the pipeline API)")
    offsets, _ = layout.host_offsets_labels()
    P = layout.num_parts
    n = layout.graph.num_nodes
    counts = np.zeros((P, n), np.int64)
    for s in range(trace_steps):
        salt = (seed + s) % (2 ** 32)
        seeds = seeds_per_worker(layout, trace_batch, epoch_salt=salt)
        src = sample_mfgs(layout.graph, seeds, fanouts,
                          salt)[-1].src_nodes.cpu().numpy()
        for p in range(P):
            np.add.at(counts[p], src[p][src[p] >= 0], 1)

    owner = np.searchsorted(offsets, np.arange(n), side="right") - 1
    picks = []
    for p in range(P):
        c = counts[p].copy()
        c[owner == p] = 0                       # local rows are free anyway
        ranked = rank_by_score(c)
        picks.append(ranked[c[ranked] > 0][:capacity])
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
register_cache_policy("frequency", frequency_caches)


# --------------------------------------------------------------------------
# the seed API's cached train step (deprecated names; see the pipeline)
# --------------------------------------------------------------------------

def build_degree_caches(layout, capacity: int) -> FeatureCache:
    """Deprecated alias of ``degree_caches``: prefer the pipeline API
    (``repro_torch.pipeline.PlanSpec(cache_capacity=...)``)."""
    warnings.warn(
        "repro_torch.core.cache.build_degree_caches is deprecated; use "
        "repro_torch.pipeline.PlanSpec(cache_capacity=...) with "
        "Pipeline.build, or repro_torch.core.cache.degree_caches",
        DeprecationWarning, stacklevel=2)
    return degree_caches(layout, capacity)


def make_cached_worker_step(*, graph_replicated, offsets, num_parts,
                            fanouts, loss_fn, level_fn=None,
                            counter: dist.RoundCounter | None = None):
    """The hybrid train step with the feature cache in the fetch (the
    exchange store's ``fetch_features_cached``).

    ``step(params, shards, seeds, salt, cache) -> (loss, grads, hit_rate
    (P,))``: the loss and gradients are the uncached step's program,
    reduced in worker order, so they equal its bit for bit (the cache's
    rows are the owners'); ``hit_rate`` is each worker's share of valid
    frontier ids served from its cache.
    """
    from repro_torch.core.sampler import sample_level
    from repro_torch.pipeline.prefetch import make_prepare_consume

    prepare, consume = make_prepare_consume(
        offsets=offsets, num_parts=num_parts, fanouts=fanouts,
        loss_fn=loss_fn, scheme="hybrid", graph_replicated=graph_replicated,
        level_fn=level_fn or sample_level, counter=counter)

    def step(params, shards: dist.WorkerShard, seeds, salt,
             cache: FeatureCache):
        batch = prepare(shards, seeds, salt, cache)
        loss, grads, _metrics = consume(params, batch)
        valid = (batch.mfgs[-1].src_nodes >= 0).sum(dim=-1).clamp(min=1)
        return loss, grads, (batch.hits / valid).to(torch.float32)

    return step


def run_stacked_cached(step, params, shards, seeds, salt,
                       cache: FeatureCache):
    """Run the cached step over all P stacked workers (cf.
    ``dist.run_stacked``): the mean loss and gradients, and the hit rate
    averaged over the workers."""
    loss, grads, hit_rate = step(params, shards, seeds, salt, cache)
    return loss, grads, torch.mean(hit_rate)
