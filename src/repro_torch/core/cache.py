"""The hot-set scorer registry — the shared "who's hot" ranking.

Counterpart of the scorer half of ``repro.core.cache`` (``degree`` only so
far; the feature caches are not ported yet).  The serving traffic generator
and the arrival-rate calibration rank hot nodes through it.
"""
from __future__ import annotations

from typing import Callable

import numpy as np


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
