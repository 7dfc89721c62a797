"""Synthetic open-loop traffic for serving (counterpart of
``repro.serve.traffic``; numpy, the same draws in the same order).

Open loop: arrival times are a Poisson process at ``rate`` requests/s,
drawn independently of service times, so a slow server cannot slow the
workload down.

  * ``uniform`` — every node equally likely.
  * ``hotset``  — with probability ``hot_prob`` the seed comes from a small
    hot set (by default the top in-degree nodes through the shared
    ``repro_torch.core.cache`` scorer registry), else uniform.
"""
from __future__ import annotations

from typing import Callable

import numpy as np


def _arrival_times(num_requests: int, rate: float,
                   rng: np.random.Generator) -> np.ndarray:
    if num_requests < 1:
        raise ValueError(f"num_requests must be >= 1, got {num_requests}")
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    return np.cumsum(rng.exponential(1.0 / rate, size=num_requests))


def uniform_arrivals(num_requests: int, rate: float, num_nodes: int, *,
                     seed: int = 0, **_ignored):
    """Poisson arrivals, seeds uniform over all nodes: a time-sorted list
    of ``(arrival_time, node_id)``."""
    rng = np.random.default_rng(seed)
    times = _arrival_times(num_requests, rate, rng)
    nodes = rng.integers(0, num_nodes, size=num_requests)
    return [(float(t), int(v)) for t, v in zip(times, nodes)]


def hotset_arrivals(num_requests: int, rate: float, num_nodes: int, *,
                    seed: int = 0, hot_ids=None, graph=None,
                    hot_k: int = 64, hot_prob: float = 0.9, **_ignored):
    """Poisson arrivals, seeds skewed toward a hot set (``hot_ids``, or the
    top ``hot_k`` of ``graph`` by in-degree)."""
    if not 0.0 <= hot_prob <= 1.0:
        raise ValueError(f"hot_prob must be in [0, 1], got {hot_prob}")
    if hot_ids is None:
        if graph is None:
            raise ValueError("hotset traffic needs hot_ids= or graph=")
        from repro_torch.core.cache import resolve_hot_scorer
        hot_ids = resolve_hot_scorer("degree").top_ids(graph, hot_k)
    hot_ids = np.asarray(hot_ids).ravel()
    rng = np.random.default_rng(seed)
    times = _arrival_times(num_requests, rate, rng)
    is_hot = rng.random(num_requests) < hot_prob
    hot = hot_ids[rng.integers(0, hot_ids.size, size=num_requests)]
    cold = rng.integers(0, num_nodes, size=num_requests)
    nodes = np.where(is_hot, hot, cold)
    return [(float(t), int(v)) for t, v in zip(times, nodes)]


_ARRIVALS: dict[str, Callable] = {}


def register_arrival(name: str, gen: Callable, *,
                     overwrite: bool = False) -> None:
    """Register ``gen(num_requests, rate, num_nodes, *, seed, **kw)``."""
    if not overwrite and name in _ARRIVALS and _ARRIVALS[name] is not gen:
        raise ValueError(f"arrival generator {name!r} already registered; "
                         f"pass overwrite=True to replace it")
    _ARRIVALS[name] = gen


def available_arrivals() -> tuple[str, ...]:
    """Sorted names of registered arrival generators."""
    return tuple(sorted(_ARRIVALS))


def resolve_arrival(name: str) -> Callable:
    """Look up an arrival generator by registry name."""
    try:
        return _ARRIVALS[name]
    except KeyError:
        raise KeyError(f"unknown arrival pattern {name!r}; "
                       f"available: {available_arrivals()}") from None


register_arrival("uniform", uniform_arrivals)
register_arrival("hotset", hotset_arrivals)
