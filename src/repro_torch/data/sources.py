"""``GraphSource`` registry: parameterized synthetic graph families
(counterpart of ``repro.data.sources``; ``uniform`` and ``powerlaw`` so
far).

  ``"uniform"``          endpoints uniform at random — the no-skew baseline.
  ``"powerlaw(alpha)"``  Chung-Lu: node weights ~ Pareto(alpha) + 1, so
                         smaller ``alpha`` means heavier hubs.

Generation uses one ``np.random.default_rng(seed)`` and the same draws in
the same order as ``repro``, so the same ``(name, DataSpec)`` gives a
dataset bit-identical to ``repro``'s.  The graph lies on the CPU; a
pipeline moves what it needs to its device.
"""
from __future__ import annotations

import inspect
from typing import Callable

import numpy as np

from repro_torch.core.graph import csc_from_numpy_edges
from repro_torch.data.naming import parse_param_name
from repro_torch.data.splits import apply_split
from repro_torch.data.synthetic_graph import GraphDataset


class GraphSource:
    """A named, parameterized generator of ``GraphDataset``s.

    Subclasses implement ``edges(rng, n, m, labels_all, num_classes) ->
    (dst, src)`` and inherit the shared assembly: self-loop removal, CSC
    construction, class-conditioned Gaussian features, and the split
    policy deciding which labels survive.
    """

    name: str = "?"

    def edges(self, rng: np.random.Generator, n: int, m: int,
              labels_all: np.ndarray, num_classes: int
              ) -> tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def describe(self) -> str:
        """Canonical parameterized name (used in dataset names)."""
        return self.name

    def generate(self, num_nodes: int, avg_degree: int, *,
                 num_features: int = 16, num_classes: int = 8,
                 split: str = "random(0.3)", seed: int = 0) -> GraphDataset:
        """Deterministically build the dataset: one rng, one pass."""
        if num_nodes < 2:
            raise ValueError(f"num_nodes must be >= 2, got {num_nodes}")
        rng = np.random.default_rng(seed)
        n, m = int(num_nodes), int(num_nodes) * int(avg_degree)
        labels_all = rng.integers(0, num_classes, n).astype(np.int32)
        dst, src = self.edges(rng, n, m, labels_all, num_classes)
        keep = dst != src                       # drop self-loops
        dst, src = dst[keep].astype(np.int64), src[keep].astype(np.int64)
        graph = csc_from_numpy_edges(dst, src, n)

        centers = rng.normal(0, 1, (num_classes, num_features)
                             ).astype(np.float32)
        feats = (centers[labels_all]
                 + rng.normal(0, 1.5, (n, num_features)).astype(np.float32))

        labels = apply_split(split, graph, labels_all, seed=seed)
        return GraphDataset(graph=graph, features=feats, labels=labels,
                            num_classes=num_classes,
                            name=f"{self.describe()}-n{n}")


class UniformSource(GraphSource):
    """Endpoints uniform at random — the degree-flat baseline."""

    name = "uniform"

    def edges(self, rng, n, m, labels_all, num_classes):
        return rng.integers(0, n, m), rng.integers(0, n, m)


class PowerlawSource(GraphSource):
    """Chung-Lu: endpoint probability proportional to Pareto(alpha)+1 node
    weights — hub-heavy in- and out-degree."""

    name = "powerlaw"

    def __init__(self, alpha: float = 1.8):
        alpha = float(alpha)
        if alpha <= 0.0:
            raise ValueError(f"powerlaw alpha must be > 0, got {alpha}")
        self.alpha = alpha

    def describe(self) -> str:
        return f"powerlaw({self.alpha:g})"

    def edges(self, rng, n, m, labels_all, num_classes):
        w = rng.pareto(self.alpha, n) + 1.0
        p = w / w.sum()
        return rng.choice(n, size=m, p=p), rng.choice(n, size=m, p=p)


_SOURCES: dict[str, Callable[..., GraphSource]] = {}


def register_source(name: str, factory: Callable[..., GraphSource], *,
                    overwrite: bool = False) -> None:
    """Register ``factory(*params) -> GraphSource`` under ``name``."""
    if not overwrite and name in _SOURCES and _SOURCES[name] is not factory:
        raise ValueError(f"graph source {name!r} already registered; "
                         f"pass overwrite=True to replace it")
    _SOURCES[name] = factory


def available_sources() -> tuple[str, ...]:
    """Sorted names of registered graph sources."""
    return tuple(sorted(_SOURCES))


def resolve_source(name: str) -> GraphSource:
    """Instantiate the source registered under ``name`` (which may carry
    inline parameters, e.g. ``"powerlaw(2.1)"``)."""
    base, params = parse_param_name(name, kind="source")
    try:
        factory = _SOURCES[base]
    except KeyError:
        raise KeyError(f"unknown graph source {name!r}; "
                       f"available: {available_sources()}") from None
    try:
        inspect.signature(factory).bind(*params)
    except TypeError:
        raise ValueError(
            f"source {base!r} does not accept parameters {params}") from None
    return factory(*params)


register_source("uniform", lambda: UniformSource())
register_source("powerlaw", lambda *a: PowerlawSource(*a))
