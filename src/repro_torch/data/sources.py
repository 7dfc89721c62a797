"""``GraphSource`` registry: parameterized synthetic graph families
(counterpart of ``repro.data.sources``).

  ``"uniform"``            endpoints uniform at random — the no-skew
                           baseline.
  ``"powerlaw(alpha)"``    Chung-Lu: node weights ~ Pareto(alpha) + 1, so
                           smaller ``alpha`` means heavier hubs.
  ``"rmat(a,b,c,d)"``      R-MAT recursive quadrant splits (Graph500 uses
                           a=0.57, b=c=0.19, d=0.05): skew on both
                           endpoints.
  ``"sbm(k,p_in,p_out)"``  k-block stochastic block model; ``p_in/p_out``
                           sets the intra- vs inter-block odds (density
                           from ``avg_degree``); blocks carry the labels.

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


class RMATSource(GraphSource):
    """R-MAT / Kronecker: each of ceil(log2 n) bit levels picks a quadrant
    with probabilities (a, b, c, d); ids land on [0, n) by a modulo fold,
    which keeps the low-bit skew (exact when n is a power of two)."""

    name = "rmat"

    def __init__(self, a: float = 0.57, b: float = 0.19, c: float = 0.19,
                 d: float = 0.05):
        probs = np.array([a, b, c, d], float)
        if (probs < 0).any() or not np.isclose(probs.sum(), 1.0, atol=1e-6):
            raise ValueError(
                f"rmat(a,b,c,d) must be non-negative and sum to 1, got "
                f"{tuple(probs)}")
        self.probs = probs / probs.sum()

    def describe(self) -> str:
        a, b, c, d = self.probs
        return f"rmat({a:g},{b:g},{c:g},{d:g})"

    def edges(self, rng, n, m, labels_all, num_classes):
        scale = max(int(np.ceil(np.log2(n))), 1)
        dst = np.zeros(m, np.int64)
        src = np.zeros(m, np.int64)
        for level in range(scale):
            quad = rng.choice(4, size=m, p=self.probs)
            dst |= ((quad >> 1) & 1).astype(np.int64) << level
            src |= (quad & 1).astype(np.int64) << level
        return dst % n, src % n


class SBMSource(GraphSource):
    """k-block stochastic block model.  ``p_in``/``p_out`` set the intra-
    vs inter-block odds per source node (density comes from
    ``avg_degree``, so families compare at equal nnz); labels are the
    blocks (block % num_classes): homophilous structure."""

    name = "sbm"

    def __init__(self, k: float = 4, p_in: float = 0.9, p_out: float = 0.1):
        self.k = int(k)
        if self.k < 1:
            raise ValueError(f"sbm needs k >= 1 blocks, got {k}")
        if p_in < 0 or p_out < 0 or p_in + p_out <= 0:
            raise ValueError(
                f"sbm p_in/p_out must be non-negative and not both zero, "
                f"got ({p_in}, {p_out})")
        self.p_in, self.p_out = float(p_in), float(p_out)

    def describe(self) -> str:
        return f"sbm({self.k},{self.p_in:g},{self.p_out:g})"

    def edges(self, rng, n, m, labels_all, num_classes):
        k = min(self.k, n)
        block = rng.integers(0, k, n)
        order = np.argsort(block, kind="stable")
        starts = np.searchsorted(block[order], np.arange(k + 1))
        sizes = np.diff(starts)

        src = rng.integers(0, n, m)
        b = block[src]
        # per-edge intra-block probability from the (p_in, p_out) odds,
        # weighted by the targets in and out of the source's block
        w_in = self.p_in * np.maximum(sizes[b] - 1, 0)
        w_out = self.p_out * (n - sizes[b])
        total = w_in + w_out
        intra = rng.random(m) * np.maximum(total, 1e-12) < w_in
        # intra: uniform within src's block; inter: uniform anywhere
        off = (rng.random(m) * np.maximum(sizes[b], 1)).astype(np.int64)
        dst_in = order[starts[b] + np.minimum(off, sizes[b] - 1)]
        dst_out = rng.integers(0, n, m)
        dst = np.where(intra, dst_in, dst_out)
        labels_all[:] = (block % num_classes).astype(np.int32)
        return dst.astype(np.int64), src.astype(np.int64)


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


def parse_source_name(name: str) -> tuple[str, tuple[float, ...]]:
    """Split an optionally parameterized source name:
    ``"rmat(0.57,0.19,0.19,0.05)"`` -> ``("rmat", (0.57, 0.19, 0.19,
    0.05))``."""
    return parse_param_name(name, kind="source")


def resolve_source(name: str) -> GraphSource:
    """Instantiate the source registered under ``name`` (which may carry
    inline parameters, e.g. ``"powerlaw(2.1)"``)."""
    base, params = parse_source_name(name)
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
register_source("rmat", lambda *a: RMATSource(*a))
register_source("sbm", lambda *a: SBMSource(*a))
