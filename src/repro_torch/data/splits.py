"""Deterministic labeled-node split policies (counterpart of
``repro.data.splits``).

A split policy maps ``(graph, full labels, seed) -> labels with -1 where
unlabeled``.  Both are pure hashes of (node id, seed) — SplitMix64 — so a
split is reproducible from its name alone and bit-identical to
``repro``'s:

  ``"random(frac)"``             each node labeled independently with
                                 probability ``frac``.
  ``"degree_stratified(frac)"``  the hash-lowest ``frac`` within each
                                 in-degree decile, so the labeled set
                                 spans the degree spectrum.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from repro_torch.core.graph import mix64
from repro_torch.data.naming import parse_param_name

_SPLITS: dict[str, Callable[..., "SplitPolicy"]] = {}


def _node_hash_unit(n: int, seed: int) -> np.ndarray:
    """(n,) floats in [0, 1): a pure hash of (node id, seed)."""
    salt = np.uint64((int(seed) * 0x9E3779B97F4A7C15 + 0x5851F42D) % 2**64)
    key = mix64(np.arange(n, dtype=np.uint64) + salt)
    return key.astype(np.float64) / float(2**64)


class SplitPolicy:
    """Base: ``labeled_mask(graph, seed) -> (n,) bool``."""

    name: str = "?"

    def labeled_mask(self, graph, seed: int) -> np.ndarray:
        raise NotImplementedError


class RandomSplit(SplitPolicy):
    name = "random"

    def __init__(self, frac: float = 0.3):
        frac = float(frac)
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"split fraction must be in (0, 1], got {frac}")
        self.frac = frac

    def labeled_mask(self, graph, seed: int) -> np.ndarray:
        return _node_hash_unit(graph.num_nodes, seed) < self.frac


class DegreeStratifiedSplit(SplitPolicy):
    """Label the hash-lowest ``frac`` of nodes within each in-degree
    bucket (equal-population buckets, 10 by default)."""

    name = "degree_stratified"

    def __init__(self, frac: float = 0.3, buckets: float = 10):
        frac = float(frac)
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"split fraction must be in (0, 1], got {frac}")
        self.frac = frac
        self.buckets = max(int(buckets), 1)

    def labeled_mask(self, graph, seed: int) -> np.ndarray:
        n = graph.num_nodes
        deg = np.diff(graph.numpy()[0])
        u = _node_hash_unit(n, seed)
        # rank nodes by degree (hash tie-break), cut into equal-population
        # buckets, take frac per bucket by hash
        order = np.lexsort((u, deg))
        bucket = np.empty(n, np.int64)
        bucket[order] = (np.arange(n) * self.buckets) // max(n, 1)
        mask = np.zeros(n, bool)
        for b in range(self.buckets):
            ids = np.flatnonzero(bucket == b)
            if not ids.size:
                continue
            take = int(round(self.frac * ids.size))
            take = min(max(take, 1), ids.size)
            mask[ids[np.argsort(u[ids], kind="stable")[:take]]] = True
        return mask


def register_split(name: str, factory: Callable[..., SplitPolicy], *,
                   overwrite: bool = False) -> None:
    """Register a split-policy factory (``factory(*params)``)."""
    if not overwrite and name in _SPLITS and _SPLITS[name] is not factory:
        raise ValueError(f"split policy {name!r} already registered; "
                         f"pass overwrite=True to replace it")
    _SPLITS[name] = factory


def available_splits() -> tuple[str, ...]:
    """Sorted names of registered split policies."""
    return tuple(sorted(_SPLITS))


def resolve_split(name: str) -> SplitPolicy:
    """Instantiate ``name`` (inline parameters allowed:
    ``"random(0.1)"``, ``"degree_stratified(0.2,5)"``)."""
    base, params = parse_param_name(name, kind="split")
    try:
        factory = _SPLITS[base]
    except KeyError:
        raise KeyError(f"unknown split policy {name!r}; "
                       f"available: {available_splits()}") from None
    return factory(*params)


def apply_split(name: str, graph, labels_all: np.ndarray,
                seed: int = 0) -> np.ndarray:
    """Copy of ``labels_all`` with -1 where the policy leaves a node
    unlabeled."""
    mask = resolve_split(name).labeled_mask(graph, seed)
    labels = np.asarray(labels_all, np.int32).copy()
    labels[~mask] = -1
    return labels


register_split("random", lambda *a: RandomSplit(*a))
register_split("degree_stratified", lambda *a: DegreeStratifiedSplit(*a))
