"""Request queue + dynamic microbatcher with bucketed batch shapes
(a copy of ``repro.serve.batcher``, which is numpy only).

Online serving traffic arrives one seed at a time; the sampler/forward
programs want batches.  The ``MicroBatcher`` sits between: requests queue
up and are flushed either when the queue is full (size trigger) or when
the oldest request has waited ``max_delay`` seconds (deadline trigger).

Flushed batches are padded to one of a SMALL FIXED SET of bucketed batch
shapes (``BucketSpec``) rather than to their exact size, which bounds the
number of distinct shapes the device programs see.

``route_by_owner`` turns a flat seed list into the (P, capacity) stacked
array the distributed step programs consume: every placement scheme
assumes each worker's seed row is OWNED by that worker (the vanilla
scheme samples strictly from the local partition), so serving must route
each request to its seed's owning worker's row.  The returned positions
map each request to its (row, col) slot so logits scatter back.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    """One inference request: a seed node id plus its arrival time."""
    seed: int
    arrival: float
    uid: int = dataclasses.field(
        default_factory=itertools.count().__next__)


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """The fixed set of per-worker batch capacities the step may see.

    ``bucket_for(n)`` rounds a batch size up to the smallest bucket that
    fits — so a steady-state server runs at most ``len(sizes)`` batch
    shapes, independent of the traffic's size mix.
    """
    sizes: tuple[int, ...]

    def __init__(self, sizes: Sequence[int]):
        sizes = tuple(sorted(set(int(s) for s in sizes)))
        if not sizes or sizes[0] < 1:
            raise ValueError(f"bucket sizes must be >= 1, got {sizes!r}")
        object.__setattr__(self, "sizes", sizes)

    @property
    def max_size(self) -> int:
        return self.sizes[-1]

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n (n must not exceed ``max_size``)."""
        if n < 1:
            raise ValueError(f"batch size must be >= 1, got {n}")
        for s in self.sizes:
            if s >= n:
                return s
        raise ValueError(f"batch of {n} exceeds largest bucket "
                         f"{self.max_size} (sizes={self.sizes!r})")


def route_by_owner(offsets, seeds, capacity: int):
    """Pack a flat seed list into the stacked (P, capacity) layout.

    Parameters
    ----------
    offsets : array (P + 1,)
        Partition boundaries (``layout.offsets``); seeds are in the
        layout's contiguously-owned id space.
    seeds : array (N,)
        Seed node ids.
    capacity : int
        Row width (the bucket size); rows are -1 padded.

    Returns
    -------
    (routed, positions)
        ``routed`` (P, capacity) int32 with row p holding worker p's
        seeds; ``positions`` (N, 2) int32 mapping request i to its
        (row, col) so per-seed outputs scatter back in request order.

    Raises
    ------
    ValueError
        If any worker receives more than ``capacity`` seeds — callers
        size the bucket from the max per-owner count first.
    """
    offsets = np.asarray(offsets)
    seeds = np.asarray(seeds, dtype=np.int32).ravel()
    P = offsets.shape[0] - 1
    if seeds.size and (seeds.min() < 0 or seeds.max() >= offsets[-1]):
        raise ValueError("seed ids out of range for this layout")
    owner = (np.searchsorted(offsets, seeds, side="right") - 1).astype(
        np.int32)
    routed = np.full((P, capacity), -1, np.int32)
    positions = np.empty((seeds.size, 2), np.int32)
    fill = np.zeros(P, np.int64)
    for i in range(seeds.size):
        p = owner[i]
        c = fill[p]
        if c >= capacity:
            raise ValueError(
                f"worker {p} got more than capacity={capacity} seeds; "
                f"size the bucket from max_owner_count(...) first")
        routed[p, c] = seeds[i]
        positions[i] = (p, c)
        fill[p] = c + 1
    return routed, positions


def max_owner_count(offsets, seeds) -> int:
    """Largest number of seeds any single worker owns in ``seeds`` — the
    quantity bucket selection must cover."""
    offsets = np.asarray(offsets)
    seeds = np.asarray(seeds, dtype=np.int64).ravel()
    if seeds.size == 0:
        return 0
    owner = np.searchsorted(offsets, seeds, side="right") - 1
    return int(np.bincount(owner, minlength=offsets.shape[0] - 1).max())


class MicroBatcher:
    """Deadline- or size-triggered request accumulator.

    The batcher is PASSIVE (no threads): the serving loop owns the clock
    and asks ``due(now)`` / ``next_due()`` to decide when to ``flush()``.
    That keeps it usable both under a real clock and under the virtual
    clock the benchmark's open-loop simulation runs on.

    Flush triggers:
      * size — ``max_size`` requests pending fills the largest bucket
        (total count bounds the per-owner count, so one flush always fits
        one stacked batch);
      * deadline — the OLDEST pending request has waited ``max_delay``
        seconds (per-request worst-case added latency is ``max_delay``).

    ``max_delay=0`` degenerates to no batching: every request is due the
    moment it arrives (the benchmark's baseline arm).
    """

    def __init__(self, buckets: BucketSpec, *, max_delay: float = 2e-3):
        if max_delay < 0:
            raise ValueError(f"max_delay must be >= 0, got {max_delay}")
        self.buckets = buckets
        self.max_delay = float(max_delay)
        self._pending: list[Request] = []

    def __len__(self) -> int:
        return len(self._pending)

    def add(self, request: Request) -> None:
        self._pending.append(request)

    def next_due(self) -> float:
        """Time at which the deadline trigger fires (inf when empty)."""
        if not self._pending:
            return math.inf
        return self._pending[0].arrival + self.max_delay

    def due(self, now: float) -> bool:
        """Should the serving loop flush at time ``now``?"""
        if not self._pending:
            return False
        return (len(self._pending) >= self.buckets.max_size
                or now >= self.next_due())

    def flush(self) -> list[Request]:
        """Pop up to ``max_size`` pending requests, oldest first."""
        batch = self._pending[:self.buckets.max_size]
        self._pending = self._pending[self.buckets.max_size:]
        return batch
