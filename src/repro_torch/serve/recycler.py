"""LazyGNN-style recycling cache: reuse recent results for hot seeds
(counterpart of ``repro.serve.recycler``; pure Python and numpy).

The recycler keeps the final logits of recently served seeds and answers
repeated requests from them, without sampling, under a staleness contract:

  * ``tau`` — an entry may be served only if it was computed at most
    ``tau`` fresh serve steps (batch flushes) ago;
  * ``rho`` — at most a ``rho`` fraction of all answered requests may come
    from the cache (``rho=0`` serves nothing recycled, ``rho=1`` sets no
    budget).

Admission is pluggable: every computed seed by default (LRU eviction at
capacity), or a fixed hot set (``hot_set_admit``) from a
``repro_torch.core.cache`` hot-set scorer.  With fixed params and the
predictor's fixed salt a hit equals recomputation bit for bit.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable

import numpy as np


class RecyclingCache:
    """Seed id -> (logits, stamp) store with staleness bounds.

    capacity: most entries (LRU eviction); tau: largest entry age in fresh
    serve steps; rho: largest fraction of answered requests served from
    the cache; admit: optional filter on seed ids (None admits all).
    """

    def __init__(self, *, capacity: int = 1024, tau: int = 64,
                 rho: float = 1.0,
                 admit: Callable[[int], bool] | None = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if tau < 0:
            raise ValueError(f"tau must be >= 0, got {tau}")
        if not 0.0 <= rho <= 1.0:
            raise ValueError(f"rho must be in [0, 1], got {rho}")
        self.capacity = int(capacity)
        self.tau = int(tau)
        self.rho = float(rho)
        self.admit = admit
        self._entries: OrderedDict[int, tuple[np.ndarray, int]] = \
            OrderedDict()
        self.hits = 0
        self.misses = 0
        self.expired = 0
        self.evictions = 0
        self.rho_deferrals = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, seed: int) -> bool:
        return int(seed) in self._entries

    @property
    def answered(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.answered if self.answered else 0.0

    def lookup(self, seed: int, step: int) -> np.ndarray | None:
        """Recycled logits for ``seed`` at serve step ``step``, or None.
        Every call counts as one answered request (hit or miss)."""
        seed = int(seed)
        entry = self._entries.get(seed)
        if entry is not None and step - entry[1] > self.tau:
            del self._entries[seed]         # too old: never served again
            self.expired += 1
            entry = None
        if entry is not None and \
                (self.hits + 1) > self.rho * (self.answered + 1):
            self.rho_deferrals += 1         # over the stale budget now
            entry = None
        if entry is None:
            self.misses += 1
            return None
        self.hits += 1
        self._entries.move_to_end(seed)
        return entry[0]

    def insert(self, seed: int, logits, step: int) -> None:
        """Admit (or refresh) a freshly computed seed's logits."""
        seed = int(seed)
        if self.admit is not None and not self.admit(seed):
            return
        if seed not in self._entries and \
                len(self._entries) >= self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1
        self._entries[seed] = (np.asarray(logits), int(step))
        self._entries.move_to_end(seed)

    def stats(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hit_rate,
            "expired": self.expired,
            "evictions": self.evictions,
            "rho_deferrals": self.rho_deferrals,
            "entries": len(self._entries),
            "capacity": self.capacity,
            "tau": self.tau,
            "rho": self.rho,
        }


def hot_set_admit(hot_ids) -> Callable[[int], bool]:
    """Admission filter keeping only a fixed hot set (e.g.
    ``resolve_hot_scorer("degree").top_ids(graph, k)``)."""
    hot = set(int(i) for i in np.asarray(hot_ids).ravel())
    return lambda seed: int(seed) in hot
