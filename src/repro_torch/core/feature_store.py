"""Pluggable ``FeatureStore`` — how the workers obtain their frontier's
rows (counterpart of ``repro.core.feature_store``).

  ``"exchange"``    the paper's two-round all_to_all fetch
                    (``dist.fetch_features`` / ``fetch_features_cached``),
                    the default.
  ``"pinned_hot"``  the cache policy's hot rows stay pinned in device
                    memory across steps; hits are served by the
                    ``gather_rows`` kernel (``repro_torch.kernels.gather``)
                    and never ride the exchange.  Needs
                    ``cache_capacity > 0``.

Every store returns rows bit-identical to ``dist.fetch_features``.  The
``staged`` store (host-staged rows ahead of the step) is not ported yet.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import dist
from repro_torch.kernels.gather import gather_rows


class FeatureStore:
    """How the workers serve their sampled frontier's feature rows.

    ``needs_cache``  the store serves hits from the pinned device cache, so
                     ``PlanSpec.cache_capacity > 0`` is required
                     (validated at spec construction).
    """

    name: str = "?"
    needs_cache: bool = False

    def fetch(self, src_nodes: torch.Tensor, shard, cache, *,
              offsets: torch.Tensor, num_parts: int, counter=None):
        """Serve ``src_nodes``'s rows -> ``(h (P, N, D), hits (P,))``.

        ``src_nodes`` is the last level's frontier (P, N) of global ids,
        -1 padded; ``cache`` is the stacked ``FeatureCache`` or ``None``.
        """
        raise NotImplementedError

    def utilized_bytes(self, src_nodes, hits, row_bytes):
        """Utilized feature-exchange volume per worker (P,): ids out +
        rows back for every valid frontier slot not served locally."""
        misses = ((src_nodes >= 0).sum(dim=-1) - hits).to(torch.float32)
        return misses * row_bytes


class ExchangeStore(FeatureStore):
    """The paper's two-round all_to_all fetch: exactly
    ``dist.fetch_features`` (or ``fetch_features_cached`` with a cache)."""

    name = "exchange"

    def fetch(self, src_nodes, shard, cache, *, offsets, num_parts,
              counter=None):
        if cache is not None:
            return dist.fetch_features_cached(
                src_nodes, offsets, num_parts, shard.features, cache,
                counter)
        h = dist.fetch_features(src_nodes, offsets, num_parts,
                                shard.features, counter)
        return h, torch.zeros(src_nodes.shape[0], dtype=torch.int64,
                              device=src_nodes.device)


class PinnedHotStore(FeatureStore):
    """Hot rows pinned in device memory, served by ``gather_rows``.

    The cache policy's ``FeatureCache`` is the pinned state.  The hot-set
    probe is ``dist.cache_lookup`` (one batched searchsorted over each
    worker's sorted ids); hits gather from the pinned (P, K, D) table,
    misses ride the two exchange rounds.  Rows are bit-identical to
    ``fetch_features_cached``.
    """

    name = "pinned_hot"
    needs_cache = True

    def fetch(self, src_nodes, shard, cache, *, offsets, num_parts,
              counter=None):
        if cache is None:
            raise ValueError(
                "pinned_hot feature store needs a built cache "
                "(PlanSpec.cache_capacity > 0)")
        is_hit, pos_c = dist.cache_lookup(cache, src_nodes)
        hit_pos = torch.where(is_hit, pos_c, -1).to(torch.int32)
        hit_rows = gather_rows(cache.rows, hit_pos)
        miss_ids = torch.where(is_hit, -1, src_nodes)
        h_miss = dist.fetch_features(miss_ids, offsets, num_parts,
                                     shard.features, counter)
        h = torch.where(is_hit[..., None], hit_rows.to(h_miss.dtype),
                        h_miss)
        return h, is_hit.sum(dim=-1)


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

_FEATURE_STORES: dict[str, Callable[[], FeatureStore]] = {}


def register_feature_store(name: str, factory: Callable[[], FeatureStore],
                           *, overwrite: bool = False) -> None:
    """Register ``factory() -> FeatureStore`` under ``name``."""
    if not overwrite and name in _FEATURE_STORES \
            and _FEATURE_STORES[name] is not factory:
        raise ValueError(f"feature store {name!r} already registered")
    _FEATURE_STORES[name] = factory


def available_feature_stores() -> tuple[str, ...]:
    """Sorted names of registered feature stores."""
    return tuple(sorted(_FEATURE_STORES))


def resolve_feature_store(name: str) -> FeatureStore:
    """Instantiate the feature store registered under ``name``."""
    try:
        return _FEATURE_STORES[name]()
    except KeyError:
        raise KeyError(f"unknown feature store {name!r}; "
                       f"available: {available_feature_stores()}") from None


register_feature_store("exchange", ExchangeStore)
register_feature_store("pinned_hot", PinnedHotStore)
