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
  ``"staged"``      no feature exchange on the device: a ``FeatureStager``
                    (``repro_torch.pipeline.staging``) replays the sampler
                    on the host, gathers the frontier's rows there and
                    copies them to the card ahead of the step.  Needs
                    prefetch depth >= 1.

Every store returns rows bit-identical to ``dist.fetch_features``.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import dist
from repro_torch.kernels.gather import gather_rows


class FeatureStore:
    """How the workers serve their sampled frontier's feature rows.

    ``needs_cache``    the store serves hits from the pinned device cache,
                       so ``PlanSpec.cache_capacity > 0`` is required
                       (validated at spec construction).
    ``external_rows``  the rows come from a staging ring
                       (``staged_rows``), not from the device program.
    ``uses_exchange``  the store runs the feature all_to_all rounds.
    """

    name: str = "?"
    needs_cache: bool = False
    external_rows: bool = False
    uses_exchange: bool = True

    def fetch(self, src_nodes: torch.Tensor, shard, cache, *,
              offsets: torch.Tensor, num_parts: int, counter=None,
              staged_rows=None, group=None):
        """Serve ``src_nodes``'s rows -> ``(h (P, N, D), hits (P,))``.

        ``src_nodes`` is the last level's frontier (P, N) of global ids,
        -1 padded; ``cache`` is the stacked ``FeatureCache`` or ``None``;
        ``staged_rows`` (P, N, D) are the host-gathered rows of
        ``external_rows`` stores (ignored by the others).  In a fleet,
        ``group`` is the rank's ``dist.RankGroup`` and every stacked
        argument holds the rank's workers only.
        """
        raise NotImplementedError

    def utilized_bytes(self, src_nodes, hits, row_bytes):
        """Utilized feature-exchange volume per worker (P,): ids out +
        rows back for every valid frontier slot not served locally (0 for
        stores that run no exchange)."""
        if not self.uses_exchange:
            return torch.zeros(src_nodes.shape[0], dtype=torch.float32,
                               device=src_nodes.device)
        misses = ((src_nodes >= 0).sum(dim=-1) - hits).to(torch.float32)
        return misses * row_bytes


class ExchangeStore(FeatureStore):
    """The paper's two-round all_to_all fetch: exactly
    ``dist.fetch_features`` (or ``fetch_features_cached`` with a cache)."""

    name = "exchange"

    def fetch(self, src_nodes, shard, cache, *, offsets, num_parts,
              counter=None, staged_rows=None, group=None):
        if cache is not None:
            return dist.fetch_features_cached(
                src_nodes, offsets, num_parts, shard.features, cache,
                counter, group)
        h = dist.fetch_features(src_nodes, offsets, num_parts,
                                shard.features, counter, group)
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
              counter=None, staged_rows=None, group=None):
        if cache is None:
            raise ValueError(
                "pinned_hot feature store needs a built cache "
                "(PlanSpec.cache_capacity > 0)")
        is_hit, pos_c = dist.cache_lookup(cache, src_nodes)
        hit_pos = torch.where(is_hit, pos_c, -1).to(torch.int32)
        hit_rows = gather_rows(cache.rows, hit_pos)
        miss_ids = torch.where(is_hit, -1, src_nodes)
        h_miss = dist.fetch_features(miss_ids, offsets, num_parts,
                                     shard.features, counter, group)
        h = torch.where(is_hit[..., None], hit_rows.to(h_miss.dtype),
                        h_miss)
        return h, is_hit.sum(dim=-1)


class StagedStore(FeatureStore):
    """Rows gathered on the host and copied to the card ahead of the step.

    The device program runs no feature exchange (feature rounds per step:
    0).  ``fetch`` consumes the ``staged_rows`` a ``FeatureStager`` ring
    delivers.  With a cache, ``combine`` says where the hits come from:

      ``"device"``  hits are gathered from the pinned cache by the
                    ``gather_rows`` kernel and only the cold rows ride the
                    host-to-device copy (the stager zeroes hot slots);
      ``"host"``    the stager stages hot rows too and the cache is only
                    probed for the hit count;
      ``"auto"``    ``"device"`` for CUDA tensors, ``"host"`` on the CPU.

    Both combines give bit-identical rows (the cache holds copies of the
    same table).  Needs prefetch depth >= 1 (validated by
    ``PipelineSpec``).
    """

    name = "staged"
    external_rows = True
    uses_exchange = False

    def __init__(self, combine: str = "auto"):
        if combine not in ("auto", "device", "host"):
            raise ValueError(f"combine must be auto|device|host, "
                             f"got {combine!r}")
        self.combine = combine

    def hot_rows_from_cache(self, device) -> bool:
        """Whether cache hits come from the device cache (``True``) or
        ride the staged rows (``False``) on ``device``."""
        if self.combine != "auto":
            return self.combine == "device"
        return torch.device(device).type == "cuda"

    def fetch(self, src_nodes, shard, cache, *, offsets, num_parts,
              counter=None, staged_rows=None, group=None):
        if staged_rows is None:
            raise ValueError(
                "staged feature store needs staged_rows from a "
                "FeatureStager ring; drive it through a prefetch driver "
                "with depth >= 1 (PrefetchSpec(depth=1))")
        if cache is None:
            return staged_rows, torch.zeros(
                src_nodes.shape[0], dtype=torch.int64,
                device=src_nodes.device)
        is_hit, pos_c = dist.cache_lookup(cache, src_nodes)
        if not self.hot_rows_from_cache(staged_rows.device):
            return staged_rows, is_hit.sum(dim=-1)
        # the clamped slots are all in range, so the kernel's zero rows
        # never come up; the where keeps the staged row at every miss
        hit_rows = gather_rows(cache.rows, pos_c.to(torch.int32))
        h = torch.where(is_hit[..., None],
                        hit_rows.to(staged_rows.dtype), staged_rows)
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
register_feature_store("staged", StagedStore)
