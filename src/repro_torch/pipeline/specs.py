"""Declarative configuration for the ``repro_torch.pipeline`` API
(counterpart of ``repro.pipeline.specs``).

  * ``PlanSpec``     — partitioning & placement;
  * ``SamplerSpec``  — fanouts + level-backend name (registry lookup);
  * ``DataSpec``     — which graph (``repro_torch.data.spec``);
  * ``PipelineSpec`` — all of the above.

``PipelineSpec.from_scheme`` parses the ``"hybrid" | "hybrid+fused"``
strings: ``hybrid+fused`` is the hybrid placement with the fused sampling
kernel (level backend ``"fused_cuda"``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.data.spec import DataSpec

LEGACY_SCHEMES = ("hybrid", "hybrid+fused")


@dataclasses.dataclass(frozen=True)
class PlanSpec:
    """Partitioning & placement plan (paper §3.3).

    scheme:         placement-scheme registry name
                    (``repro_torch.core.placement``): "hybrid".
    cache_capacity: per-worker hot-remote-feature cache entries; 0 = off.
    cache_policy:   cache-construction registry name
                    (``repro_torch.core.cache``): "degree".
    feature_store:  feature-store registry name
                    (``repro_torch.core.feature_store``): "exchange" (the
                    two-round all_to_all fetch, the default) or
                    "pinned_hot" (the cache's hot rows pinned in device
                    memory, served by the ``gather_rows`` kernel; needs
                    ``cache_capacity > 0``).  Every store serves
                    bit-identical rows.
    partitioner:    partitioner registry name
                    (``repro_torch.core.partition``): "ldg".
    node_slack / labeled_slack: partitioner balance targets.
    """
    num_parts: int
    scheme: str = "hybrid"
    cache_capacity: int = 0
    node_slack: float = 1.05
    labeled_slack: float | None = None
    partition_seed: int = 0
    cache_policy: str = "degree"
    feature_store: str = "exchange"
    partitioner: str = "ldg"

    def __post_init__(self):
        from repro_torch.core.cache import available_cache_policies
        from repro_torch.core.feature_store import (available_feature_stores,
                                                    resolve_feature_store)
        from repro_torch.core.partition import resolve_partitioner
        from repro_torch.core.placement import resolve_scheme

        try:
            resolve_scheme(self.scheme)
        except KeyError as e:
            raise ValueError(str(e)) from None
        if self.num_parts < 1:
            raise ValueError(f"num_parts must be >= 1, got {self.num_parts}")
        if self.cache_capacity < 0:
            raise ValueError("cache_capacity must be >= 0")
        if self.cache_policy not in available_cache_policies():
            raise ValueError(
                f"unknown cache policy {self.cache_policy!r}; valid: "
                f"{available_cache_policies()}")
        if self.feature_store not in available_feature_stores():
            raise ValueError(
                f"unknown feature store {self.feature_store!r}; valid: "
                f"{available_feature_stores()}")
        if resolve_feature_store(self.feature_store).needs_cache \
                and self.cache_capacity == 0:
            raise ValueError(
                f"feature store {self.feature_store!r} serves hits from "
                f"the pinned device cache; set cache_capacity > 0 (and a "
                f"cache_policy) or use the 'exchange' store")
        resolve_partitioner(self.partitioner)


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    """Layered-sampling config: fanouts (top level first) + level-backend
    registry name ("reference", "unfused", "fused_cuda")."""
    fanouts: tuple[int, ...]
    backend: str = "reference"

    def __post_init__(self):
        fanouts = tuple(int(f) for f in self.fanouts)
        if not fanouts or any(f < 1 for f in fanouts):
            raise ValueError(f"fanouts must be positive ints, got {fanouts}")
        object.__setattr__(self, "fanouts", fanouts)

    @property
    def num_layers(self) -> int:
        return len(self.fanouts)


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """Everything ``Pipeline.build`` needs: plan + sampler (+ an optional
    data source for ``Pipeline.build_from_source``)."""
    plan: PlanSpec
    sampler: SamplerSpec
    data: DataSpec | None = None

    @property
    def expected_rounds(self) -> int:
        """all_to_all rounds per step (hybrid: 2, features only)."""
        from repro_torch.core.placement import resolve_scheme
        scheme = resolve_scheme(self.plan.scheme)
        return scheme.trace_sampling_rounds(self.sampler.num_layers) + 2

    @classmethod
    def from_scheme(cls, scheme: str, *, num_parts: int, fanouts,
                    cache_capacity: int = 0, partition_seed: int = 0,
                    partitioner: str = "ldg", cache_policy: str = "degree",
                    feature_store: str = "exchange",
                    data: DataSpec | None = None) -> "PipelineSpec":
        """``hybrid`` -> scheme hybrid, backend ``"unfused"``;
        ``hybrid+fused`` -> scheme hybrid, backend ``"fused_cuda"``; the
        cache and feature-store arguments go to ``PlanSpec``."""
        if scheme not in LEGACY_SCHEMES:
            raise ValueError(f"unknown scheme {scheme!r}; "
                             f"valid: {LEGACY_SCHEMES}")
        backend = "fused_cuda" if scheme == "hybrid+fused" else "unfused"
        return cls(
            plan=PlanSpec(num_parts=num_parts, scheme="hybrid",
                          cache_capacity=cache_capacity,
                          cache_policy=cache_policy,
                          partition_seed=partition_seed,
                          partitioner=partitioner,
                          feature_store=feature_store),
            sampler=SamplerSpec(fanouts=tuple(fanouts), backend=backend),
            data=data)
