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
                    (``repro_torch.core.placement``): "hybrid".  Frontier
                    rows come from their owners by the two-round
                    all_to_all fetch (``repro``'s "exchange" store).
    partitioner:    partitioner registry name
                    (``repro_torch.core.partition``): "ldg".
    node_slack / labeled_slack: partitioner balance targets.
    """
    num_parts: int
    scheme: str = "hybrid"
    node_slack: float = 1.05
    labeled_slack: float | None = None
    partition_seed: int = 0
    partitioner: str = "ldg"

    def __post_init__(self):
        from repro_torch.core.partition import resolve_partitioner
        from repro_torch.core.placement import resolve_scheme

        try:
            resolve_scheme(self.scheme)
        except KeyError as e:
            raise ValueError(str(e)) from None
        if self.num_parts < 1:
            raise ValueError(f"num_parts must be >= 1, got {self.num_parts}")
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
                    partition_seed: int = 0, partitioner: str = "ldg",
                    data: DataSpec | None = None) -> "PipelineSpec":
        """``hybrid`` -> scheme hybrid, backend ``"unfused"``;
        ``hybrid+fused`` -> scheme hybrid, backend ``"fused_cuda"``."""
        if scheme not in LEGACY_SCHEMES:
            raise ValueError(f"unknown scheme {scheme!r}; "
                             f"valid: {LEGACY_SCHEMES}")
        backend = "fused_cuda" if scheme == "hybrid+fused" else "unfused"
        return cls(
            plan=PlanSpec(num_parts=num_parts, scheme="hybrid",
                          partition_seed=partition_seed,
                          partitioner=partitioner),
            sampler=SamplerSpec(fanouts=tuple(fanouts), backend=backend),
            data=data)
