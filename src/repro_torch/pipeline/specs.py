"""Declarative configuration for the ``repro_torch.pipeline`` API
(counterpart of ``repro.pipeline.specs``).

  * ``PlanSpec``     — partitioning & placement;
  * ``SamplerSpec``  — fanouts + level-backend name (registry lookup);
  * ``PrefetchSpec`` — prefetch depth, seed stream and host staging;
  * ``DataSpec``     — which graph (``repro_torch.data.spec``);
  * ``PipelineSpec`` — all of the above.

``PipelineSpec.from_scheme`` parses the ``"vanilla" | "hybrid" |
"hybrid+fused"`` strings and any registered scheme name (e.g.
``"hybrid_partial(0.25)"``): ``hybrid+fused`` is the hybrid placement with
the fused sampling kernel (level backend ``"fused_cuda"``), every other
name takes the unfused backend.
"""
from __future__ import annotations

import dataclasses

from repro_torch.data.spec import DataSpec

LEGACY_SCHEMES = ("vanilla", "hybrid", "hybrid+fused")
SEED_STREAMS = ("counter", "fold")


@dataclasses.dataclass(frozen=True)
class PlanSpec:
    """Partitioning & placement plan (paper §3.3).

    scheme:         placement-scheme registry name
                    (``repro_torch.core.placement``): "vanilla" |
                    "hybrid" | "hybrid_partial"; the inline form
                    "hybrid_partial(0.25)" sets ``replicate_frac``.
    cache_capacity: per-worker hot-remote-feature cache entries; 0 = off.
    cache_policy:   cache-construction registry name
                    (``repro_torch.core.cache``): "degree" | "frequency".
    feature_store:  feature-store registry name
                    (``repro_torch.core.feature_store``): "exchange" (the
                    two-round all_to_all fetch, the default) or
                    "pinned_hot" (the cache's hot rows pinned in device
                    memory, served by the ``gather_rows`` kernel; needs
                    ``cache_capacity > 0``) or "staged" (rows gathered on
                    the host and copied ahead of the step; needs prefetch
                    depth >= 1).  Every store serves bit-identical rows.
    partitioner:    partitioner registry name
                    (``repro_torch.core.partition``): "ldg".
    node_slack / labeled_slack: partitioner balance targets.
    replicate_frac: the replicated share of nodes of ``hybrid_partial``
                    (top by in-degree), in [0, 1]; None for the others.
    """
    num_parts: int
    scheme: str = "hybrid"
    cache_capacity: int = 0
    node_slack: float = 1.05
    labeled_slack: float | None = None
    partition_seed: int = 0
    cache_policy: str = "degree"
    replicate_frac: float | None = None
    feature_store: str = "exchange"
    partitioner: str = "ldg"

    def __post_init__(self):
        from repro_torch.core.cache import available_cache_policies
        from repro_torch.core.feature_store import (available_feature_stores,
                                                    resolve_feature_store)
        from repro_torch.core.partition import resolve_partitioner
        from repro_torch.core.placement import (available_schemes,
                                                parse_scheme_name,
                                                resolve_scheme)

        base, inline = parse_scheme_name(self.scheme)
        if inline is not None:
            if self.replicate_frac is not None \
                    and float(self.replicate_frac) != inline:
                raise ValueError(
                    f"conflicting replication fractions: scheme "
                    f"{self.scheme!r} vs replicate_frac="
                    f"{self.replicate_frac}")
            object.__setattr__(self, "scheme", base)
            object.__setattr__(self, "replicate_frac", inline)
        if base not in available_schemes():
            raise ValueError(
                f"unknown scheme {self.scheme!r}; valid: "
                f"{available_schemes()} (legacy 'hybrid+fused' = scheme "
                f"'hybrid' + backend 'fused_cuda'; see "
                f"PipelineSpec.from_scheme)")
        # instantiating checks the scheme's parameter (hybrid_partial
        # needs a replicate_frac in [0, 1]; vanilla and hybrid take none)
        resolve_scheme(base, frac=self.replicate_frac)
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
class PrefetchSpec:
    """Prefetch and host staging (counterpart of ``repro``'s).

    depth:       prepared batches kept in flight ahead of the consume half;
                 0 selects the ``"sync"`` driver, >= 1 ``"double_buffer"``.
    seed_stream: how step k's salt derives from k: ``"counter"`` (base +
                 k) or ``"fold"`` (a Knuth multiplicative hash of k).
    sampling:    run the sampling stage in the prepare half.
    features:    run the feature fetch in the prepare half too; when False
                 the consume half fetches (only sampling is prefetched).
    staging:     a background thread draws future steps' seeds on the
                 host and copies them to the device ahead of the step
                 (``repro_torch.pipeline.staging``).
    lead:        slots the stager rides ahead of the driver's own
                 lookahead (its ring holds depth + lead slots), >= 1.
    """
    depth: int = 0
    seed_stream: str = "counter"
    sampling: bool = True
    features: bool = True
    staging: bool = False
    lead: int = 1

    def __post_init__(self):
        if self.depth < 0:
            raise ValueError(f"prefetch depth must be >= 0, got {self.depth}")
        if self.lead < 1:
            raise ValueError(
                f"staging lead must be >= 1, got {self.lead} (the staging "
                f"ring holds depth + lead slots; lead 0 stages nothing "
                f"ahead of the driver)")
        if self.seed_stream not in SEED_STREAMS:
            raise ValueError(
                f"unknown seed_stream {self.seed_stream!r}; "
                f"valid: {SEED_STREAMS}")
        if self.features and not self.sampling:
            raise ValueError(
                "cannot prefetch features without sampling: the feature "
                "fetch consumes the sampled frontier")
        if self.depth > 0 and not self.sampling:
            raise ValueError(
                "prefetch depth > 0 with every stage disabled prefetches "
                "nothing; set sampling=True or use depth=0")

    @property
    def mode(self) -> str:
        """Prefetch-driver registry name: ``"sync"`` at depth 0, else
        ``"double_buffer"``."""
        return "sync" if self.depth == 0 else "double_buffer"


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """Everything ``Pipeline.build`` needs: plan + sampler + executor +
    prefetch (+ an optional data source for
    ``Pipeline.build_from_source``).  ``executor`` names the
    ``repro_torch.pipeline.executor`` registry entry the pipeline binds:
    ``"vmap"`` / ``"stacked"`` (all workers on one device), or
    ``"multiprocess"`` / ``"shard_map"`` (one process per rank; the
    pipeline is then the calling rank's)."""
    plan: PlanSpec
    sampler: SamplerSpec
    executor: str = "vmap"
    prefetch: PrefetchSpec = dataclasses.field(default_factory=PrefetchSpec)
    data: DataSpec | None = None

    def __post_init__(self):
        from repro_torch.core.feature_store import resolve_feature_store
        from repro_torch.pipeline.executor import available_executors
        if self.executor not in available_executors():
            raise ValueError(f"unknown executor {self.executor!r}; "
                             f"available: {available_executors()}")
        if resolve_feature_store(self.plan.feature_store).external_rows:
            if self.prefetch.depth < 1:
                raise ValueError(
                    f"feature store {self.plan.feature_store!r} streams "
                    f"rows ahead of the step through the prefetch ring; "
                    f"it needs PrefetchSpec(depth >= 1), got depth="
                    f"{self.prefetch.depth}")
            if not self.prefetch.features:
                raise ValueError(
                    f"feature store {self.plan.feature_store!r} needs the "
                    f"feature stage inside the prefetched prepare half "
                    f"(PrefetchSpec(features=True))")

    @property
    def expected_rounds(self) -> int:
        """all_to_all rounds per step from the scheme's structure: hybrid
        2 (features only), vanilla 2L, hybrid_partial 2L unless the
        replication is complete (``Pipeline.expected_rounds_estimate``
        gives the data-dependent utilized rounds)."""
        from repro_torch.core.placement import resolve_scheme
        scheme = resolve_scheme(self.plan.scheme,
                                frac=self.plan.replicate_frac)
        return scheme.trace_sampling_rounds(self.sampler.num_layers) + 2

    @classmethod
    def from_scheme(cls, scheme: str, *, num_parts: int, fanouts,
                    cache_capacity: int = 0, partition_seed: int = 0,
                    partitioner: str = "ldg", cache_policy: str = "degree",
                    feature_store: str = "exchange",
                    prefetch_depth: int = 0, staging: bool = False,
                    staging_lead: int = 1, executor: str = "vmap",
                    data: DataSpec | None = None) -> "PipelineSpec":
        """Parse a scheme string into a spec:

          vanilla               -> scheme vanilla, backend "unfused"
          hybrid                -> scheme hybrid, backend "unfused"
          hybrid+fused          -> scheme hybrid, backend "fused_cuda"
          hybrid_partial(0.25)  -> scheme hybrid_partial, replicate_frac
                                   0.25, backend "unfused"
          <registered name>     -> passed to ``PlanSpec``, "unfused"

        The cache and feature-store arguments go to ``PlanSpec``, the
        prefetch depth and staging to ``PrefetchSpec``, ``executor`` to
        the spec."""
        from repro_torch.core.placement import (available_schemes,
                                                parse_scheme_name)

        if scheme in LEGACY_SCHEMES:
            placement = "vanilla" if scheme == "vanilla" else "hybrid"
        else:
            if parse_scheme_name(scheme)[0] not in available_schemes():
                extras = tuple(s for s in available_schemes()
                               if s not in LEGACY_SCHEMES)
                raise ValueError(f"unknown scheme {scheme!r}; "
                                 f"valid: {LEGACY_SCHEMES + extras}")
            placement = scheme          # PlanSpec parses an inline frac
        backend = "fused_cuda" if scheme == "hybrid+fused" else "unfused"
        return cls(
            plan=PlanSpec(num_parts=num_parts, scheme=placement,
                          cache_capacity=cache_capacity,
                          cache_policy=cache_policy,
                          partition_seed=partition_seed,
                          partitioner=partitioner,
                          feature_store=feature_store),
            sampler=SamplerSpec(fanouts=tuple(fanouts), backend=backend),
            executor=executor,
            prefetch=PrefetchSpec(depth=prefetch_depth, staging=staging,
                                  lead=staging_lead),
            data=data)
