"""Placement schemes as a registry (counterpart of
``repro.core.placement``).

The paper's two placements are the ends of a memory <-> rounds trade-off:
``"vanilla"`` partitions topology and features (2L communication rounds a
step), ``"hybrid"`` replicates the topology and partitions the features (2
rounds).  A ``PlacementScheme`` owns its plan construction (``build(layout)
-> plan``), its sampling program (``sample(plan, shard, seeds, fanouts,
salt, ...) -> (mfgs, utilized bytes (P,))``) and its round accounting:
``trace_sampling_rounds`` (the program's structure) and
``expected_sampling_rounds`` (a data-dependent estimate of the rounds whose
payload leaves its worker).

Built-in schemes:

  ``"vanilla"``         the partitioned protocol (``dist.vanilla_sample``).
  ``"hybrid"``          the replicated protocol (``dist.hybrid_sample``);
                        the only scheme that samples through the level
                        backend (``level_fn``).
  ``"hybrid_partial"``  degree-aware partial replication: every worker
                        replicates the in-edge lists of the top-``frac``
                        nodes by in-degree and falls back to the vanilla
                        2-round exchange for cold frontier nodes.  Named
                        ``PlanSpec(scheme="hybrid_partial",
                        replicate_frac=0.25)`` or inline
                        ``"hybrid_partial(0.25)"``.

All three draw the same minibatches for the same seeds and salt: a draw is
a stateless hash of (node id, level salt, slot), so where a node's
neighbours are drawn never changes what is drawn.  ``vanilla`` and
``hybrid_partial`` draw windowless; ``hybrid`` draws through its level
backend, whose fused kernel draws from at most ``window`` neighbours.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable

import numpy as np
import torch

from repro_torch.core import dist
from repro_torch.core.graph import CSCGraph


# --------------------------------------------------------------------------
# plans
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PlacementPlan:
    """Product of ``scheme.build(layout)``: partition boundaries, the
    stacked per-worker topology when the scheme's workers read one, and
    whatever else the scheme's sampling program reads.

    ``remote_source_fraction`` is the share of edges whose source another
    partition owns than their destination's: the first-order chance that
    an exchanged frontier request leaves its worker (1.0 for plans built
    without a layout).
    """
    scheme: "PlacementScheme"
    offsets: torch.Tensor
    num_parts: int
    local_indptr: torch.Tensor | None = None
    local_indices: torch.Tensor | None = None
    remote_source_fraction: float = 1.0

    def sample(self, shard, seeds, fanouts, salt, *, level_fn=None,
               fused: bool = False, counter=None, group=None):
        """``scheme.sample`` with this plan bound; ``group`` is the rank's
        ``dist.RankGroup`` in a fleet (``seeds`` and ``shard`` then hold
        its workers only)."""
        return self.scheme.sample(self, shard, seeds, fanouts, salt,
                                  level_fn=level_fn, fused=fused,
                                  counter=counter, group=group)

    def shard_topology(self):
        """(local_indptr, local_indices) for the ``WorkerShard``: both
        ``None`` for schemes whose workers read no local topology (the
        port's shard is no pytree, so it needs no placeholder).  Raises
        for a plan built without a layout (``plan_from_legacy``) of a
        scheme whose workers read one."""
        if self.local_indptr is None and self.scheme.local_topology:
            raise ValueError(
                f"plan for scheme {self.scheme.name!r} was built without a "
                f"layout; shard topology is unavailable")
        return self.local_indptr, self.local_indices

    def trace_rounds(self, num_layers: int) -> int:
        """all_to_all rounds per step: the scheme's sampling rounds + 2
        feature rounds."""
        return self.scheme.trace_sampling_rounds(num_layers, plan=self) + 2

    def expected_rounds(self, num_layers: int) -> float:
        """Data-dependent estimate of the utilized rounds per step: the
        scheme's expected sampling rounds + 2 feature rounds."""
        return self.scheme.expected_sampling_rounds(self, num_layers) + 2.0

    @property
    def replicated_graph(self) -> CSCGraph | None:
        """Fully replicated topology, when the scheme has one."""
        return None


def _remote_edges(layout, indptr: np.ndarray,
                  indices: np.ndarray) -> np.ndarray:
    """(E,) bool over the layout's CSC edges: True where another partition
    owns the source than the destination.  Host numpy over the relabeled
    CSC, as ``repro``'s ``_remote_edge_mass``."""
    offsets = layout.host_offsets_labels()[0]
    node_owner = (np.searchsorted(offsets, np.arange(layout.graph.num_nodes),
                                  side="right") - 1)
    owner_dst = np.repeat(node_owner, np.diff(indptr))
    return node_owner[indices] != owner_dst


def _edge_share(mask: np.ndarray) -> float:
    """Share of edges where ``mask`` holds (0.0 on an empty graph): with
    ``_remote_edges``, the mass of frontier draws that cross workers in an
    exchange round."""
    return float(np.mean(mask)) if mask.size else 0.0


@dataclasses.dataclass(frozen=True)
class HybridPlacementPlan(PlacementPlan):
    """Hybrid plan: every worker reads the replicated topology."""
    graph: CSCGraph | None = None

    @property
    def replicated_graph(self) -> CSCGraph | None:
        return self.graph


@dataclasses.dataclass(frozen=True)
class PartialPlacementPlan(PlacementPlan):
    """Degree-aware partial replication plan.

    hot_graph:    full-width CSC whose in-edge lists are filled only for
                  hot nodes, in the global CSC's order (so draws equal the
                  other schemes'); replicated on every worker.
    hot_mask:     (n,) bool, True for hot nodes.
    frac:         the requested replication fraction.
    hot_count:    number of hot nodes (``complete`` when it is n).
    cold_remote_source_fraction: share of edges whose source is cold and
                  owned by another partition than the destination's: the
                  cold mass that crosses workers, behind the expected-round
                  estimate.
    replicated_edges / replicated_edge_fraction: in-edges replicated per
                  worker, and their share of all edges (the memory cost).
    """
    hot_graph: CSCGraph | None = None
    hot_mask: torch.Tensor | None = None
    frac: float = 0.0
    hot_count: int = 0
    cold_remote_source_fraction: float = 1.0
    replicated_edges: int = 0
    replicated_edge_fraction: float = 0.0

    @property
    def complete(self) -> bool:
        """True when every node is hot: the program is the hybrid one (no
        sampling exchange)."""
        n = int(self.hot_mask.shape[0]) if self.hot_mask is not None else -1
        return self.hot_count >= n >= 0


# --------------------------------------------------------------------------
# scheme objects
# --------------------------------------------------------------------------

class PlacementScheme:
    """Base class: plan construction, sampling program, round accounting.

    ``sample(plan, shard, seeds, fanouts, salt, *, level_fn, fused,
    counter, group) -> (mfgs, sampling_utilized_bytes)`` runs all P
    workers at once on the stacked axis (a fleet rank's own workers, with
    its ``dist.RankGroup`` as ``group``); the bytes are (P,) f32, the valid id and
    reply payload each worker put into sampling ``exchange`` rounds.  A
    scheme with ``uses_level_backend`` samples every level through
    ``level_fn``; the others draw through their own windowless samplers,
    and ``fused`` only picks how a level's row pointer is built.
    """

    name: str = "?"
    uses_level_backend: bool = False
    # whether the workers sample their own partition's in-edges
    # (``WorkerShard.local_indptr`` / ``local_indices``)
    local_topology: bool = True

    def build(self, layout) -> PlacementPlan:
        raise NotImplementedError

    def sample(self, plan, shard, seeds, fanouts, salt, *, level_fn=None,
               fused: bool = False, counter=None, group=None):
        raise NotImplementedError

    def trace_sampling_rounds(self, num_layers: int, plan=None) -> int:
        raise NotImplementedError

    def expected_sampling_rounds(self, plan, num_layers: int) -> float:
        return float(self.trace_sampling_rounds(num_layers, plan=plan))


class VanillaScheme(PlacementScheme):
    """The paper's baseline: topology and features partitioned, 2 rounds
    per level below the top."""

    name = "vanilla"

    def build(self, layout) -> PlacementPlan:
        from repro_torch.core.partition import build_vanilla
        local = build_vanilla(layout)
        remote = _remote_edges(layout, *layout.graph.numpy())
        return PlacementPlan(scheme=self, offsets=layout.offsets,
                             num_parts=layout.num_parts,
                             local_indptr=local.local_indptr,
                             local_indices=local.local_indices,
                             remote_source_fraction=_edge_share(remote))

    def sample(self, plan, shard, seeds, fanouts, salt, *, level_fn=None,
               fused: bool = False, counter=None, group=None):
        return dist.vanilla_sample(shard, plan.offsets, plan.num_parts,
                                   seeds, fanouts, salt, counter,
                                   fused=fused, group=group)

    def trace_sampling_rounds(self, num_layers: int, plan=None) -> int:
        return 2 * (num_layers - 1)

    def expected_sampling_rounds(self, plan, num_layers: int) -> float:
        """Each of the 2(L-1) rounds, utilized in proportion to the
        request mass that leaves its worker (the partitioner's remote edge
        mass)."""
        if plan is None:
            return float(self.trace_sampling_rounds(num_layers))
        return (2.0 * (num_layers - 1)
                * float(plan.remote_source_fraction))


class HybridScheme(PlacementScheme):
    """The paper's contribution: topology replicated, features
    partitioned, so sampling is local."""

    name = "hybrid"
    uses_level_backend = True
    local_topology = False

    def build(self, layout) -> HybridPlacementPlan:
        return HybridPlacementPlan(scheme=self, offsets=layout.offsets,
                                   num_parts=layout.num_parts,
                                   graph=layout.graph)

    def sample(self, plan, shard, seeds, fanouts, salt, *, level_fn=None,
               fused: bool = False, counter=None, group=None):
        if plan.graph is None:
            raise ValueError("hybrid scheme needs the replicated topology")
        mfgs = dist.hybrid_sample(plan.graph, seeds, fanouts, salt,
                                  level_fn=level_fn)
        return mfgs, torch.zeros(seeds.shape[0], dtype=torch.float32,
                                 device=seeds.device)

    def trace_sampling_rounds(self, num_layers: int, plan=None) -> int:
        return 0


class HybridPartialScheme(PlacementScheme):
    """Degree-aware partial replication: the in-edge lists of the
    top-``frac`` nodes by in-degree are replicated; cold frontier nodes
    fall back to the vanilla 2-round exchange.  ``frac=1.0`` is the hybrid
    program (no sampling exchange), ``frac=0.0`` the vanilla one; in
    between the program keeps the 2(L-1) rounds and their utilized payload
    shrinks with the hot set's edge coverage.  Hot and cold draws merge
    before the relabel, so both run through the protocol's own windowless
    samplers."""

    name = "hybrid_partial"

    def __init__(self, frac: float | None = None):
        if frac is None:
            raise ValueError(
                "hybrid_partial needs a replication fraction: use "
                "PlanSpec(scheme='hybrid_partial', replicate_frac=...) or "
                "the inline form scheme='hybrid_partial(0.25)'")
        frac = float(frac)
        if not 0.0 <= frac <= 1.0:
            raise ValueError(f"replicate_frac must be in [0, 1], got {frac}")
        self.frac = frac

    def build(self, layout) -> PartialPlacementPlan:
        from repro_torch.core.cache import resolve_hot_scorer
        from repro_torch.core.partition import build_vanilla

        graph = layout.graph
        indptr, indices = graph.numpy()
        n = graph.num_nodes
        deg = np.diff(indptr)

        k = int(np.round(self.frac * n))
        hot_ids = resolve_hot_scorer("degree").top_ids(graph, k)
        hot_mask = np.zeros(n, bool)
        hot_mask[hot_ids] = True

        keep = np.repeat(hot_mask, deg)
        hot_indices = indices[keep]
        hot_deg = np.where(hot_mask, deg, 0)
        hot_indptr = np.zeros(n + 1, np.int64)
        np.cumsum(hot_deg, out=hot_indptr[1:])
        if hot_indices.size == 0:       # keep indexing well-defined
            hot_indices = np.full(1, -1, np.int64)
        dev = layout.device
        hot_graph = CSCGraph(
            indptr=torch.from_numpy(hot_indptr.astype(np.int32)).to(dev),
            indices=torch.from_numpy(hot_indices.astype(np.int32)).to(dev))

        num_edges = max(int(indices.size), 1)
        remote = _remote_edges(layout, indptr, indices)
        replicated = int(hot_deg.sum())

        # workers keep their vanilla slice to serve cold requests
        local = build_vanilla(layout)
        return PartialPlacementPlan(
            scheme=self, offsets=layout.offsets,
            num_parts=layout.num_parts,
            local_indptr=local.local_indptr,
            local_indices=local.local_indices,
            remote_source_fraction=_edge_share(remote),
            hot_graph=hot_graph,
            hot_mask=torch.from_numpy(hot_mask).to(dev),
            frac=self.frac, hot_count=k,
            cold_remote_source_fraction=_edge_share(
                remote & ~hot_mask[indices]),
            replicated_edges=replicated,
            replicated_edge_fraction=replicated / num_edges)

    def sample(self, plan, shard, seeds, fanouts, salt, *, level_fn=None,
               fused: bool = False, counter=None, group=None):
        hot = plan.hot_count > 0
        return dist.vanilla_sample(
            shard, plan.offsets, plan.num_parts, seeds, fanouts, salt,
            counter, fused=fused,
            hot_graph=plan.hot_graph if hot else None,
            hot_mask=plan.hot_mask if hot else None,
            all_hot=plan.complete, group=group)

    def trace_sampling_rounds(self, num_layers: int, plan=None) -> int:
        if plan is not None:
            return 0 if plan.complete else 2 * (num_layers - 1)
        # no data: frac pins the two degenerate ends
        return 0 if self.frac >= 1.0 else 2 * (num_layers - 1)

    def expected_sampling_rounds(self, plan, num_layers: int) -> float:
        """Each of the 2(L-1) rounds, utilized in proportion to the cold
        request mass that crosses workers; at ``frac=0`` this is the
        vanilla estimate on the same layout."""
        if plan is None:
            return 0.0 if self.frac >= 1.0 else 2.0 * (num_layers - 1)
        if plan.complete:
            return 0.0
        return (2.0 * (num_layers - 1)
                * float(plan.cold_remote_source_fraction))


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

_SCHEMES: dict[str, Callable[..., PlacementScheme]] = {}

_PARAM_RE = re.compile(r"^([A-Za-z_][\w+-]*)\(([^()]*)\)$")


def parse_scheme_name(name: str) -> tuple[str, float | None]:
    """Split an optionally parameterized scheme name:
    ``"hybrid"`` -> ``("hybrid", None)``, ``"hybrid_partial(0.25)"`` ->
    ``("hybrid_partial", 0.25)``."""
    m = _PARAM_RE.match(name)
    if m is None:
        return name, None
    try:
        return m.group(1), float(m.group(2))
    except ValueError:
        raise ValueError(
            f"scheme parameter in {name!r} must be a float") from None


def register_scheme(name: str, factory: Callable[..., PlacementScheme], *,
                    overwrite: bool = False) -> None:
    """Register ``factory(frac=None) -> PlacementScheme`` under ``name``;
    factories of unparameterized schemes reject a non-None ``frac``."""
    if not overwrite and name in _SCHEMES and _SCHEMES[name] is not factory:
        raise ValueError(f"placement scheme {name!r} already registered; "
                         f"pass overwrite=True to replace it")
    _SCHEMES[name] = factory


def available_schemes() -> tuple[str, ...]:
    """Sorted names of registered placement schemes."""
    return tuple(sorted(_SCHEMES))


def resolve_scheme(name: str, *, frac: float | None = None
                   ) -> PlacementScheme:
    """Instantiate the scheme registered under ``name``, which may carry an
    inline parameter (``"hybrid_partial(0.25)"``); a ``frac`` keyword must
    then agree with it.  Raises ``KeyError`` for an unknown name."""
    base, inline = parse_scheme_name(name)
    if inline is not None:
        if frac is not None and float(frac) != inline:
            raise ValueError(
                f"conflicting replication fractions: scheme name carries "
                f"{inline}, keyword gives {frac}")
        frac = inline
    try:
        factory = _SCHEMES[base]
    except KeyError:
        raise KeyError(f"unknown placement scheme {name!r}; "
                       f"available: {available_schemes()}") from None
    return factory(frac=frac)


def _unparameterized(cls):
    def factory(frac: float | None = None):
        if frac is not None:
            raise ValueError(
                f"scheme {cls.name!r} takes no replication fraction")
        return cls()
    return factory


register_scheme("vanilla", _unparameterized(VanillaScheme))
register_scheme("hybrid", _unparameterized(HybridScheme))
register_scheme("hybrid_partial",
                lambda frac=None: HybridPartialScheme(frac))


def plan_from_legacy(scheme: str, *, graph_replicated=None, offsets=None,
                     num_parts: int = 0) -> PlacementPlan:
    """A layout-free plan from the legacy ``(scheme, graph_replicated)``
    calling convention of the step builders, as ``repro``'s.  It holds no
    shard topology: a vanilla worker's in-edges come from the caller's
    ``WorkerShard`` (``partition.build_vanilla``), and a hybrid worker
    reads none.  Parameterized schemes need a layout-built plan:
    ``resolve_scheme(name).build(layout)``, passed as ``plan=``."""
    base, frac = parse_scheme_name(scheme)
    if base == "vanilla":
        return PlacementPlan(scheme=resolve_scheme("vanilla"),
                             offsets=offsets, num_parts=num_parts)
    if base == "hybrid":
        if graph_replicated is None:
            raise ValueError("hybrid scheme needs the replicated topology")
        return HybridPlacementPlan(scheme=resolve_scheme("hybrid"),
                                   offsets=offsets, num_parts=num_parts,
                                   graph=graph_replicated)
    if frac is not None or base in _SCHEMES:
        raise ValueError(
            f"scheme {scheme!r} needs a layout-built plan; construct it "
            f"with resolve_scheme({scheme!r}).build(layout) and pass "
            f"plan=... (or use repro_torch.pipeline.Pipeline)")
    raise ValueError(f"unknown scheme {scheme!r}; "
                     f"available: {available_schemes()}")
