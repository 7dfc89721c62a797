"""Placement schemes as a registry (counterpart of ``repro.core.placement``;
the ``hybrid`` scheme only so far).

A ``PlacementScheme`` owns its plan construction (``build(layout) ->
plan``), its sampling program (``sample(plan, shard, seeds, fanouts, salt,
...) -> (mfgs, utilized bytes)``) and its round accounting.  ``hybrid``
(the paper's contribution) replicates the topology and partitions the
features, so sampling needs no communication and a step has exactly the 2
feature rounds.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import dist
from repro_torch.core.graph import CSCGraph


@dataclasses.dataclass(frozen=True)
class PlacementPlan:
    """Product of ``scheme.build(layout)``: partition boundaries plus
    whatever the scheme's sampling program reads."""
    scheme: "PlacementScheme"
    offsets: torch.Tensor
    num_parts: int

    def sample(self, shard, seeds, fanouts, salt, *, level_fn=None,
               counter=None):
        """``scheme.sample`` with this plan bound."""
        return self.scheme.sample(self, shard, seeds, fanouts, salt,
                                  level_fn=level_fn, counter=counter)

    def trace_rounds(self, num_layers: int) -> int:
        """all_to_all rounds per step: the scheme's sampling rounds + 2
        feature rounds."""
        return self.scheme.trace_sampling_rounds(num_layers, plan=self) + 2

    @property
    def replicated_graph(self) -> CSCGraph | None:
        """Fully replicated topology, when the scheme has one."""
        return None


@dataclasses.dataclass(frozen=True)
class HybridPlacementPlan(PlacementPlan):
    """Hybrid plan: every worker reads the replicated topology."""
    graph: CSCGraph | None = None

    @property
    def replicated_graph(self) -> CSCGraph | None:
        return self.graph


class PlacementScheme:
    """Base class: plan construction, sampling program, round count."""

    name: str = "?"

    def build(self, layout) -> PlacementPlan:
        raise NotImplementedError

    def sample(self, plan, shard, seeds, fanouts, salt, *, level_fn=None,
               counter=None):
        raise NotImplementedError

    def trace_sampling_rounds(self, num_layers: int, plan=None) -> int:
        raise NotImplementedError


class HybridScheme(PlacementScheme):
    """Topology replicated, features partitioned: sampling is local."""

    name = "hybrid"

    def build(self, layout) -> HybridPlacementPlan:
        return HybridPlacementPlan(scheme=self, offsets=layout.offsets,
                                   num_parts=layout.num_parts,
                                   graph=layout.graph)

    def sample(self, plan, shard, seeds, fanouts, salt, *, level_fn=None,
               counter=None):
        if plan.graph is None:
            raise ValueError("hybrid scheme needs the replicated topology")
        mfgs = dist.hybrid_sample(plan.graph, seeds, fanouts, salt,
                                  level_fn=level_fn)
        return mfgs, torch.zeros((), dtype=torch.float32,
                                 device=seeds.device)

    def trace_sampling_rounds(self, num_layers: int, plan=None) -> int:
        return 0


_SCHEMES: dict[str, Callable[[], PlacementScheme]] = {}


def register_scheme(name: str, factory: Callable[[], PlacementScheme], *,
                    overwrite: bool = False) -> None:
    """Register ``factory() -> PlacementScheme`` under ``name``."""
    if not overwrite and name in _SCHEMES and _SCHEMES[name] is not factory:
        raise ValueError(f"placement scheme {name!r} already registered; "
                         f"pass overwrite=True to replace it")
    _SCHEMES[name] = factory


def available_schemes() -> tuple[str, ...]:
    """Sorted names of registered placement schemes."""
    return tuple(sorted(_SCHEMES))


def resolve_scheme(name: str) -> PlacementScheme:
    """Instantiate the scheme registered under ``name``."""
    try:
        factory = _SCHEMES[name]
    except KeyError:
        raise KeyError(f"unknown placement scheme {name!r}; "
                       f"available: {available_schemes()}") from None
    return factory()


register_scheme("hybrid", HybridScheme)
