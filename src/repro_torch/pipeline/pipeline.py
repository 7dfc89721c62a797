"""``Pipeline`` — the one-call factory over partition, layout, placement
and worker shards (counterpart of ``repro.pipeline.pipeline``).

``Pipeline.build(graph, features, labels, spec)`` partitions on the host,
moves the relabeled topology and the feature shards to ``device`` (CUDA
unless the caller passes ``device="cpu"``), and returns an object whose
``infer_step_fn`` runs the serving step program over all P workers.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import dist
from repro_torch.core.graph import CSCGraph
from repro_torch.device import resolve_device
from repro_torch.pipeline.executor import StackedExecutor
from repro_torch.pipeline.specs import PipelineSpec


@dataclasses.dataclass
class Pipeline:
    """A fully materialized pipeline.

    spec:             the ``PipelineSpec`` it was built from.
    layout:           relabeled topology + ownership metadata (on device).
    shards:           per-worker features and labels, stacked on axis 0.
    graph_replicated: the replicated topology (hybrid scheme).
    counter:          communication-round counter, ticked by programs
                      built with ``counted=True``.
    placement:        the ``PlacementPlan`` sampling dispatches through.
    dataset:          the source ``GraphDataset`` (``build_from_source``).
    """
    spec: PipelineSpec
    layout: "PartitionLayout"                       # noqa: F821
    shards: dist.WorkerShard
    graph_replicated: CSCGraph | None
    counter: dist.RoundCounter
    placement: "PlacementPlan"                      # noqa: F821
    dataset: "GraphDataset | None" = None           # noqa: F821

    # ---------------------------------------------------------------- build

    @classmethod
    def build(cls, graph: CSCGraph, features, labels, spec: PipelineSpec,
              *, labeled_mask=None, device=None) -> "Pipeline":
        """Partition ``graph`` (on the CPU) by the spec'd partitioner and
        assemble every stage on ``device``."""
        from repro_torch.core.graph import csr_view_release
        from repro_torch.core.partition import (build_layout,
                                                resolve_partitioner)

        device = resolve_device(device)
        plan = spec.plan
        labels = np.asarray(labels)
        if labeled_mask is None:
            labeled_mask = labels >= 0
        assign = resolve_partitioner(plan.partitioner).assign(
            graph, plan.num_parts, np.asarray(labeled_mask),
            seed=plan.partition_seed, slack=plan.node_slack,
            labeled_slack=plan.labeled_slack)
        layout = build_layout(graph, np.asarray(features), labels, assign,
                              plan.num_parts, device=device)
        csr_view_release(graph)
        return cls.from_layout(layout, spec, device=device)

    @classmethod
    def build_from_source(cls, source=None, spec: PipelineSpec = None, *,
                          device=None) -> "Pipeline":
        """``Pipeline.build`` with the dataset resolved by the
        ``repro_torch.data`` source registry (``source`` defaults to
        ``spec.data.source``)."""
        from repro_torch.data.spec import resolve_dataset

        if spec is None:
            raise ValueError("build_from_source needs a PipelineSpec")
        device = resolve_device(device)
        ds = resolve_dataset(source, spec.data)
        pipe = cls.build(ds.graph, ds.features, ds.labels, spec,
                         device=device)
        pipe.dataset = ds
        return pipe

    @classmethod
    def from_layout(cls, layout, spec: PipelineSpec, *,
                    device=None) -> "Pipeline":
        """Assemble a pipeline over an existing ``PartitionLayout``, moved
        to ``device`` if it lies elsewhere (so several specs can share one
        partitioning)."""
        from repro_torch.core.placement import resolve_scheme

        device = resolve_device(device)
        if layout.device.type != device.type:
            layout = layout.to(device)
        if layout.num_parts != spec.plan.num_parts:
            raise ValueError(
                f"layout has {layout.num_parts} parts, spec asks for "
                f"{spec.plan.num_parts}")
        placement = resolve_scheme(spec.plan.scheme).build(layout)
        shards = dist.WorkerShard(features=layout.features,
                                  labels=layout.labels)
        return cls(spec=spec, layout=layout, shards=shards,
                   graph_replicated=placement.replicated_graph,
                   counter=dist.RoundCounter(), placement=placement)

    # ------------------------------------------------------------- programs

    def _check_device(self, device) -> None:
        device = resolve_device(device)
        if device.type != self.device.type:
            raise ValueError(f"asked for {device}, but the pipeline's data "
                             f"lies on {self.device}")

    def make_infer_prepare_consume(self, forward_fn, *,
                                   counted: bool = False, device=None):
        """The *prepare* / *consume* halves of the inference step
        (``repro_torch.pipeline.infer``), on ``device`` (the pipeline's;
        ``None`` means CUDA)."""
        from repro_torch.pipeline import infer as _infer

        self._check_device(device)
        return _infer.make_infer_prepare_consume(
            offsets=self.layout.offsets, num_parts=self.num_parts,
            fanouts=self.spec.sampler.fanouts, forward_fn=forward_fn,
            plan=self.placement, backend=self.spec.sampler.backend,
            counter=self.counter if counted else None)

    def make_infer_step(self, forward_fn, *, counted: bool = False,
                        device=None):
        """``step(params, shard, seeds, salt) -> (logits, metrics)`` over
        the stacked worker axis, on ``device`` (the pipeline's; ``None``
        means CUDA)."""
        from repro_torch.pipeline import infer as _infer

        self._check_device(device)
        return _infer.make_infer_step(
            offsets=self.layout.offsets, num_parts=self.num_parts,
            fanouts=self.spec.sampler.fanouts, forward_fn=forward_fn,
            plan=self.placement, backend=self.spec.sampler.backend,
            counter=self.counter if counted else None)

    def infer_step_fn(self, forward_fn, *, counted: bool = False,
                      device=None):
        """Bind the inference step to the stacked executor:
        ``fn(params, seeds, salt) -> (logits, metrics)`` with stacked
        (P, batch) seeds routed to their owners
        (``repro_torch.serve.batcher.route_by_owner``) and (P, batch, C)
        logits, on ``device`` (the pipeline's; ``None`` means CUDA)."""
        return StackedExecutor().bind_infer(
            self, self.make_infer_step(forward_fn, counted=counted,
                                       device=device))

    # ------------------------------------------------------------ utilities

    @property
    def device(self) -> torch.device:
        return self.layout.device

    @property
    def expected_rounds(self) -> int:
        """all_to_all rounds per step from the placement's accounting."""
        return self.placement.trace_rounds(self.spec.sampler.num_layers)

    @property
    def num_parts(self) -> int:
        return self.spec.plan.num_parts
