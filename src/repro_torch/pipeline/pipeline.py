"""``Pipeline`` — the one-call factory over partition, layout, placement
and worker shards (counterpart of ``repro.pipeline.pipeline``).

``Pipeline.build(graph, features, labels, spec)`` partitions on the host,
moves the relabeled topology and the feature shards to ``device`` (CUDA
unless the caller passes ``device="cpu"``), builds the feature cache the
spec asks for, and returns an object whose ``train_step`` /
``train_driver`` run the training step and whose ``infer_step_fn`` runs
the serving step, each over all P workers, through the executor the spec
names (``repro_torch.pipeline.executor``).

Under a fleet executor (``multiprocess``, ``shard_map``) the pipeline is
one rank's: it moves the replicated topology and only its own workers'
rows of the features, labels, local topology and cache to the device,
and its seeds and step programs cover those workers (``group``).  With
``local_parts`` the build materializes only those workers' feature rows
at all (a rank-local build).
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.core import dist
from repro_torch.core.graph import CSCGraph
from repro_torch.device import resolve_device
from repro_torch.obs import trace as _trace
from repro_torch.pipeline.executor import resolve_executor
from repro_torch.pipeline.specs import PipelineSpec


@dataclasses.dataclass
class Pipeline:
    """A fully materialized pipeline.

    spec:             the ``PipelineSpec`` it was built from.
    layout:           relabeled topology + ownership metadata (on device).
    shards:           per-worker features and labels, and the local
                      topology of the partitioned schemes, stacked on
                      axis 0.
    graph_replicated: the replicated topology (hybrid scheme), else None.
    cache:            stacked ``FeatureCache`` when cache_capacity > 0
                      (built by the spec'd ``cache_policy``), else None.
    counter:          communication-round counter, ticked on every call of
                      a program built with ``counted=True`` (the training
                      step always is).
    placement:        the ``PlacementPlan`` sampling dispatches through.
    feature_store:    the ``FeatureStore`` serving the training step's
                      frontier rows (``PlanSpec.feature_store``).
    dataset:          the source ``GraphDataset`` (``build_from_source``).
    group:            the rank's ``dist.RankGroup`` under a fleet
                      executor (shards, cache and seeds hold its workers
                      only), else None.
    """
    spec: PipelineSpec
    layout: "PartitionLayout"                       # noqa: F821
    shards: dist.WorkerShard
    graph_replicated: CSCGraph | None
    cache: "FeatureCache | None"                    # noqa: F821
    counter: dist.RoundCounter
    placement: "PlacementPlan"                      # noqa: F821
    feature_store: "FeatureStore"                   # noqa: F821
    dataset: "GraphDataset | None" = None           # noqa: F821
    group: dist.RankGroup | None = None
    _edge_cut: float | None = dataclasses.field(default=None, init=False,
                                                repr=False)

    # ---------------------------------------------------------------- build

    @classmethod
    def build(cls, graph: CSCGraph, features, labels, spec: PipelineSpec,
              *, labeled_mask=None, local_parts=None,
              partition_chunk_edges=None, device=None) -> "Pipeline":
        """Partition ``graph`` (on the CPU) by the spec'd partitioner and
        assemble every stage on ``device``.  ``local_parts=(lo, hi)``
        builds a fleet rank's pipeline whose feature table holds only
        partitions ``lo .. hi-1`` (the partitioning is deterministic, so
        every rank derives the same assignment); it refuses a cache, which
        copies other partitions' rows.  ``partition_chunk_edges`` runs a
        streaming-capable partitioner's one-pass variant over the graph's
        edges in chunks of that many, in CSC order, instead of its
        in-memory walk."""
        from repro_torch.core.graph import csr_view_release
        from repro_torch.core.partition import (build_layout,
                                                resolve_partitioner)

        device = resolve_device(device)
        plan = spec.plan
        if plan.cache_capacity > 0 and local_parts is not None:
            raise ValueError(
                "cache_capacity > 0 is incompatible with a rank-local "
                "build (local_parts): the cache copies other partitions' "
                "hot feature rows, which a rank-local build never "
                "materializes.  Build the full layout (local_parts=None) "
                "when caching.")
        labels = np.asarray(labels)
        if labeled_mask is None:
            labeled_mask = labels >= 0
        partitioner = resolve_partitioner(plan.partitioner)
        kw = dict(seed=plan.partition_seed, slack=plan.node_slack,
                  labeled_slack=plan.labeled_slack)
        if partition_chunk_edges is not None:
            from repro_torch.data.ingest import iter_edge_chunks
            assign = partitioner.assign_stream(
                iter_edge_chunks(graph, chunk_edges=partition_chunk_edges),
                graph.num_nodes, plan.num_parts, np.asarray(labeled_mask),
                **kw)
        else:
            assign = partitioner.assign(graph, plan.num_parts,
                                        np.asarray(labeled_mask), **kw)
        # a fleet rank moves only its own rows to the device, in
        # from_layout: the layout stays on the host until then
        fleet = resolve_executor(spec.executor).fleet
        layout = build_layout(graph, np.asarray(features), labels, assign,
                              plan.num_parts,
                              device=torch.device("cpu") if fleet
                              else device,
                              local_parts=local_parts)
        csr_view_release(graph)
        return cls.from_layout(layout, spec, device=device)

    @classmethod
    def build_from_source(cls, source=None, spec: PipelineSpec = None, *,
                          mmap: bool = True, local_parts=None,
                          partition_chunk_edges=None,
                          device=None) -> "Pipeline":
        """``Pipeline.build`` with the dataset resolved by
        ``repro_torch.data``: ``source`` (default ``spec.data.source``) is
        a registry name or the path of a saved dataset, memory-mapped
        unless ``mmap=False``.  Bit-identical to ``build`` on the resolved
        dataset, which the pipeline keeps on ``.dataset``; ``local_parts``
        as in ``build``."""
        from repro_torch.data.spec import resolve_dataset

        if spec is None:
            raise ValueError("build_from_source needs a PipelineSpec")
        device = resolve_device(device)
        ds = resolve_dataset(source, spec.data, mmap=mmap)
        pipe = cls.build(ds.graph, ds.features, ds.labels, spec,
                         local_parts=local_parts,
                         partition_chunk_edges=partition_chunk_edges,
                         device=device)
        pipe.dataset = ds
        return pipe

    @classmethod
    def from_layout(cls, layout, spec: PipelineSpec, *,
                    device=None) -> "Pipeline":
        """Assemble a pipeline over an existing ``PartitionLayout``, moved
        to ``device`` if it lies elsewhere (so several specs can share one
        partitioning).  Placement, cache construction and the feature
        store resolve by registry name from ``spec.plan``.  Under a fleet
        executor only the topology and offsets move whole; the shards and
        the cache are the rank's rows (``group``)."""
        from repro_torch.core.cache import (FeatureCache,
                                            resolve_cache_policy)
        from repro_torch.core.feature_store import resolve_feature_store
        from repro_torch.core.placement import resolve_scheme

        device = resolve_device(device)
        if layout.num_parts != spec.plan.num_parts:
            raise ValueError(
                f"layout has {layout.num_parts} parts, spec asks for "
                f"{spec.plan.num_parts}")
        plan = spec.plan
        store = resolve_feature_store(plan.feature_store)
        if store.external_rows and layout.local_parts is not None:
            raise ValueError(
                f"feature store {plan.feature_store!r} gathers frontier "
                f"rows on the host from the full feature table; a "
                f"rank-local layout (local_parts="
                f"{tuple(layout.local_parts)!r}) never materializes other "
                f"partitions' rows.  Build with local_parts=None.")
        executor = resolve_executor(spec.executor)
        group = executor.rank_group(plan.num_parts)
        executor.check_layout(layout, group)
        if group is None:
            if layout.device.type != device.type:
                layout = layout.to(device)

            def mine(x):
                return x
        else:
            # each rank derives the partition itself: a partitioner that
            # is not deterministic across processes would mix other
            # workers' rows into the rounds without an error
            digest = hashlib.sha256(np.ascontiguousarray(layout.perm))
            digest.update(layout.host_offsets_labels()[0].tobytes())
            dist.require_same_on_ranks(digest.digest(), group,
                                       "the partition")
            # the topology is replicated; every other table keeps its
            # host copy and moves the rank's rows only
            layout = dataclasses.replace(
                layout, graph=layout.graph.to(device),
                offsets=layout.offsets.to(device))

            def mine(x):
                return None if x is None else x[group.lo:group.hi].to(device)
        placement = resolve_scheme(plan.scheme,
                                   frac=plan.replicate_frac).build(layout)
        local_indptr, local_indices = placement.shard_topology()
        shards = dist.WorkerShard(features=mine(layout.features),
                                  labels=mine(layout.labels),
                                  local_indptr=mine(local_indptr),
                                  local_indices=mine(local_indices))
        cache = None
        if plan.cache_capacity > 0:
            cache = resolve_cache_policy(plan.cache_policy)(
                layout, plan.cache_capacity, fanouts=spec.sampler.fanouts,
                seed=plan.partition_seed)
            cache = FeatureCache(ids=mine(cache.ids), rows=mine(cache.rows))
        return cls(spec=spec, layout=layout, shards=shards,
                   graph_replicated=placement.replicated_graph, cache=cache,
                   counter=dist.RoundCounter(), placement=placement,
                   feature_store=store, group=group)

    # ------------------------------------------------------------- programs

    def _check_device(self, device) -> None:
        device = resolve_device(device)
        if device.type != self.device.type:
            raise ValueError(f"asked for {device}, but the pipeline's data "
                             f"lies on {self.device}")

    def make_step(self, loss_fn, *, device=None):
        """The training step program (``repro_torch.pipeline.worker``):
        ``step(params, shard, seeds, salt[, cache]) -> (loss, grads,
        metrics)``, counted, on ``device`` (the pipeline's; ``None`` means
        CUDA).  ``loss_fn(params, mfgs, h_src, seed_labels, seed_valid)``
        returns the per-worker losses."""
        from repro_torch.pipeline.worker import make_worker_step

        self._check_device(device)
        return make_worker_step(
            offsets=self.layout.offsets, num_parts=self.num_parts,
            fanouts=self.spec.sampler.fanouts, loss_fn=loss_fn,
            plan=self.placement, backend=self.spec.sampler.backend,
            counter=self.counter, use_cache=self.cache is not None,
            store=self.feature_store, group=self.group)

    def make_prepare_consume(self, loss_fn, *, counted: bool = True,
                             device=None):
        """The *prepare* / *consume* halves of the training step
        (``repro_torch.pipeline.prefetch``): ``prepare(shard, seeds, salt,
        cache=None, staged=None) -> PreparedBatch`` and ``consume(params,
        batch, shard=None, cache=None) -> (loss, grads, metrics)``, with
        the feature fetch in prepare unless ``spec.prefetch.features`` is
        False, on ``device`` (the pipeline's; ``None`` means CUDA).
        ``counted=False`` leaves the round counter alone (the drivers'
        refill twin)."""
        from repro_torch.pipeline import prefetch as _prefetch

        self._check_device(device)
        return _prefetch.make_prepare_consume(
            offsets=self.layout.offsets, num_parts=self.num_parts,
            fanouts=self.spec.sampler.fanouts, loss_fn=loss_fn,
            plan=self.placement, backend=self.spec.sampler.backend,
            counter=self.counter if counted else None,
            store=self.feature_store, features=self.spec.prefetch.features,
            group=self.group)

    def make_prepare_fetch_consume(self, loss_fn, *, counted: bool = True,
                                   device=None):
        """``make_prepare_consume`` with the feature stage exposed as a
        third, standalone callable: ``(prepare, fetch, consume)``, with
        ``prepare`` built ``features=False``, so sampling, feature fetch
        and model compute can run (and be fenced) one by one.  This is
        the binding the stage profiler (``repro_torch.obs.profile``)
        uses; the drivers take ``make_prepare_consume``."""
        from repro_torch.pipeline import prefetch as _prefetch

        self._check_device(device)
        return _prefetch.make_prepare_fetch_consume(
            offsets=self.layout.offsets, num_parts=self.num_parts,
            fanouts=self.spec.sampler.fanouts, loss_fn=loss_fn,
            plan=self.placement, backend=self.spec.sampler.backend,
            counter=self.counter if counted else None,
            store=self.feature_store, features=False, group=self.group)

    @property
    def executor(self):
        """A fresh instance of the executor ``spec.executor`` names."""
        return resolve_executor(self.spec.executor)

    def step_fn(self, loss_fn, *, device=None):
        """The training step bound to the spec's executor: ``fn(params,
        seeds, salt) -> (loss, grads, metrics)`` with stacked (P, batch)
        seeds (a fleet rank's own rows, ``local_rows``), on ``device``
        (the pipeline's; ``None`` means CUDA)."""
        return self.executor.bind(self, self.make_step(loss_fn,
                                                       device=device))

    def train_step(self, loss_fn, *, lr: float = 1e-3,
                   optimizer: str = "adamw", grad_clip: float | None = 1.0,
                   device=None):
        """The optimizer-applied synchronous step: ``fn(params, opt_state,
        seeds, salt) -> (params, opt_state, loss, metrics)``, on ``device``
        (the pipeline's; ``None`` means CUDA)."""
        from repro_torch.pipeline.prefetch import make_update_fn

        run = self.step_fn(loss_fn, device=device)
        update = make_update_fn(lr=lr, optimizer=optimizer,
                                grad_clip=grad_clip)

        def fn(params, opt_state, seeds, salt):
            loss, grads, metrics = run(params, seeds, salt)
            params, opt_state, metrics = update(params, opt_state, grads,
                                                metrics)
            return params, opt_state, loss, metrics

        return fn

    def train_driver(self, loss_fn, *, batch: int, lr: float = 1e-3,
                     optimizer: str = "adamw",
                     grad_clip: float | None = 1.0, base_salt: int = 0,
                     mode: str | None = None, staging=None, device=None):
        """The step driver ``spec.prefetch`` selects (``mode`` overrides
        its registry name: ``"sync"`` at depth 0, else
        ``"double_buffer"``): ``driver.step(params, opt_state,
        step_idx=None) -> (params, opt_state, loss, metrics)`` over the
        deterministic seed stream, ``reset()`` and ``close()``, on
        ``device`` (the pipeline's; ``None`` means CUDA).  ``staging``
        (``None`` defers to ``spec.prefetch.staging``; a bool; or a
        ``SeedStager`` to adopt) moves the seed draw, and for the
        ``staged`` store the feature rows, onto a host thread
        (``repro_torch.pipeline.staging``); results are bit-identical."""
        from repro_torch.pipeline.prefetch import resolve_prefetcher

        driver_cls = resolve_prefetcher(mode or self.spec.prefetch.mode)
        return driver_cls(self, loss_fn, batch=batch, lr=lr,
                          optimizer=optimizer, grad_clip=grad_clip,
                          base_salt=base_salt, staging=staging,
                          device=device)

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
            counter=self.counter if counted else None, group=self.group)

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
            counter=self.counter if counted else None, group=self.group)

    def infer_step_fn(self, forward_fn, *, counted: bool = False,
                      device=None):
        """Bind the inference step to the spec's executor:
        ``fn(params, seeds, salt) -> (logits, metrics)`` with stacked
        (P, batch) seeds routed to their owners
        (``repro_torch.serve.batcher.route_by_owner``; a fleet rank passes
        its own rows, ``local_rows``) and (P, batch, C) logits of every
        worker, on ``device`` (the pipeline's; ``None`` means CUDA)."""
        return self.executor.bind_infer(
            self, self.make_infer_step(forward_fn, counted=counted,
                                       device=device))

    # ------------------------------------------------------------ utilities

    def local_rows(self, x):
        """The rows of the workers this pipeline hosts, from a (P, ...)
        array over all workers: ``x`` itself unless it is a fleet rank's,
        whose rows ``lo .. hi-1`` it returns."""
        if self.group is None:
            return x
        return x[self.group.lo:self.group.hi]

    def seeds_host(self, batch: int, epoch_salt: int) -> np.ndarray:
        """(P, batch) per-worker minibatch seeds as a host int32 array,
        drawn from each worker's own labeled nodes (deterministic in
        ``epoch_salt``); a fleet rank's rows of the same draw.  Traced as
        ``seeds/draw`` with the keys it hashes and sorts and the seeds it
        draws, over all P workers."""
        from repro_torch.core.partition import seeds_per_worker_host
        P = self.layout.num_parts
        with _trace.span("seeds/draw", cat="step",
                         keys=P * self.layout.n_max, seeds=P * batch):
            return self.local_rows(seeds_per_worker_host(
                self.layout, batch, epoch_salt=epoch_salt))

    def seeds(self, batch: int, epoch_salt: int) -> torch.Tensor:
        """``seeds_host`` on the pipeline's device (the copy traced as
        ``seeds/h2d``)."""
        host = self.seeds_host(batch, epoch_salt)
        with _trace.span("seeds/h2d", cat="step"):
            return torch.from_numpy(host).to(self.device)

    @property
    def device(self) -> torch.device:
        return self.layout.device

    @property
    def edge_cut_fraction(self) -> float:
        """Share of edges crossing partitions (an O(E) host scan, done
        once)."""
        if self._edge_cut is None:
            from repro_torch.core.graph import csr_view_release
            from repro_torch.core.partition import edge_cut
            offsets = self.layout.host_offsets_labels()[0]
            assign = (np.searchsorted(
                offsets, np.arange(self.layout.graph.num_nodes),
                side="right") - 1)
            cut = edge_cut(self.layout.graph, assign)
            self._edge_cut = cut / max(self.layout.graph.num_edges, 1)
            # the long-lived topology does not keep its O(nnz) CSR view
            csr_view_release(self.layout.graph)
        return self._edge_cut

    @property
    def expected_rounds(self) -> int:
        """all_to_all rounds per step from the placement's structure
        (vanilla 2L, hybrid 2, hybrid_partial 2L unless the replication is
        complete)."""
        return self.placement.trace_rounds(self.spec.sampler.num_layers)

    @property
    def expected_rounds_estimate(self) -> float:
        """Data-dependent estimate of the utilized rounds per step: 2
        feature rounds + the scheme's expected sampling rounds (vanilla's
        scale with the layout's remote edge mass, hybrid_partial's with
        the cold mass that crosses workers; hybrid's are 0)."""
        return self.placement.expected_rounds(self.spec.sampler.num_layers)

    @property
    def num_parts(self) -> int:
        return self.spec.plan.num_parts
