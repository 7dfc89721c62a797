"""The step program split at the prefetch boundary, the update, the seed
stream and the drivers.

Counterpart of ``repro.pipeline.prefetch``.  The step is two halves over
the stacked worker axis (all P workers at once, on axis 0):

  prepare(shard, seeds, salt, cache, staged) -> PreparedBatch
      multi-level sampling through the placement plan, the seed-label
      gather and, unless ``PrefetchSpec(features=False)``, the feature
      fetch through the feature store.  No model parameter is read.
  consume(params, batch, shard, cache) -> (loss, grads, metrics)
      the feature fetch when the prepare half left it out, then the MFG
      forward and backward; metrics are reduced over the worker axis in
      index order.

The gradient is ``repro``'s: each worker's own forward and backward on
its own slice (one backward a worker), then the mean of the losses and
of the gradients over all P workers in worker order.  Built with
``group`` (a fleet rank's ``dist.RankGroup``), both halves run over the
rank's own workers and reduce across the ranks.  So the stacked
executor and fleets of any split of the workers give the same bits.

Every driver, executor and the stage profiler share these sites, which
are traced at the step's layer boundaries (cat ``step``,
``repro_torch.obs.trace``): ``step/sample`` and ``step/fetch`` (with the
rounds they ran, when counted), ``model/forward`` and ``model/backward``
for each worker, ``step/grad_mean`` and ``step/update``.

``SeedStream`` derives step k's seeds and salt from k alone, so every
driver replays the same minibatches.  Drivers resolve by registry name
from ``PrefetchSpec.mode``:

  * ``"sync"``          depth 0: one step after the other.
  * ``"double_buffer"`` depth >= 1: a FIFO of prepared batches; the
                        executor's runner enqueues the prepare of step
                        k + depth before the consume of step k, with
                        nothing between them that waits for the device, so
                        the host dispatches ahead of the card.

Both take ``staging``: a ``repro_torch.pipeline.staging`` stager draws
future steps' seeds (and, for the ``staged`` store, their feature rows) on
a host thread and copies them to the device ahead of the step.  Every
driver and staging choice gives the synchronous driver's losses and
parameters bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import dist
from repro_torch.core.sampler import resolve_backend
from repro_torch.obs import trace as _trace
from repro_torch.optim.optimizers import tree_leaves, tree_map
from repro_torch.pipeline.specs import SEED_STREAMS


@dataclasses.dataclass(frozen=True)
class PreparedBatch:
    """Everything the consume half needs; every tensor has the P axis.

    mfgs:        the L sampled MFGs, top level first.
    h_src:       (P, src_capacity, D) gathered input features, or None
                 when the prepare half left the fetch out
                 (``features=False``); the consume half fills it.
    seed_labels: (P, batch) labels of the seed nodes.
    seed_valid:  (P, batch) bool mask of non-padding seeds.
    hits:        (P,) feature-cache hits (0 without a cache).
    comm:        per-worker utilized bytes and sampler window overflow:
                 ``sampling_utilized_bytes`` (P,),
                 ``feature_utilized_bytes`` (P,),
                 ``sampler_window_overflow`` (P,) (frontier nodes, summed
                 over levels, whose degree exceeded the fused kernel's
                 window) and ``sampler_window_overflow_per_level`` (P, L).
    """
    mfgs: tuple
    h_src: torch.Tensor | None
    seed_labels: torch.Tensor
    seed_valid: torch.Tensor
    hits: torch.Tensor
    comm: dict


def worker_rows(mfg, rows: slice):
    """The MFG of the workers ``rows`` selects on the leading axis."""
    return dataclasses.replace(mfg, **{
        f.name: getattr(mfg, f.name)[rows]
        for f in dataclasses.fields(mfg)})


def make_prepare_fetch_consume(*, offsets: torch.Tensor, num_parts: int,
                               fanouts: Sequence[int], loss_fn: Callable,
                               plan=None, backend: str | None = None,
                               level_fn: Callable | None = None,
                               counter: dist.RoundCounter | None = None,
                               store=None, features: bool = True,
                               group: dist.RankGroup | None = None,
                               scheme: str = "hybrid",
                               graph_replicated=None,
                               vanilla_fused: bool | None = None):
    """Build ``(prepare, fetch, consume)``, the training step's halves with
    the feature stage exposed.

    ``prepare(shard, seeds, salt, cache=None, staged=None) ->
    PreparedBatch``: ``seeds`` is (P, batch), row p holding seeds worker p
    owns (-1 padding); ``salt`` is the uint32 sampling salt; ``cache`` the
    stacked ``FeatureCache`` or ``None``; ``staged`` the (P, N, D) rows a
    ``FeatureStager`` delivered (``external_rows`` stores).  Sampling
    dispatches through ``plan`` (a ``PlacementPlan``); the level backend
    resolves by registry name unless ``level_fn`` is given; ``store`` (a
    ``FeatureStore``, default ``"exchange"``) serves the frontier's rows,
    in prepare unless ``features`` is False.  Backends that count window
    overflow (``supports_overflow_sink``) surface it in ``comm``.  The
    schemes that never call the level backend (vanilla, hybrid_partial)
    build a level's row pointer directly, or through the DGL-style
    COO->CSC passes when the backend is ``"unfused"`` (or a ``level_fn``
    was given).

    ``fetch(shard, batch, cache=None, staged=None)`` fills the feature
    stage of a batch prepared without it (identity when ``h_src`` is
    there).  ``consume(params, batch, shard=None, cache=None) -> (loss,
    grads, metrics)`` fetches first when needed; ``loss_fn(params, mfgs,
    h_src, seed_labels, seed_valid)`` returns the per-worker losses (P,),
    ``loss`` is their mean and ``grads`` (a tree like ``params``) its
    gradient; ``metrics`` has ``repro``'s keys.  With ``group`` every
    stacked argument and result holds the rank's workers only, and the
    loss, gradients and metrics are reduced over all P workers (the
    module's docstring says how).

    ``repro``'s legacy keywords: without a ``plan`` one is built from
    ``scheme`` and ``graph_replicated`` (``placement.plan_from_legacy``);
    ``vanilla_fused`` overrides how the partitioned protocols build a
    level's row pointer (``None`` keeps the default above).
    """
    from repro_torch.core.feature_store import ExchangeStore
    from repro_torch.core.placement import plan_from_legacy

    if plan is None:
        plan = plan_from_legacy(scheme, graph_replicated=graph_replicated,
                                offsets=offsets, num_parts=num_parts)
    if backend is not None and level_fn is not None:
        raise ValueError("pass either backend or level_fn, not both")
    if level_fn is None:
        backend = backend or "reference"
        level_fn = resolve_backend(backend)
    fused = vanilla_fused if vanilla_fused is not None else (
        backend is not None and backend != "unfused")
    if store is None:
        store = ExchangeStore()
    if store.external_rows and not features:
        raise ValueError(
            f"feature store {store.name!r} serves the feature stage from "
            f"staged rows; it cannot run with features=False")
    sink_backend = getattr(level_fn, "supports_overflow_sink", False)
    L = len(fanouts)
    first_worker = 0 if group is None else group.lo

    def rounds():
        return None if counter is None else counter.rounds

    def fetch(shard: dist.WorkerShard, batch: PreparedBatch, cache=None,
              staged=None):
        if batch.h_src is not None:
            return batch
        with _trace.span("step/fetch", cat="step") as sp:
            r0 = rounds()
            src = batch.mfgs[-1].src_nodes
            h_src, hits = store.fetch(src, shard, cache, offsets=offsets,
                                      num_parts=num_parts, counter=counter,
                                      staged_rows=staged, group=group)
            row_bytes = 4.0 + shard.features.shape[2] \
                * shard.features.element_size()
            comm = dict(batch.comm,
                        feature_utilized_bytes=store.utilized_bytes(
                            src, hits, row_bytes))
            if r0 is not None:
                sp.add_args(rounds=rounds() - r0)
        return dataclasses.replace(batch, h_src=h_src, hits=hits, comm=comm)

    def prepare(shard: dist.WorkerShard, seeds: torch.Tensor, salt,
                cache=None, staged=None):
        with _trace.span("step/sample", cat="step") as sp:
            r0 = rounds()
            batch = sample(shard, seeds, salt)
            if r0 is not None:
                sp.add_args(rounds=rounds() - r0)
        return fetch(shard, batch, cache, staged) if features else batch

    def sample(shard, seeds, salt):
        sink: list = []
        lf = level_fn
        if sink_backend:
            def lf(graph, frontier, fanout, level_salt):
                return level_fn(graph, frontier, fanout, level_salt,
                                overflow_sink=sink)
        mfgs, samp_bytes = plan.sample(shard, seeds, fanouts, salt,
                                       level_fn=lf, fused=fused,
                                       counter=counter, group=group)
        P = seeds.shape[0]
        per_level = torch.zeros((P, L), dtype=torch.int64,
                                device=seeds.device)
        for i, o in enumerate(sink):
            per_level[:, min(i, L - 1)] += o.to(torch.int64)
        my_offset = dist.local_offsets(offsets, group)[:-1]
        local_seed = (seeds - my_offset.view(-1, 1)).clamp(
            0, shard.labels.shape[1] - 1)
        seed_labels = torch.gather(shard.labels, 1, local_seed.long())
        zeros = torch.zeros(P, dtype=torch.float32, device=seeds.device)
        comm = {"sampling_utilized_bytes": samp_bytes,
                "feature_utilized_bytes": zeros,
                "sampler_window_overflow": per_level.sum(dim=-1),
                "sampler_window_overflow_per_level": per_level}
        return PreparedBatch(mfgs=tuple(mfgs), h_src=None,
                             seed_labels=seed_labels,
                             seed_valid=seeds >= 0,
                             hits=torch.zeros(P, dtype=torch.int64,
                                              device=seeds.device),
                             comm=comm)

    def grads_fn(params, batch: PreparedBatch):
        # repro's rule: each worker's own backward on its own slice, then
        # the mean in worker order (one backward a worker, stacked or not)
        losses, flats = [], []
        for i in range(batch.seed_labels.shape[0]):
            one = slice(i, i + 1)
            with torch.enable_grad():
                leaves = tree_map(
                    lambda p: p.detach().requires_grad_(True), params)
                with _trace.span("model/forward", cat="step",
                                 worker=first_worker + i):
                    loss_i = loss_fn(leaves, [worker_rows(m, one)
                                              for m in batch.mfgs],
                                     batch.h_src[one],
                                     batch.seed_labels[one],
                                     batch.seed_valid[one])
                with _trace.span("model/backward", cat="step",
                                 worker=first_worker + i):
                    # a conv may leave a parameter unused (gcn's w_self):
                    # its gradient is zeros, as jax.grad gives it
                    g = torch.autograd.grad(loss_i.sum(),
                                            tree_leaves(leaves),
                                            materialize_grads=True)
                    flats.append(torch.cat([x.reshape(-1) for x in g]))
            losses.append(loss_i.detach())
        with _trace.span("step/grad_mean", cat="step"):
            loss = dist.pmean_ordered(torch.cat(losses), group, "loss")
            mean = dist.pmean_ordered(torch.stack(flats), group, "grads")
            it = iter(mean.split([p.numel() for p in tree_leaves(params)]))
            grads = tree_map(lambda p: next(it).view(p.shape), params)
        return loss, grads

    def consume(params, batch: PreparedBatch, shard=None, cache=None):
        if batch.h_src is None:
            batch = fetch(shard, batch, cache)
        loss, grads = grads_fn(params, batch)
        comm = batch.comm
        n_valid = (batch.mfgs[-1].src_nodes >= 0).sum(dim=-1).clamp(min=1)
        def reduced(op, x):
            return op(x, group, "metrics")

        metrics = {
            "cache_hit_rate": reduced(
                dist.pmean_ordered, (batch.hits / n_valid).to(torch.float32)),
            "sampling_utilized_bytes": reduced(
                dist.psum_ordered, comm["sampling_utilized_bytes"]),
            "feature_utilized_bytes": reduced(
                dist.psum_ordered, comm["feature_utilized_bytes"]),
            "sampler_window_overflow": reduced(
                dist.psum_ordered, comm["sampler_window_overflow"]
            ).to(torch.float32),
            "sampler_window_overflow_per_level": reduced(
                dist.psum_ordered, comm["sampler_window_overflow_per_level"]
            ).to(torch.float32),
        }
        return loss, grads, metrics

    return prepare, fetch, consume


def make_prepare(*, offsets: torch.Tensor, num_parts: int,
                 fanouts: Sequence[int], plan=None,
                 backend: str | None = None,
                 level_fn: Callable | None = None,
                 counter: dist.RoundCounter | None = None,
                 store=None, group: dist.RankGroup | None = None,
                 scheme: str = "hybrid", graph_replicated=None,
                 vanilla_fused: bool | None = None):
    """The prepare half alone (``make_prepare_fetch_consume``'s first
    callable, features fetched): ``prepare(shard, seeds, salt, cache=None,
    staged=None) -> PreparedBatch``."""
    prepare, _, _ = make_prepare_fetch_consume(
        offsets=offsets, num_parts=num_parts, fanouts=fanouts, loss_fn=None,
        plan=plan, backend=backend, level_fn=level_fn, counter=counter,
        store=store, group=group, scheme=scheme,
        graph_replicated=graph_replicated, vanilla_fused=vanilla_fused)
    return prepare


def make_prepare_consume(*, offsets: torch.Tensor, num_parts: int,
                         fanouts: Sequence[int], loss_fn: Callable,
                         plan=None, backend: str | None = None,
                         level_fn: Callable | None = None,
                         counter: dist.RoundCounter | None = None,
                         store=None, features: bool = True,
                         group: dist.RankGroup | None = None,
                         scheme: str = "hybrid", graph_replicated=None,
                         vanilla_fused: bool | None = None):
    """The *prepare* / *consume* halves of the training step
    (``make_prepare_fetch_consume`` without the standalone fetch)."""
    prepare, _, consume = make_prepare_fetch_consume(
        offsets=offsets, num_parts=num_parts, fanouts=fanouts,
        loss_fn=loss_fn, plan=plan, backend=backend, level_fn=level_fn,
        counter=counter, store=store, features=features, group=group,
        scheme=scheme, graph_replicated=graph_replicated,
        vanilla_fused=vanilla_fused)
    return prepare, consume


def make_update_fn(*, lr: float = 1e-3, optimizer: str = "adamw",
                   grad_clip: float | None = 1.0):
    """Gradient clip + optimizer apply: ``update(params, opt_state, grads,
    metrics) -> (params, opt_state, metrics)``, with ``grad_norm`` added to
    ``metrics`` when ``grad_clip`` is set."""
    from repro_torch.optim import apply_updates, clip_by_global_norm

    def update(params, opt_state, grads, metrics):
        with _trace.span("step/update", cat="step"):
            if grad_clip is not None:
                grads, gnorm = clip_by_global_norm(grads, grad_clip)
                metrics = dict(metrics, grad_norm=gnorm)
            params, opt_state = apply_updates(params, grads, opt_state,
                                              kind=optimizer, lr=lr)
        return params, opt_state, metrics

    return update


# --------------------------------------------------------------------------
# deterministic seed stream and the drivers
# --------------------------------------------------------------------------

class SeedStream:
    """Step k's minibatch seeds and sampling salt from k alone, so any
    prefetch depth and any restart replay the same minibatches.

    ``strategy`` ``"counter"``: salt_k = base_salt + k; ``"fold"``: a
    Knuth multiplicative hash of k mixed with the base salt (neighbouring
    steps' hash streams decorrelated).  Both in Python ints, as
    ``repro`` computes them.
    """

    def __init__(self, pipeline, batch: int, strategy: str = "counter",
                 base_salt: int = 0):
        if strategy not in SEED_STREAMS:
            raise ValueError(f"unknown seed-stream strategy {strategy!r}; "
                             f"valid: {SEED_STREAMS}")
        self._pipeline = pipeline
        self.batch = int(batch)
        self.strategy = strategy
        self.base_salt = int(base_salt)

    def salt_int(self, k: int) -> int:
        """The uint32 sampling salt of step ``k``."""
        if self.strategy == "counter":
            return (self.base_salt + int(k)) % (2 ** 32)
        return ((int(k) * 2654435761) ^ (self.base_salt * 40503)) % (2 ** 32)

    def seeds_host(self, k: int) -> np.ndarray:
        """(P, batch) seed ids of step ``k`` as a host int32 array (numpy
        only, so a staging thread may call it); a fleet rank's own rows of
        the same draw (``Pipeline.seeds_host``)."""
        return self._pipeline.seeds_host(self.batch,
                                         epoch_salt=self.salt_int(k))

    def seeds(self, k: int) -> torch.Tensor:
        """(P, batch) seed ids of step ``k`` on the pipeline's device."""
        return self._pipeline.seeds(self.batch, epoch_salt=self.salt_int(k))


class _StagedDriver:
    """What both drivers share: the seed stream, the stager they consume
    (built here unless the caller passes one, which they then do not
    close) and ``reset`` / ``close``."""

    def _init_stream(self, pipeline, batch, base_salt, staging, depth):
        from repro_torch.pipeline.staging import make_stager

        spec = pipeline.spec
        self.pipeline = pipeline
        self.depth = depth
        self.stream = SeedStream(pipeline, batch,
                                 strategy=spec.prefetch.seed_stream,
                                 base_salt=base_salt)
        self.stager, self._owns_stager = make_stager(
            staging, self.stream, depth=depth, pipeline=pipeline)
        self._next = 0

    def _seeds_salt(self, k: int) -> tuple:
        if self.stager is not None:
            return self.stager.get(k)
        return self.stream.seeds(k), self.stream.salt_int(k)

    def reset(self) -> None:
        """Restart at step 0 (draining and refilling the staging ring)."""
        self._next = 0
        if self.stager is not None:
            self.stager.seek(0)

    def close(self) -> None:
        """Stop the staging thread if this driver built it (an adopted
        stager keeps running; no-op without staging)."""
        if self.stager is not None and self._owns_stager:
            self.stager.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class SyncDriver(_StagedDriver):
    """Depth-0 driver: one synchronous step program per step, with seeds
    and salt from the ``SeedStream`` (or the stager) — the same as driving
    ``Pipeline.train_step`` by hand."""

    mode = "sync"

    def __init__(self, pipeline, loss_fn, *, batch: int, lr: float = 1e-3,
                 optimizer: str = "adamw", grad_clip: float | None = 1.0,
                 base_salt: int = 0, staging=None, device=None):
        self._fn = pipeline.train_step(loss_fn, lr=lr, optimizer=optimizer,
                                       grad_clip=grad_clip, device=device)
        self._init_stream(pipeline, batch, base_salt, staging, depth=0)

    def step(self, params, opt_state, step_idx: int | None = None):
        """Run step ``step_idx`` (defaults to the next sequential index).
        Returns ``(params, opt_state, loss, metrics)``."""
        k = self._next if step_idx is None else int(step_idx)
        with _trace.span("driver/step", cat="driver", step=k,
                         mode=self.mode):
            with _trace.span("driver/seeds", cat="driver"):
                seeds, salt = self._seeds_salt(k)[:2]
            with _trace.span("driver/train_step", cat="driver"):
                out = self._fn(params, opt_state, seeds, salt)
                _trace.fence(out)
        self._next = k + 1
        return out


class DoubleBufferDriver(_StagedDriver):
    """Depth-``d`` driver: a FIFO of ``d`` prepared batches rides ahead of
    the consume half.

    ``step(k)`` hands the runner (the executor's ``bind_prefetch``) the
    inputs of step ``k + depth``, whose prepare it enqueues before the
    consume of the oldest queued batch.  The FIFO is refilled whenever
    ``k`` breaks the sequence, so a restart at any k replays the
    continuous run.  The refill uses an uncounted twin of the prepare, so
    the round counter grows by one step's rounds per step.
    """

    mode = "double_buffer"

    def __init__(self, pipeline, loss_fn, *, batch: int, lr: float = 1e-3,
                 optimizer: str = "adamw", grad_clip: float | None = 1.0,
                 base_salt: int = 0, staging=None, device=None):
        depth = pipeline.spec.prefetch.depth
        if depth < 1:
            raise ValueError(
                f"double_buffer driver needs prefetch depth >= 1 (got "
                f"{depth}); depth 0 is the 'sync' driver")
        prepare, consume = pipeline.make_prepare_consume(loss_fn,
                                                         device=device)
        prepare_warm, _ = pipeline.make_prepare_consume(
            loss_fn, counted=False, device=device)
        update = make_update_fn(lr=lr, optimizer=optimizer,
                                grad_clip=grad_clip)
        self._runner = pipeline.executor.bind_prefetch(
            pipeline, prepare, prepare_warm, consume, update)
        self._queue = None
        self._init_stream(pipeline, batch, base_salt, staging, depth=depth)

    def _warmup(self, k: int) -> None:
        self._queue = tuple(self._runner.prepare(*self._seeds_salt(k + i))
                            for i in range(self.depth))

    def step(self, params, opt_state, step_idx: int | None = None):
        """Run step ``step_idx`` (defaults to the next sequential index).
        Returns ``(params, opt_state, loss, metrics)``."""
        k = self._next if step_idx is None else int(step_idx)
        with _trace.span("driver/step", cat="driver", step=k,
                         mode=self.mode, depth=self.depth):
            if self._queue is None or k != self._next:
                with _trace.span("driver/warmup", cat="driver"):
                    self._warmup(k)
            with _trace.span("driver/seeds", cat="driver"):
                nxt = self._seeds_salt(k + self.depth)
            with _trace.span("driver/runner_step", cat="driver"):
                params, opt_state, loss, metrics, self._queue = \
                    self._runner.step(params, opt_state, self._queue, *nxt)
                _trace.fence(loss)
        self._next = k + 1
        return params, opt_state, loss, metrics

    def reset(self) -> None:
        """Drop the in-flight batches and restart at step 0."""
        self._queue = None
        super().reset()


_PREFETCHERS: dict[str, Callable] = {}


def register_prefetcher(name: str, driver_cls: Callable, *,
                        overwrite: bool = False) -> None:
    """Register a driver class: ``driver_cls(pipeline, loss_fn, *, batch,
    lr, optimizer, grad_clip, base_salt, staging, device)`` with
    ``step(params, opt_state, step_idx=None)``, ``reset()`` and
    ``close()``."""
    if not overwrite and name in _PREFETCHERS \
            and _PREFETCHERS[name] is not driver_cls:
        raise ValueError(f"prefetcher {name!r} already registered")
    _PREFETCHERS[name] = driver_cls


def available_prefetchers() -> tuple[str, ...]:
    """Sorted names of registered prefetch drivers."""
    return tuple(sorted(_PREFETCHERS))


def resolve_prefetcher(name: str) -> Callable:
    """Look up a prefetch-driver class by registry name."""
    try:
        return _PREFETCHERS[name]
    except KeyError:
        raise KeyError(f"unknown prefetcher {name!r}; "
                       f"available: {available_prefetchers()}") from None


register_prefetcher("sync", SyncDriver)
register_prefetcher("double_buffer", DoubleBufferDriver)
