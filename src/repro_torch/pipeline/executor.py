"""Executors: how the per-step program meets the pipeline's data.

Counterpart of ``repro.pipeline.executor``, a registry of executors with
one contract:

    executor.bind(pipeline, step) -> run(params, seeds, salt)
        -> (loss, grads, metrics)

  * ``"vmap"`` / ``"stacked"`` (``StackedExecutor``): all P workers on one
    device, stacked on axis 0.  ``repro``'s ``vmap`` maps a per-worker
    program over the stacked shards; the port's step programs are written
    over the stacked axis, so it calls the step once for all P workers.
  * ``"multiprocess"`` (``FleetExecutor``): one OS process per rank of a
    ``torch.distributed`` job (``repro_torch.launch.multihost``), each
    running the same step program over its own P / R workers, global
    indices ``rank * P/R ..``; only the collectives cross processes
    (``repro_torch.core.dist``).  ``repro``'s ``local_devices = devices /
    num_procs``.
  * ``"shard_map"`` (``ShardMapExecutor``): the fleet with one worker a
    rank, the torch reading of ``repro``'s one worker per device.

A pipeline binds the executor its spec names (``PipelineSpec.executor``).
For a fleet executor the pipeline is a rank's: its shards, cache and seeds
hold the rank's workers only and its step programs are built with the
rank's ``dist.RankGroup`` (``Pipeline.group``), so ``seeds`` is the rank's
(P / R, batch) rows while loss, gradients and metrics come back reduced
over all P workers, the same on every rank.  ``bind_infer``'s logits are
every worker's (P, batch, C) on every rank.  ``bind_prefetch`` is the
double-buffered mode behind ``DoubleBufferDriver`` (``repro``'s
``_AsyncDispatchRunner``).
"""
from __future__ import annotations

from typing import Callable

from repro_torch.obs import trace as _trace

_EXECUTORS: dict[str, Callable] = {}


def register_executor(name: str, factory: Callable, *,
                      overwrite: bool = False) -> None:
    """Register a zero-argument ``factory`` returning an executor under
    ``name``."""
    if not overwrite and name in _EXECUTORS \
            and _EXECUTORS[name] is not factory:
        raise ValueError(f"executor {name!r} already registered")
    _EXECUTORS[name] = factory


def available_executors() -> tuple[str, ...]:
    """Sorted names of registered executors."""
    return tuple(sorted(_EXECUTORS))


def resolve_executor(name: str):
    """Instantiate the executor registered under ``name`` (``KeyError``
    listing the available names when unknown)."""
    try:
        factory = _EXECUTORS[name]
    except KeyError:
        raise KeyError(f"unknown executor {name!r}; "
                       f"available: {available_executors()}") from None
    return factory()


def _require_full_layout(executor, layout) -> None:
    """A rank-local layout (``local_parts``) holds zero rows for the other
    ranks' partitions; only a fleet executor, whose ranks read only their
    own, may bind one."""
    if getattr(layout, "local_parts", None) is not None \
            and not executor.fleet:
        raise ValueError(
            f"executor {executor.name!r} cannot bind a rank-local "
            f"pipeline (layout.local_parts={tuple(layout.local_parts)!r}): "
            f"remote partitions' feature rows were never materialized.  "
            f"Use the 'multiprocess' or 'shard_map' executor, or build "
            f"with local_parts=None.")


class _PrefetchRunner:
    """Runs the double-buffered step: ``step`` enqueues the prepare of the
    step ``depth`` ahead, then the consume and update of the oldest queued
    batch.  Nothing between them waits for the device, so while the card
    runs the prepare the host goes on to enqueue the consume.  Everything
    runs on the caller's current stream: the model's products see the
    same stream as in the synchronous driver, which keeps their bits."""

    def __init__(self, pipeline, prepare, prepare_warm, consume, update):
        self._shards, self._cache = pipeline.shards, pipeline.cache
        self._prep, self._warm = prepare, prepare_warm
        self._cons, self._update = consume, update

    def prepare(self, seeds, salt, rows=None):
        """One prepare for the FIFO's refill (the uncounted twin)."""
        with _trace.span("prefetch/prepare", cat="prefetch"):
            nxt = self._warm(self._shards, seeds, salt, self._cache, rows)
            _trace.fence(nxt)
        return nxt

    def step(self, params, opt_state, queue, seeds, salt, rows=None):
        """Returns ``(params, opt_state, loss, metrics, queue)`` with the
        new batch appended and ``queue[0]`` consumed.  Unfenced, the spans
        time dispatch (the prepare and the consume still overlap on the
        device); a fenced tracer synchronizes inside each span, which
        gives each half its device time and takes that overlap away."""
        with _trace.span("prefetch/prepare", cat="prefetch"):
            nxt = self._prep(self._shards, seeds, salt, self._cache, rows)
            _trace.fence(nxt)
        with _trace.span("prefetch/consume", cat="prefetch"):
            loss, grads, metrics = self._cons(params, queue[0],
                                              self._shards, self._cache)
            params, opt_state, metrics = self._update(params, opt_state,
                                                      grads, metrics)
            _trace.fence(loss)
        return params, opt_state, loss, metrics, queue[1:] + (nxt,)


class StackedExecutor:
    """All P workers simulated on one device, stacked on axis 0."""

    name = "stacked"
    fleet = False

    def rank_group(self, num_parts: int):
        """The rank's ``dist.RankGroup``: ``None``, there are no ranks."""
        return None

    def check_layout(self, layout, group) -> None:
        """Refuse a layout this executor cannot bind."""
        _require_full_layout(self, layout)

    def bind(self, pipeline, step) -> Callable:
        """``run(params, seeds, salt) -> (loss, grads, metrics)`` for a
        training step (``repro_torch.pipeline.worker``) built with
        ``use_cache`` when the pipeline has a cache."""
        self.check_layout(pipeline.layout, pipeline.group)
        if pipeline.cache is None:
            def run(params, seeds, salt):
                return step(params, pipeline.shards, seeds, salt)
        else:
            def run(params, seeds, salt):
                return step(params, pipeline.shards, seeds, salt,
                            pipeline.cache)
        return run

    def bind_infer(self, pipeline, infer_step) -> Callable:
        """``run(params, seeds, salt) -> (logits, metrics)`` with ``seeds``
        and ``logits`` stacked (P, batch[, C]) — row p holds worker p's
        seeds; padded slots carry garbage the caller drops."""
        self.check_layout(pipeline.layout, pipeline.group)

        def run(params, seeds, salt):
            return infer_step(params, pipeline.shards, seeds, salt,
                              pipeline.cache)
        return run

    def bind_prefetch(self, pipeline, prepare, prepare_warm, consume,
                      update) -> _PrefetchRunner:
        """Bind the split step for double-buffered execution: ``prepare``
        / ``consume`` from ``Pipeline.make_prepare_consume`` (and
        ``prepare_warm``, the same prepare without a round counter, for
        refills), ``update`` from ``make_update_fn``."""
        self.check_layout(pipeline.layout, pipeline.group)
        return _PrefetchRunner(pipeline, prepare, prepare_warm, consume,
                               update)


class FleetExecutor(StackedExecutor):
    """One OS process per rank: the stacked step program over the rank's
    own workers, built with its ``dist.RankGroup``, so that only the
    collectives cross processes.  Every rank must have joined the process
    group first (``repro_torch.launch.multihost.init_from_env``).  ``pg``
    is the process group the fleet runs over (default: the world)."""

    name = "multiprocess"
    fleet = True

    def __init__(self, pg=None):
        self.pg = pg

    def rank_group(self, num_parts: int):
        from repro_torch.core import dist
        return dist.rank_group(num_parts, self.pg)

    def check_layout(self, layout, group) -> None:
        """``repro``'s ``_check_local_parts``: a rank-local layout must
        cover exactly the partitions of the rank's workers, or the rank
        would read never-materialized zero rows."""
        lp = layout.local_parts
        if lp is not None and tuple(lp) != group.parts:
            raise ValueError(
                f"rank-local layout covers partitions {tuple(lp)!r} but "
                f"this rank hosts workers {group.parts!r}; build with "
                f"local_parts={group.parts!r}")


class ShardMapExecutor(FleetExecutor):
    """The fleet with one worker a rank (``repro``'s one worker per
    device): the world size must equal the number of workers."""

    name = "shard_map"

    def rank_group(self, num_parts: int):
        group = super().rank_group(num_parts)
        if group.local != 1:
            raise ValueError(
                f"shard_map runs one worker a rank: {num_parts} workers "
                f"need {num_parts} ranks, the job has {group.num_procs}")
        return group


# repro's class names: VmapExecutor is its single-device simulation,
# MultiprocessExecutor its process-per-rank fleet
VmapExecutor = StackedExecutor
MultiprocessExecutor = FleetExecutor

register_executor("vmap", StackedExecutor)
register_executor("stacked", StackedExecutor)
register_executor("multiprocess", FleetExecutor)
register_executor("shard_map", ShardMapExecutor)
