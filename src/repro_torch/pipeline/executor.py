"""Executors: how the per-step program meets the pipeline's data.

Counterpart of ``repro.pipeline.executor``.  ``repro``'s ``vmap`` executor
maps a per-worker program over the stacked shards; the port's step
programs are already written over the stacked worker axis, so its
``StackedExecutor`` binds the pipeline's shards (and cache, when it has
one) and calls the step once for all P workers.  ``bind_prefetch`` is
the double-buffered mode behind ``DoubleBufferDriver`` (``repro``'s
``_AsyncDispatchRunner``).  Real multi-GPU execution (one rank per card)
is not ported yet.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.obs import trace as _trace


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

    def bind(self, pipeline, step) -> Callable:
        """``run(params, seeds, salt) -> (loss, grads, metrics)`` for a
        training step (``repro_torch.pipeline.worker``) built with
        ``use_cache`` when the pipeline has a cache."""
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
        return _PrefetchRunner(pipeline, prepare, prepare_warm, consume,
                               update)
