"""Executors: how the per-step program meets the pipeline's data.

Counterpart of ``repro.pipeline.executor``.  ``repro``'s ``vmap`` executor
maps a per-worker program over the stacked shards; the port's step
programs are already written over the stacked worker axis, so its
``StackedExecutor`` binds the pipeline's shards (and cache, when it has
one) and calls the step once for all P workers.  Real multi-GPU
execution (one rank per card) is not ported yet.
"""
from __future__ import annotations

from typing import Callable


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
