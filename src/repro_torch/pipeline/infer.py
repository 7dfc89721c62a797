"""Inference-mode prepare/consume split: the serving-side step program.

Counterpart of ``repro.pipeline.infer``.  The prepare half is the training
side's (multi-level sampling + feature fetch, the part FastSample
accelerates); the consume half is a gradient-free forward:

    prepare(shard, seeds, salt, cache=None) -> PreparedBatch
    consume(params, batch) -> (logits, metrics)

``logits`` is (P, batch, C), row p for worker p's seeds: serving routes
each request to its seed's owner.  ``metrics`` are reduced over the worker
axis in index order.  Built with ``group`` (a fleet rank's
``dist.RankGroup``), prepare and the forward run over the rank's own
workers; the consume gathers every worker's logits (an all_gather, so
every rank, rank 0 included, gets all P rows) and reduces the metrics
across the ranks.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.core import dist
from repro_torch.pipeline.prefetch import PreparedBatch, make_prepare


def make_infer_prepare_consume(*, offsets: torch.Tensor, num_parts: int,
                               fanouts: Sequence[int],
                               forward_fn: Callable, plan=None,
                               backend: str | None = None,
                               level_fn: Callable | None = None,
                               counter: dist.RoundCounter | None = None,
                               group: dist.RankGroup | None = None,
                               scheme: str = "hybrid",
                               graph_replicated=None,
                               vanilla_fused: bool | None = None):
    """Build the *prepare* / *consume* halves of the inference step.

    ``forward_fn(params, mfgs, h_src) -> (P, batch, C) logits``; the other
    arguments, ``repro``'s legacy keywords among them, are as in
    ``repro_torch.pipeline.prefetch.make_prepare``, so serving runs every
    placement scheme.
    """
    prepare = make_prepare(offsets=offsets, num_parts=num_parts,
                           fanouts=fanouts, plan=plan, backend=backend,
                           level_fn=level_fn, counter=counter, group=group,
                           scheme=scheme, graph_replicated=graph_replicated,
                           vanilla_fused=vanilla_fused)

    def consume(params, batch: PreparedBatch):
        logits = dist.all_workers(
            forward_fn(params, list(batch.mfgs), batch.h_src), group)
        comm = batch.comm
        metrics = {
            "sampling_utilized_bytes": dist.psum_ordered(
                comm["sampling_utilized_bytes"], group),
            "feature_utilized_bytes": dist.psum_ordered(
                comm["feature_utilized_bytes"], group),
            "sampler_window_overflow": dist.psum_ordered(
                comm["sampler_window_overflow"], group),
        }
        return logits, metrics

    return prepare, consume


def make_infer_step(*, offsets, num_parts, fanouts, forward_fn, plan=None,
                    backend: str | None = None,
                    level_fn: Callable | None = None,
                    counter: dist.RoundCounter | None = None,
                    group: dist.RankGroup | None = None,
                    scheme: str = "hybrid", graph_replicated=None,
                    vanilla_fused: bool | None = None):
    """The composed inference program: ``step(params, shard, seeds, salt,
    cache=None) -> (logits, metrics)`` over the stacked worker axis."""
    prepare, consume = make_infer_prepare_consume(
        offsets=offsets, num_parts=num_parts, fanouts=fanouts,
        forward_fn=forward_fn, plan=plan, backend=backend,
        level_fn=level_fn, counter=counter, group=group, scheme=scheme,
        graph_replicated=graph_replicated, vanilla_fused=vanilla_fused)

    def step(params, shard, seeds, salt, cache=None):
        return consume(params, prepare(shard, seeds, salt, cache))

    return step
