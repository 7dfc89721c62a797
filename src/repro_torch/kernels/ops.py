"""The fused level backend: the ``fused_sample`` kernel as a ``level_fn``.

Counterpart of ``repro.kernels.ops.fused_sample_level``.  Registered in the
level-backend registry (``repro_torch.core.sampler``) as ``"fused_cuda"``;
``PipelineSpec.from_scheme("hybrid+fused")`` resolves to it.
"""
from __future__ import annotations

import torch

from repro_torch.core.graph import CSCGraph
from repro_torch.core.mfg import MFG
from repro_torch.core.sampler import register_backend, relabel
from repro_torch.kernels.fused_sample import MAX_DEG_WINDOW, fused_sample


def fused_sample_level(graph: CSCGraph, seeds: torch.Tensor, fanout: int,
                       salt, *, overflow_sink: list | None = None,
                       window: int = MAX_DEG_WINDOW) -> MFG:
    """Drop-in ``level_fn`` for ``sample_mfgs`` backed by the fused kernel.

    The kernel emits (samples, R); the sort-based relabel finishes the MFG.
    The kernel also counts frontier nodes whose degree exceeded its
    ``window``; callers that want that count pass ``overflow_sink``, a list
    the per-row count tensor is appended to.
    """
    samples, indptr, overflow = fused_sample(graph.indptr, graph.indices,
                                             seeds, salt, fanout=fanout,
                                             window=window)
    if overflow_sink is not None:
        overflow_sink.append(overflow)
    valid = samples >= 0
    edges, src_nodes, num_src = relabel(seeds, samples, valid)
    return MFG(dst_nodes=seeds, src_nodes=src_nodes, num_src=num_src,
               edges=edges, edge_mask=valid, indptr=indptr)


# advertises the overflow_sink keyword to the step builder, and the
# window the draw ranges over to the host replay of the sampler
# (``repro_torch.pipeline.staging``), which must draw what the card draws
fused_sample_level.supports_overflow_sink = True
fused_sample_level.window = MAX_DEG_WINDOW

register_backend("fused_cuda", fused_sample_level)
