"""The kernels at ``repro``'s MFG-level signatures, and the fused level
backend.

Counterpart of ``repro.kernels.ops``.  ``fused_sample``, ``sage_aggregate``
and ``feature_gather`` take a graph or an MFG where the wrappers
(``repro_torch.kernels.{fused_sample,sage_aggregate,feature_gather}``)
take tensors, and call those wrappers: for a CUDA tensor they launch the
hand-written kernel or raise, for a CPU tensor they run its plain version.
``repro``'s Pallas tile arguments have no counterpart.

``fused_sample_level`` is the ``fused_sample`` kernel as a ``level_fn``,
registered in the level-backend registry (``repro_torch.core.sampler``)
as ``"fused_cuda"``; ``PipelineSpec.from_scheme("hybrid+fused")``
resolves to it.
"""
from __future__ import annotations

import torch

from repro_torch.core.graph import CSCGraph
from repro_torch.core.mfg import MFG
from repro_torch.core.sampler import register_backend, relabel
from repro_torch.kernels import feature_gather as _fg
from repro_torch.kernels import sage_aggregate as _agg
from repro_torch.kernels.fused_sample import MAX_DEG_WINDOW
from repro_torch.kernels.fused_sample import fused_sample as _fused_sample


def fused_sample(graph: CSCGraph, seeds: torch.Tensor, fanout: int, salt,
                 window: int = MAX_DEG_WINDOW):
    """Kernel-backed neighbour sampling emitting CSC directly (Algorithm
    1).  Returns ``(samples, R, overflow_count)``; ``overflow_count``
    counts the seeds whose degree exceeded ``window`` (their draws cover
    the first ``window`` neighbours only)."""
    return _fused_sample(graph.indptr, graph.indices, seeds, salt,
                         fanout=fanout, window=window)


def fused_sample_level(graph: CSCGraph, seeds: torch.Tensor, fanout: int,
                       salt, *, overflow_sink: list | None = None,
                       window: int = MAX_DEG_WINDOW) -> MFG:
    """Drop-in ``level_fn`` for ``sample_mfgs`` backed by the fused kernel.

    The kernel emits (samples, R); the sort-based relabel finishes the MFG.
    The kernel also counts frontier nodes whose degree exceeded its
    ``window``; callers that want that count pass ``overflow_sink``, a list
    the per-row count tensor is appended to.
    """
    samples, indptr, overflow = fused_sample(graph, seeds, fanout, salt,
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


def sage_aggregate(mfg: MFG, h_src: torch.Tensor) -> torch.Tensor:
    """Kernel-backed masked neighbour mean over ``mfg.edges`` (the
    contract of ``repro_torch.core.mfg.mean_aggregate``)."""
    return _agg.sage_aggregate(mfg.edges, h_src)


def feature_gather(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Kernel-backed row gather (the hybrid feature fetch's owner-side
    payload): ``table[ids]``, +0.0 rows for ids outside the table."""
    return _fg.feature_gather(ids, table)
