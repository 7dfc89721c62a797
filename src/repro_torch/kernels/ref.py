"""Oracles for the kernels (counterpart of ``repro.kernels.ref``).

The sampling oracles are built from the sampler alone: they share no code
path with ``fused_sample_plain`` beyond the column draw, and the windowed
oracle truncates the graph itself and reruns the unwindowed sampler.
``ref_feature_gather`` and ``ref_mean_aggregate`` are ``repro``'s names
of the gather's and the aggregate's plain versions.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import CSCGraph
from repro_torch.core.sampler import build_indptr, sample_neighbors
from repro_torch.kernels.feature_gather import feature_gather_plain
from repro_torch.kernels.sage_aggregate import sage_aggregate_plain

ref_feature_gather = feature_gather_plain
ref_mean_aggregate = sage_aggregate_plain


def ref_fused_sample(graph: CSCGraph, seeds: torch.Tensor, fanout: int,
                     salt) -> tuple[torch.Tensor, torch.Tensor]:
    """(samples (..., S, F) int32, R (..., S + 1) int32) of Algorithm 1."""
    samples, valid = sample_neighbors(graph, seeds, fanout, salt)
    return samples, build_indptr(valid)


def ref_windowed_fused_sample(graph: CSCGraph, seeds: torch.Tensor,
                              fanout: int, salt, window: int):
    """Window-clamped oracle: every neighbour list truncated to its first
    ``window`` entries, then the exact reference draw.  Also returns the
    expected overflow count (seeds with degree > window)."""
    indptr, indices = graph.numpy()
    deg = np.diff(indptr)
    wdeg = np.minimum(deg, window)
    windptr = np.zeros_like(indptr)
    np.cumsum(wdeg, out=windptr[1:])
    pos_in_row = np.arange(indices.size) - np.repeat(indptr[:-1], deg)
    windices = indices[pos_in_row < np.repeat(wdeg, deg)]
    truncated = CSCGraph(indptr=torch.from_numpy(windptr.astype(np.int32)),
                         indices=torch.from_numpy(
                             windices.astype(np.int32))).to(seeds.device)
    samples, r = ref_fused_sample(truncated, seeds, fanout, salt)
    s_np = seeds.cpu().numpy()
    overflow = int((deg[s_np[s_np >= 0]] > window).sum())
    return samples, r, overflow
