"""GraphSAGE masked neighbour mean: CUDA kernel (forward) + plain version.

Replaces ``repro.kernels.sage_aggregate.sage_aggregate`` (Pallas body
``_sage_aggregate_kernel``).  The kernel is ``csrc/sage_aggregate.cu``; its
header says what bounds it and how it is laid out.

``sage_aggregate`` runs the plain version for CPU tensors only; for a CUDA
tensor it launches the kernel or raises.  It is forward-only for now: it
refuses inputs that require grad, so nothing trains through it before its
backward kernel exists.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build


def sage_aggregate_plain(edges: torch.Tensor,
                         h_src: torch.Tensor) -> torch.Tensor:
    """Masked mean of ``h_src`` rows over each row of ``edges``.

    edges: (..., S, F) int local src ids, valid iff in [0, N).
    h_src: (..., N, D), the same leading dims.
    Returns (..., S, D); a row with no valid edge is 0 and a duplicate
    edge counts by multiplicity.
    """
    N, D = h_src.shape[-2:]
    mask = (edges >= 0) & (edges < N)
    idx = edges.clamp(0, max(N - 1, 0)).long()
    if h_src.dim() == 2:
        gathered = h_src[idx]                                  # (S, F, D)
    else:
        lead = h_src.shape[:-2]
        hb = h_src.reshape(-1, N, D)
        ib = idx.reshape(hb.shape[0], -1, 1).expand(-1, -1, D)
        gathered = hb.gather(1, ib).reshape(*lead, *idx.shape[-2:], D)
    m = mask[..., None].to(h_src.dtype)
    total = torch.sum(gathered * m, dim=-2)
    count = torch.clamp(torch.sum(m, dim=-2), min=1.0)
    return total / count


def _lib():
    lib = _build.load("sage_aggregate")
    fn = lib.sage_aggregate_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
    return fn


def sage_aggregate(edges: torch.Tensor, h_src: torch.Tensor) -> torch.Tensor:
    """Masked neighbour mean (same contract as ``sage_aggregate_plain``);
    the CUDA kernel for CUDA tensors, the plain version for CPU ones."""
    if h_src.device.type == "cpu" and edges.device.type == "cpu":
        return sage_aggregate_plain(edges, h_src)
    if edges.device != h_src.device or h_src.device.type != "cuda":
        raise ValueError(f"sage_aggregate: edges on {edges.device}, h_src "
                         f"on {h_src.device}; both must be on one device")
    if h_src.requires_grad:
        raise RuntimeError("sage_aggregate's CUDA kernel is forward-only; "
                           "its backward pass is not ported yet")
    if edges.dtype != torch.int32 or h_src.dtype != torch.float32:
        raise TypeError(f"sage_aggregate takes int32 edges and float32 "
                        f"h_src, got {edges.dtype} and {h_src.dtype}")
    if edges.dim() != h_src.dim() or edges.shape[:-2] != h_src.shape[:-2]:
        raise ValueError(f"sage_aggregate: edges {tuple(edges.shape)} and "
                         f"h_src {tuple(h_src.shape)} disagree on the "
                         f"leading (worker) dims")
    edges = edges.contiguous()
    h_src = h_src.contiguous()
    S, F = edges.shape[-2:]
    N, D = h_src.shape[-2:]
    B = math.prod(edges.shape[:-2])
    out = torch.empty((*edges.shape[:-1], D), dtype=h_src.dtype,
                      device=h_src.device)
    vec = int(D % 4 == 0 and h_src.data_ptr() % 16 == 0
              and out.data_ptr() % 16 == 0)
    with torch.cuda.device(h_src.device):
        err = _lib()(edges.data_ptr(), h_src.data_ptr(), B, S, F, N, D, vec,
                     out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    sage_aggregate.launches += 1
    _build.check_launch("sage_aggregate", err)
    return out


sage_aggregate.launches = 0
