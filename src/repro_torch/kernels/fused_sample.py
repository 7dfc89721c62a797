"""Fused neighbour sampling (Algorithm 1, one level): CUDA kernel + plain
version.

Replaces ``repro.kernels.fused_sample.fused_sample`` (Pallas body
``_fused_sample_kernel``).  The kernel is ``csrc/fused_sample.cu``; its
header says what bounds it and how it is laid out.  It writes the samples
and the row pointer in one launch (a single-pass scan with decoupled
look-back, ``csrc/scan.cuh``); the wrapper allocates the scan's zeroed
scratch, which also holds the overflow counts (``kernels/scan.py``).

Per seed ``v`` it draws ``fanout`` in-neighbours with
``SplitMix32(v * 2654435761 + slot, salt) % min(deg, window)`` (all of them
when ``min(deg, window) <= fanout``), writes the CSC row pointer ``R`` as a
running total of valid counts, and counts seeds with ``deg > window``.  The
``window`` (default 2048) is the TPU kernel's VMEM window, kept so results
match ``repro``'s kernel and its windowed oracle bit for bit.

``fused_sample`` runs the plain version for CPU tensors only; for a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.sampler import _gather_indices, draw_columns
from repro_torch.kernels import _build
from repro_torch.kernels.scan import THREADS, scan_scratch, scan_tiles

MAX_DEG_WINDOW = 2048
# seeds per scan tile: 1 per thread for small levels (more blocks, fewer
# serial draw rounds each), 4 per thread past LARGE_LEVEL seeds (4x fewer
# tiles, so the look-back walks 4x fewer of them); results do not depend
# on the choice
SMALL_TILE = THREADS
LARGE_TILE = 4 * THREADS
LARGE_LEVEL = 2 ** 17


def seeds_per_tile(num_seeds: int) -> int:
    """Seeds per scan tile for a level of ``num_seeds`` = B * S seeds."""
    return LARGE_TILE if num_seeds > LARGE_LEVEL else SMALL_TILE


def fused_sample_plain(indptr: torch.Tensor, indices: torch.Tensor,
                       seeds: torch.Tensor, salt, *, fanout: int,
                       window: int = MAX_DEG_WINDOW):
    """Plain PyTorch version of the kernel, on any device.

    seeds: (..., S) int32, -1 = padding.  Returns (samples (..., S, fanout)
    int32 [-1 invalid], R (..., S + 1) int32, overflow (...) int32).
    """
    ok = seeds >= 0
    v = seeds.clamp(min=0).long()
    start = indptr[v].long()
    deg = torch.where(ok, indptr[v + 1].long() - start, 0)
    col, valid = draw_columns(v, deg.clamp(max=window), fanout, salt)
    valid = valid & ok[..., None]
    samples = _gather_indices(indices, start[..., None] + col)
    samples = torch.where(valid, samples, -1).to(torch.int32)
    counts = valid.sum(dim=-1, dtype=torch.int32)
    zero = torch.zeros((*counts.shape[:-1], 1), dtype=torch.int32,
                       device=seeds.device)
    R = torch.cat([zero, torch.cumsum(counts, -1, dtype=torch.int32)], -1)
    overflow = (ok & (deg > window)).sum(dim=-1, dtype=torch.int32)
    return samples, R, overflow


def _lib():
    lib = _build.load("fused_sample")
    fn = lib.fused_sample_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                       + [ctypes.c_uint32] + [ctypes.c_void_p] * 5)
        fn.restype = ctypes.c_int
    return fn


def fused_sample(indptr: torch.Tensor, indices: torch.Tensor,
                 seeds: torch.Tensor, salt, *, fanout: int,
                 window: int = MAX_DEG_WINDOW):
    """Sample ``fanout`` in-neighbours per seed, emitting CSC directly
    (same contract as ``fused_sample_plain``).  ``seeds`` is (S,) or
    (B, S), one row per worker; the kernel takes all rows in one launch,
    with one ``R`` and one overflow count per row."""
    if seeds.device.type == "cpu" and indptr.device.type == "cpu":
        return fused_sample_plain(indptr, indices, seeds, salt,
                                  fanout=fanout, window=window)
    if seeds.dim() not in (1, 2) or fanout < 1 or window < 1:
        raise ValueError(f"fused_sample: seeds must be (S,) or (B, S) and "
                         f"fanout, window >= 1; got {tuple(seeds.shape)}, "
                         f"{fanout}, {window}")
    if seeds.numel() * fanout >= 2 ** 31:
        raise ValueError(f"fused_sample: B * S * fanout = "
                         f"{seeds.numel() * fanout} samples, the kernel's "
                         f"int32 offsets take fewer than 2**31")
    dev = seeds.device
    if dev.type != "cuda" or indptr.device != dev or indices.device != dev:
        raise ValueError("fused_sample: indptr, indices and seeds must lie "
                         "on one CUDA device")
    for name, t in (("indptr", indptr), ("indices", indices),
                    ("seeds", seeds)):
        if t.dtype != torch.int32:
            raise TypeError(f"fused_sample takes int32 {name}, got "
                            f"{t.dtype}")
    indptr = indptr.contiguous()
    indices = indices.contiguous()
    seeds2 = (seeds if seeds.dim() == 2 else seeds[None]).contiguous()
    B, S = seeds2.shape
    tile = seeds_per_tile(B * S)
    tiles = scan_tiles(S, tile)
    samples = torch.empty((B, S, fanout), dtype=torch.int32, device=dev)
    R = torch.empty((B, S + 1), dtype=torch.int32, device=dev)
    scratch, overflow = scan_scratch(B * tiles, B, dev)
    with torch.cuda.device(dev):
        err = _lib()(indptr.data_ptr(), indices.data_ptr(), seeds2.data_ptr(),
                     B, S, tile, tiles, fanout, window,
                     int(salt) & 0xFFFFFFFF,
                     samples.data_ptr(), R.data_ptr(), overflow.data_ptr(),
                     scratch.data_ptr(),
                     torch.cuda.current_stream().cuda_stream)
    fused_sample.launches += 1
    _build.check_launch("fused_sample", err)
    if seeds.dim() == 1:
        return samples[0], R[0], overflow[0]
    return samples, R, overflow


fused_sample.launches = 0
