"""Pinned hot-row gather: CUDA kernel + plain version.

Replaces ``repro.kernels.gather.gather_rows`` (Pallas body
``_gather_kernel``, a double-buffered row DMA from the pinned table).  The
kernel is ``csrc/gather_rows.cu``; its header says what bounds it and how
it is laid out.  It serves the cache hits of the ``pinned_hot`` feature
store (``repro_torch.core.feature_store``).

The contract is ``feature_gather``'s on the stacked cache layout, but the
traffic differs: most ids are -1 (cache misses, which get zero rows) and
the table is the K-row pinned cache, not an owner's shard.

``gather_rows`` runs the plain version for CPU tensors only; for a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build


def gather_rows_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with exact +0.0 rows for ids outside [0, K)
    (``repro``'s ``gather_rows_reference``).

    table: (..., K, D); ids: (..., N) int with the same leading dims.
    Returns (..., N, D).
    """
    K, D = table.shape[-2:]
    ok = (ids >= 0) & (ids < K)
    idx = ids.clamp(0, max(K - 1, 0)).long()
    if table.dim() == 2:
        rows = table[idx]
    else:
        tb = table.reshape(-1, K, D)
        ib = idx.reshape(tb.shape[0], -1, 1).expand(-1, -1, D)
        rows = tb.gather(1, ib).reshape(*ids.shape, D)
    return torch.where(ok[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                        device=rows.device))


# repro's name of the oracle
gather_rows_reference = gather_rows_plain


def _lib():
    lib = _build.load("gather_rows")
    fn = lib.gather_rows_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
    return fn


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Pinned-row gather (same contract as ``gather_rows_plain``); the
    CUDA kernel for CUDA tensors, the plain version for CPU ones."""
    if ids.device.type == "cpu" and table.device.type == "cpu":
        return gather_rows_plain(table, ids)
    if ids.device != table.device or table.device.type != "cuda":
        raise ValueError(f"gather_rows: ids on {ids.device}, table on "
                         f"{table.device}; both must be on one device")
    if ids.dtype != torch.int32 or table.dtype != torch.float32:
        raise TypeError(f"gather_rows takes int32 ids and a float32 table, "
                        f"got {ids.dtype} and {table.dtype}")
    if ids.dim() + 1 != table.dim() or ids.shape[:-1] != table.shape[:-2]:
        raise ValueError(f"gather_rows: ids {tuple(ids.shape)} and table "
                         f"{tuple(table.shape)} disagree on the leading "
                         f"(worker) dims")
    ids = ids.contiguous()
    table = table.contiguous()
    N = ids.shape[-1]
    K, D = table.shape[-2:]
    B = math.prod(ids.shape[:-1])
    out = torch.empty((*ids.shape, D), dtype=table.dtype,
                      device=table.device)
    vec = int(D % 4 == 0 and table.data_ptr() % 16 == 0
              and out.data_ptr() % 16 == 0)
    with torch.cuda.device(table.device):
        err = _lib()(ids.data_ptr(), table.data_ptr(), B, N, K, D, vec,
                     out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    gather_rows.launches += 1
    _build.check_launch("gather_rows", err)
    return out


gather_rows.launches = 0
