"""Feature-row gather: CUDA kernel + plain version.

Replaces ``repro.kernels.feature_gather.feature_gather`` (Pallas body
``_gather_kernel``).  The kernel is ``csrc/feature_gather.cu``; its header
says what bounds it and how it is laid out.  It serves the local row gather
of the hybrid feature fetch (``repro_torch.core.dist.fetch_features``).

``feature_gather`` runs the plain version for CPU tensors only; for a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build


def feature_gather_plain(ids: torch.Tensor,
                         table: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with +0.0 rows for ids outside [0, M).

    ids: (..., Q) int; table: (..., M, D) with the same leading dims.
    Returns (..., Q, D).
    """
    M, D = table.shape[-2:]
    ok = (ids >= 0) & (ids < M)
    idx = torch.where(ok, ids, 0).long()
    if table.dim() == 2:
        rows = table[idx]
    else:
        tb = table.reshape(-1, M, D)
        ib = idx.reshape(tb.shape[0], -1, 1).expand(-1, -1, D)
        rows = tb.gather(1, ib).reshape(*ids.shape, D)
    return torch.where(ok[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                        device=rows.device))


def _lib():
    lib = _build.load("feature_gather")
    fn = lib.feature_gather_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
    return fn


def feature_gather(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Row gather (same contract as ``feature_gather_plain``); the CUDA
    kernel for CUDA tensors, the plain version for CPU ones."""
    if ids.device.type == "cpu" and table.device.type == "cpu":
        return feature_gather_plain(ids, table)
    if ids.device != table.device or table.device.type != "cuda":
        raise ValueError(f"feature_gather: ids on {ids.device}, table on "
                         f"{table.device}; both must be on one device")
    if ids.dtype != torch.int32 or table.dtype != torch.float32:
        raise TypeError(f"feature_gather takes int32 ids and a float32 "
                        f"table, got {ids.dtype} and {table.dtype}")
    if ids.dim() + 1 != table.dim() or ids.shape[:-1] != table.shape[:-2]:
        raise ValueError(f"feature_gather: ids {tuple(ids.shape)} and table "
                         f"{tuple(table.shape)} disagree on the leading "
                         f"(worker) dims")
    ids = ids.contiguous()
    table = table.contiguous()
    Q = ids.shape[-1]
    M, D = table.shape[-2:]
    B = math.prod(ids.shape[:-1])
    out = torch.empty((*ids.shape, D), dtype=table.dtype,
                      device=table.device)
    vec = int(D % 4 == 0 and table.data_ptr() % 16 == 0
              and out.data_ptr() % 16 == 0)
    with torch.cuda.device(table.device):
        err = _lib()(ids.data_ptr(), table.data_ptr(), B, Q, M, D, vec,
                     out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    feature_gather.launches += 1
    _build.check_launch("feature_gather", err)
    return out


feature_gather.launches = 0
