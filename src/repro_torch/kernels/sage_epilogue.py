"""The dense tail of a GraphSAGE hidden layer: CUDA kernels (forward and
backward) + plain versions.

Replaces no ``repro`` kernel: ``repro`` leaves the tail to XLA, which fuses
it.  Eager PyTorch runs ``dropout(relu(s + n + b))`` as a chain of generic
elementwise kernels over the layer's (rows, H) activations and as many for
its gradient; ``csrc/sage_epilogue.cu`` is that chain in one pass each way,
and its header says what bounds the kernels and how they are laid out.  The
model's ``sage_hidden_tail`` (``models/gnn.py``) runs them between the
row-chunked products.

The plain versions are the chain itself, so on either device they give its
bits; the kernels give the card's chain's bits (the backward's but for the
sign of a dropped element's zero, and for finite upstream gradients only:
both backwards take the mask from ``out <= 0``, so a dropped element's
gradient is 0 where the chain's ``(g / (1 - p)) * 0`` is NaN for an
infinite or NaN ``g``).  Dropout: ``u`` holds the layer's
uniforms, an element is kept where ``u >= p`` and scaled by ``1 / (1 -
p)``; ``u=None`` applies none.

``sage_epilogue`` and ``sage_epilogue_backward`` run the plain version for
CPU tensors only; for CUDA tensors they launch their kernel or raise.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

MAX_WIDTH = 16384      # the backward's shared tile takes H up to this


def sage_epilogue_plain(s: torch.Tensor, n: torch.Tensor, b: torch.Tensor,
                        u: torch.Tensor | None = None,
                        p: float = 0.0) -> torch.Tensor:
    """``relu(s + n + b)``, then dropout from ``u`` at rate ``p``: s, n, u
    (rows, H), b (H,) -> (rows, H)."""
    out = torch.relu(s + n + b)
    if u is not None:
        out = out * (u >= p) / (1 - p)
    return out


def sage_epilogue_backward_plain(grad: torch.Tensor, out: torch.Tensor,
                                 p: float = 0.0,
                                 rows_pad: int | None = None):
    """Gradient of ``sage_epilogue_plain`` with respect to its sum ``s + n
    + b``, from the upstream ``grad`` and the saved output ``out`` (rows,
    H): ``(dx (rows_pad, H), db (H,))``, where dx's rows past ``rows`` are
    zero (``rows_pad`` defaults to ``rows``) and db is dx summed over its
    rows.  An element passes its gradient where its output is not <= 0:
    there relu passed it and dropout (at rate ``p``; 0 for none) kept
    it."""
    g = grad / (1 - p) if p else grad
    dx = torch.where(out <= 0, torch.zeros((), dtype=g.dtype,
                                           device=g.device), g)
    rows = dx.shape[0]
    if rows_pad is not None and rows_pad > rows:
        dx = torch.nn.functional.pad(dx, (0, 0, 0, rows_pad - rows))
    return dx, dx.sum(dim=0)


def _keep_scale(p: float) -> float:
    """The fp32 factor the card's chain scales kept elements by: PyTorch
    divides a CUDA tensor by a host scalar as a multiply by the scalar's
    fp32 reciprocal, ``1 / fp32(1 - p)`` in fp32."""
    return float(np.float32(1.0) / np.float32(1 - p))


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# C entry point: (argument types, result type)
_ENTRY_POINTS = {
    "sage_epilogue_launch": ([_P] * 4 + [_L, _I, _I, _F, _F, _P, _P], _I),
    "sage_epilogue_backward_blocks": ([_L, _I], _I),
    "sage_epilogue_backward_launch": (
        [_P, _P, _L, _L, _I, _I, _F, _P, _P, _P], _I),
}


def _lib(name: str):
    argtypes, restype = _ENTRY_POINTS[name]
    fn = getattr(_build.load("sage_epilogue"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
    return fn


def _check_cuda(name: str, *xs: torch.Tensor) -> None:
    dev = xs[0].device
    if dev.type != "cuda" or any(x.device != dev for x in xs):
        raise ValueError(f"{name}: tensors on "
                         f"{sorted({str(x.device) for x in xs})}; all must "
                         f"be on one CUDA device")
    if any(x.dtype != torch.float32 for x in xs):
        raise TypeError(f"{name} takes float32 tensors, got "
                        f"{[x.dtype for x in xs]}")
    H = xs[0].shape[-1]
    if H > MAX_WIDTH:
        raise ValueError(f"{name}: width {H}; the kernels take at most "
                         f"{MAX_WIDTH}")


def _aligned(*xs: torch.Tensor) -> bool:
    return all(x.data_ptr() % 16 == 0 for x in xs)


def sage_epilogue(s: torch.Tensor, n: torch.Tensor, b: torch.Tensor,
                  u: torch.Tensor | None = None,
                  p: float = 0.0) -> torch.Tensor:
    """The tail's forward (same contract as ``sage_epilogue_plain``); the
    CUDA kernel for CUDA tensors, the plain version for CPU ones."""
    xs = (s, n, b) if u is None else (s, n, b, u)
    if all(x.device.type == "cpu" for x in xs):
        return sage_epilogue_plain(s, n, b, u, p)
    _check_cuda("sage_epilogue", *xs)
    rows, H = s.shape
    if n.shape != s.shape or b.shape != (H,) or (
            u is not None and u.shape != s.shape):
        raise ValueError(f"sage_epilogue: s {tuple(s.shape)}, n "
                         f"{tuple(n.shape)}, b {tuple(b.shape)}, u "
                         f"{None if u is None else tuple(u.shape)}; expected "
                         f"(rows, H) and (H,)")
    s, n, b = s.contiguous(), n.contiguous(), b.contiguous()
    u = None if u is None else u.contiguous()
    out = torch.empty_like(s)
    vec = int(H % 4 == 0 and _aligned(out, *(x for x in (s, n, b, u)
                                                if x is not None)))
    with torch.cuda.device(s.device):
        err = _lib("sage_epilogue_launch")(
            s.data_ptr(), n.data_ptr(), b.data_ptr(),
            None if u is None else u.data_ptr(), rows, H, vec,
            float(np.float32(p)), _keep_scale(p), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    sage_epilogue.launches += 1
    _build.check_launch("sage_epilogue", err)
    return out


sage_epilogue.launches = 0


def sage_epilogue_backward(grad: torch.Tensor, out: torch.Tensor,
                           p: float = 0.0, rows_pad: int | None = None):
    """The tail's gradient (same contract as
    ``sage_epilogue_backward_plain``); the CUDA kernel for CUDA tensors,
    the plain version for CPU ones.  On the card db is the sum, in row
    order within each block of rows and over the blocks by one PyTorch
    reduction, of the kernel's per-block column sums."""
    if grad.device.type == "cpu" and out.device.type == "cpu":
        return sage_epilogue_backward_plain(grad, out, p, rows_pad)
    _check_cuda("sage_epilogue_backward", grad, out)
    if grad.shape != out.shape or grad.dim() != 2:
        raise ValueError(f"sage_epilogue_backward: grad "
                         f"{tuple(grad.shape)}, out {tuple(out.shape)}; "
                         f"expected both (rows, H)")
    rows, H = out.shape
    rows_pad = rows if rows_pad is None else max(int(rows_pad), rows)
    grad, out = grad.contiguous(), out.contiguous()
    dx = torch.empty((rows_pad, H), dtype=out.dtype, device=out.device)
    vec = int(H % 4 == 0 and _aligned(grad, out, dx))
    with torch.cuda.device(out.device):
        blocks = _lib("sage_epilogue_backward_blocks")(rows_pad, H)
        partial = torch.empty((blocks, H), dtype=out.dtype,
                              device=out.device)
        err = _lib("sage_epilogue_backward_launch")(
            grad.data_ptr(), out.data_ptr(), rows, rows_pad, H, vec,
            _keep_scale(p),
            dx.data_ptr(), partial.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    sage_epilogue_backward.launches += 1
    _build.check_launch("sage_epilogue_backward", err)
    return dx, partial.sum(dim=0)


sage_epilogue_backward.launches = 0
