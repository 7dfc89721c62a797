"""GraphSAGE masked neighbour mean: CUDA kernels (forward and backward) +
plain versions.

Replaces ``repro.kernels.sage_aggregate.sage_aggregate`` (Pallas body
``_sage_aggregate_kernel``) and the gradient XLA derives for ``repro``'s
jnp mean.  Both kernels are in ``csrc/sage_aggregate.cu``; its header says
what bounds them and how they are laid out.

``sage_aggregate`` runs the plain version (and trains through autograd)
for CPU tensors only; for CUDA tensors it is a ``torch.autograd.Function``
whose forward and backward each launch their kernel or raise.  The
backward runs only when ``h_src`` requires grad, so a layer whose input is
the fetched feature table launches none.
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


def sage_aggregate_backward_plain(edges: torch.Tensor,
                                  grad_out: torch.Tensor,
                                  num_src: int) -> torch.Tensor:
    """Gradient of ``sage_aggregate_plain(edges, h_src)`` with respect to
    ``h_src`` (N = ``num_src`` rows), by autograd: ``grad_h[n]`` sums
    ``grad_out[i] / max(count_i, 1)`` over the valid edges (i, f) naming
    n.  It does not depend on ``h_src``'s values, so a zero table stands
    in for it."""
    lead = edges.shape[:-2]
    D = grad_out.shape[-1]
    with torch.enable_grad():
        h = torch.zeros((*lead, num_src, D), dtype=grad_out.dtype,
                        device=grad_out.device, requires_grad=True)
        out = sage_aggregate_plain(edges, h)
        (grad_h,) = torch.autograd.grad(out, h, grad_out)
    return grad_h


def backward_index(edges: torch.Tensor, num_src: int):
    """The transpose the backward kernel reads, prepared once per call.

    Returns ``(rowptr (B*N + 1,) int32, slots (B*S*F,) int32, denom
    (B*S,) float32)``: the flattened (b, i, f) edge slots stably sorted
    by source row ``b * N + edges[b, i, f]`` (invalid slots last), so
    source row r's slots are ``slots[rowptr[r]:rowptr[r + 1]]`` in
    ascending (i, f) order; ``denom`` is each destination row's
    ``max(count, 1)``.  Destination row of a slot: ``slot // F``.
    """
    S, F = edges.shape[-2:]
    B = math.prod(edges.shape[:-2])
    N = int(num_src)
    dev = edges.device
    e = edges.reshape(B, S * F)
    valid = (e >= 0) & (e < N)
    base = (torch.arange(B, device=dev) * N).view(B, 1)
    key = torch.where(valid, e.long() + base, B * N).reshape(-1)
    sorted_key, order = torch.sort(key, stable=True)
    rowptr = torch.searchsorted(
        sorted_key, torch.arange(B * N + 1, device=dev)).to(torch.int32)
    denom = valid.reshape(B * S, F).sum(dim=-1).clamp(min=1).to(
        torch.float32)
    return rowptr, order.to(torch.int32), denom


def _lib(name: str):
    lib = _build.load("sage_aggregate")
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        if name == "sage_aggregate":
            fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                           + [ctypes.c_void_p] * 2)
        else:
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                           + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
    return fn


def _check_cuda(name: str, edges: torch.Tensor, x: torch.Tensor) -> None:
    if edges.device != x.device or x.device.type != "cuda":
        raise ValueError(f"{name}: edges on {edges.device}, the float input "
                         f"on {x.device}; both must be on one device")
    if edges.dtype != torch.int32 or x.dtype != torch.float32:
        raise TypeError(f"{name} takes int32 edges and float32 rows, got "
                        f"{edges.dtype} and {x.dtype}")
    if edges.dim() != x.dim() or edges.shape[:-2] != x.shape[:-2]:
        raise ValueError(f"{name}: edges {tuple(edges.shape)} and "
                         f"{tuple(x.shape)} disagree on the leading (worker) "
                         f"dims")


def sage_aggregate_backward(edges: torch.Tensor, grad_out: torch.Tensor,
                            num_src: int) -> torch.Tensor:
    """Gradient of the masked neighbour mean with respect to ``h_src``
    (same contract as ``sage_aggregate_backward_plain``); the CUDA kernel
    for CUDA tensors, the plain version for CPU ones.

    The kernel gathers in a fixed order, so its result is the same bits
    on every call; the transpose it reads (slots sorted by source row) is
    prepared here with a stable sort.
    """
    if grad_out.device.type == "cpu" and edges.device.type == "cpu":
        return sage_aggregate_backward_plain(edges, grad_out, num_src)
    _check_cuda("sage_aggregate_backward", edges, grad_out)
    if grad_out.shape[:-1] != edges.shape[:-1]:
        raise ValueError(f"sage_aggregate_backward: grad_out "
                         f"{tuple(grad_out.shape)} does not match edges "
                         f"{tuple(edges.shape)}")
    S, F = edges.shape[-2:]
    D = grad_out.shape[-1]
    B = math.prod(edges.shape[:-2])
    N = int(num_src)
    if B * S * F >= 2 ** 31 or B * N >= 2 ** 31:
        raise ValueError("sage_aggregate_backward: more than 2**31 - 1 "
                         "edge slots or source rows")
    dev = edges.device
    rowptr, slots, denom = backward_index(edges, N)
    grad_out = grad_out.contiguous()
    grad_h = torch.empty((*edges.shape[:-2], N, D), dtype=torch.float32,
                         device=dev)
    vec = int(D % 4 == 0 and grad_out.data_ptr() % 16 == 0
              and grad_h.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        err = _lib("sage_aggregate_backward")(
            rowptr.data_ptr(), slots.data_ptr(), grad_out.data_ptr(),
            denom.data_ptr(), B, N, F, D, vec, grad_h.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    sage_aggregate_backward.launches += 1
    _build.check_launch("sage_aggregate_backward", err)
    return grad_h


sage_aggregate_backward.launches = 0


class _SageAggregate(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, edges, h_src):
        ctx.save_for_backward(edges)
        ctx.num_src = h_src.shape[-2]
        return _forward(edges, h_src)

    @staticmethod
    def backward(ctx, grad_out):
        if not ctx.needs_input_grad[1]:
            return None, None
        (edges,) = ctx.saved_tensors
        return None, sage_aggregate_backward(edges, grad_out, ctx.num_src)


def sage_aggregate(edges: torch.Tensor, h_src: torch.Tensor) -> torch.Tensor:
    """Masked neighbour mean (same contract as ``sage_aggregate_plain``),
    differentiable in ``h_src``; the CUDA kernels for CUDA tensors, the
    plain version for CPU ones."""
    if h_src.device.type == "cpu" and edges.device.type == "cpu":
        return sage_aggregate_plain(edges, h_src)
    _check_cuda("sage_aggregate", edges, h_src)
    return _SageAggregate.apply(edges, h_src)


def _forward(edges: torch.Tensor, h_src: torch.Tensor) -> torch.Tensor:
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
        err = _lib("sage_aggregate")(
            edges.data_ptr(), h_src.data_ptr(), B, S, F, N, D, vec,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    sage_aggregate.launches += 1
    _build.check_launch("sage_aggregate", err)
    return out


sage_aggregate.launches = 0
