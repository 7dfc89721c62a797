"""GAT's attention over a destination's sampled edges and itself: CUDA
kernels (forward and backward) + plain versions.

Replaces no ``repro`` kernel: ``repro``'s ``gat`` attends in jnp over the
sampled edges alone.  This is the attention of the port's ``gatv1`` conv
(the original, static GAT attention with PyG's self loop), run by
``models/gnn.py``'s ``gatv1`` layers on a table projected once a layer;
``csrc/gat_attention.cu``'s header says what bounds the kernels and how
they are laid out.

The rows the attention reads are rows of one projected table z (..., N, H
* C), named by id: destination row i (of S) reads its own row ``dst[i]``
(slot 0) and the sources of its F sampled edges ``edges[i, f]`` (slot f +
1), slot f + 1 taken where ``keep[i, f]`` (a valid edge whose source is
not i; the self slot always).  Per head h (C wide): ``e_k =
LeakyReLU(z_k . a_src + z_i . a_dst)``, ``alpha = softmax`` over the kept
slots, ``out_i = sum_k alpha_k z_k``.  Shapes: edges and keep (..., S, F),
dst (..., S), ids into their worker's rows of z (in [0, N) where kept);
a_src and a_dst (H, C); out (..., S, H, C) and the weights alpha (..., S,
F + 1, H), zero in a slot not kept, which the backward takes.  The
backward returns the table's gradient (..., N, H * C): each row the sum of
the gradients of the kept slots that name it.  In training the table is a
batch's sources and the ids local (the destinations its first S rows); in
exact inference it is the whole graph's and the ids global.  The slots'
maximum, sum and weighted sum run in slot order, in both versions.

``per_edge_attention_plain`` and ``per_edge_attention_backward_plain`` are
the same attention on rows already gathered (z_nb (rows, F, H * C), z_dst
(rows, H * C)); the plain versions of the table contract gather, then call
them.  ``gat_attention`` and ``gat_attention_backward`` run the plain
version for CPU tensors only; for CUDA tensors they launch their kernels
or raise.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sage_aggregate import sage_backward_index

SLOPE = 0.2            # LeakyReLU's negative slope (GAT's, PyG's default)
MAX_HEADS = 32         # a block holds one warp a head
SMEM_BYTES = 200_000   # the kernels' shared memory: scores and partials
CHUNK = 32             # kChunk: slots a chunk of the per-source passes


def _slots(z_nb, z_dst, keep, heads: int):
    """(z of every slot (rows, F + 1, H, C), the kept slots (rows, F +
    1)): slot 0 the destination itself."""
    rows, F, HC = z_nb.shape
    zs = torch.cat([z_dst[:, None], z_nb], 1).view(rows, F + 1, heads,
                                                   HC // heads)
    ok = torch.cat([torch.ones((rows, 1), dtype=torch.bool,
                               device=keep.device), keep], 1)
    return zs, ok


def _in_order(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over dim 1 added in slot order."""
    out = x[:, 0]
    for k in range(1, x.shape[1]):
        out = out + x[:, k]
    return out


def _scores(zs, z_dst, a_src, a_dst):
    """Each slot's pre-activation score ``s_k + t`` (rows, F + 1, H)."""
    rows, _, H, C = zs.shape
    t = (z_dst.view(rows, H, C) * a_dst).sum(-1)
    return (zs * a_src).sum(-1) + t[:, None]


def per_edge_attention_plain(z_nb: torch.Tensor, z_dst: torch.Tensor,
                             keep: torch.Tensor, a_src: torch.Tensor,
                             a_dst: torch.Tensor, slope: float = SLOPE):
    """(out (rows, H, C), alpha (rows, F + 1, H)) on gathered rows: z_nb
    (rows, F, H * C) each edge's source row, z_dst (rows, H * C) each
    destination's own, keep (rows, F)."""
    H = a_src.shape[0]
    zs, ok = _slots(z_nb, z_dst, keep, H)
    pre = _scores(zs, z_dst, a_src, a_dst)
    e = torch.where(ok[..., None],
                    torch.nn.functional.leaky_relu(pre, slope),
                    float("-inf"))
    p = torch.where(ok[..., None], torch.exp(e - e.amax(1, keepdim=True)),
                    0.0)
    alpha = p / _in_order(p)[:, None]
    return _in_order(alpha[..., None] * zs), alpha


def per_edge_attention_backward_plain(grad: torch.Tensor,
                                      z_nb: torch.Tensor,
                                      z_dst: torch.Tensor,
                                      keep: torch.Tensor,
                                      a_src: torch.Tensor,
                                      a_dst: torch.Tensor,
                                      alpha: torch.Tensor,
                                      slope: float = SLOPE):
    """Gradients of ``per_edge_attention_plain``'s ``out`` from the
    upstream ``grad`` (rows, H, C) and the forward's ``alpha``: ``(dz_nb
    (rows, F, H * C), dz_dst (rows, H * C), da_src (H, C), da_dst (H,
    C))``.  With ``da_k = grad . z_k`` and ``go = sum_k alpha_k da_k``, a
    slot's score takes ``dpre_k = alpha_k (da_k - go)`` times LeakyReLU's
    slope at its pre-activation; ``dz_k = alpha_k grad + dpre_k a_src``
    (zero where not kept) and the self slot adds ``(sum_k dpre_k)
    a_dst``."""
    rows, F, HC = z_nb.shape
    H, C = a_src.shape
    zs, ok = _slots(z_nb, z_dst, keep, H)
    g = grad.reshape(rows, H, C)
    pre = _scores(zs, z_dst, a_src, a_dst)
    da = torch.where(ok[..., None], (zs * g[:, None]).sum(-1), 0.0)
    go = _in_order(alpha * da)
    dp = torch.where(ok[..., None], alpha * (da - go[:, None])
                     * torch.where(pre > 0, 1.0, pre.new_tensor(slope)),
                     0.0)
    sum_dp = _in_order(dp)
    dz = torch.where(ok[..., None, None],
                     alpha[..., None] * g[:, None] + dp[..., None] * a_src,
                     0.0)
    dz_dst = dz[:, 0] + sum_dp[..., None] * a_dst
    return (dz[:, 1:].reshape(rows, F, HC), dz_dst.reshape(rows, HC),
            (dp[..., None] * zs).sum((0, 1)),
            (sum_dp[..., None] * z_dst.view(rows, H, C)).sum(0))


def _slot_ids(edges: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Each slot's row of the table (..., S, F + 1): the self slot's first,
    -1 where an edge is invalid."""
    return torch.cat([dst[..., None].to(edges.dtype), edges], -1)


def _flat_ids(ids: torch.Tensor, N: int) -> torch.Tensor:
    """ids (B..., *K) into each worker's N rows -> ids into the flattened
    table (B * N rows), int64."""
    B = math.prod(ids.shape[:-2])
    off = torch.arange(B, device=ids.device).view(B, 1) * N
    return (ids.reshape(B, -1).long() + off).reshape(ids.shape)


def gat_attention_plain(z: torch.Tensor, edges: torch.Tensor,
                        dst: torch.Tensor, keep: torch.Tensor,
                        a_src: torch.Tensor, a_dst: torch.Tensor,
                        slope: float = SLOPE):
    """(out (..., S, H, C), alpha (..., S, F + 1, H)) as the module
    docstring defines them: each slot's row gathered from the table, then
    ``per_edge_attention_plain``."""
    *lead, S, F = keep.shape
    N, HC = z.shape[-2:]
    H, C = a_src.shape
    rows = math.prod(lead) * S
    ids = _flat_ids(_slot_ids(edges, dst).clamp(min=0), N)
    zs = z.reshape(-1, HC)[ids].reshape(rows, F + 1, HC)
    out, alpha = per_edge_attention_plain(zs[:, 1:], zs[:, 0],
                                          keep.reshape(rows, F), a_src,
                                          a_dst, slope)
    return out.reshape(*lead, S, H, C), alpha.reshape(*lead, S, F + 1, H)


def gat_attention_backward_plain(grad: torch.Tensor, z: torch.Tensor,
                                 edges: torch.Tensor, dst: torch.Tensor,
                                 keep: torch.Tensor, a_src: torch.Tensor,
                                 a_dst: torch.Tensor, alpha: torch.Tensor,
                                 slope: float = SLOPE):
    """Gradients of ``gat_attention_plain``'s ``out`` from the upstream
    ``grad`` (..., S, H, C) and the forward's ``alpha``: ``(dz (..., N, H
    * C), da_src (H, C), da_dst (H, C))``: ``per_edge_attention_backward_
    plain``'s slot gradients, each kept slot's added into the table row it
    names."""
    *lead, S, F = keep.shape
    N, HC = z.shape[-2:]
    rows = math.prod(lead) * S
    ids = _flat_ids(_slot_ids(edges, dst).clamp(min=0), N)
    zs = z.reshape(-1, HC)[ids].reshape(rows, F + 1, HC)
    keep2 = keep.reshape(rows, F)
    dz_nb, dz_dst, da_src, da_dst = per_edge_attention_backward_plain(
        grad.reshape(rows, *a_src.shape), zs[:, 1:], zs[:, 0], keep2, a_src,
        a_dst, alpha.reshape(rows, F + 1, -1), slope)
    kept = torch.cat([torch.ones_like(keep2[:, :1]), keep2], 1)
    dzs = torch.cat([dz_dst[:, None], dz_nb], 1)
    dz = z.new_zeros((math.prod(lead) * N, HC))
    dz.index_add_(0, ids.reshape(rows, F + 1)[kept], dzs[kept])
    return dz.reshape(z.shape), da_src, da_dst


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# C entry point: (argument types, result type)
_ENTRY_POINTS = {
    "gat_attention_launch": ([_P] * 6 + [_L] * 3 + [_I] * 4 + [_F]
                             + [_P] * 3, _I),
    "gat_attention_backward_blocks": ([_L], _I),
    "gat_attention_backward_launch": ([_P] * 10 + [_L] * 4 + [_I] * 4 + [_F]
                                      + [_P] * 7, _I),
}


def _lib(name: str):
    argtypes, restype = _ENTRY_POINTS[name]
    fn = getattr(_build.load("gat_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
    return fn


def _check(name: str, floats, ints, keep, F: int, H: int, C: int):
    """Raise unless every tensor is on one CUDA device, the floats are
    float32, the ids int32 and keep bool, and the shapes fit the
    kernels."""
    xs = (*floats, *ints, keep)
    dev = xs[0].device
    if dev.type != "cuda" or any(x.device != dev for x in xs):
        raise ValueError(f"{name}: tensors on "
                         f"{sorted({str(x.device) for x in xs})}; all must "
                         f"be on one CUDA device")
    if (any(x.dtype != torch.float32 for x in floats)
            or any(x.dtype != torch.int32 for x in ints)
            or keep.dtype != torch.bool):
        raise TypeError(f"{name} takes float32 tensors, int32 ids and a "
                        f"bool keep, got {[x.dtype for x in xs]}")
    if H > MAX_HEADS or 4 * (3 * H * (F + 1) + 2 * H * C) > SMEM_BYTES:
        raise ValueError(f"{name}: {H} heads of {C} at fanout {F}; the "
                         f"kernels take at most {MAX_HEADS} heads and "
                         f"{SMEM_BYTES} bytes of scores and partials")


def _shapes(name, z, edges, dst, keep, a_src, a_dst):
    """(B, N, S, F, H, C), or raise where the shapes disagree."""
    *lead, S, F = edges.shape
    N, HC = z.shape[-2:]
    H, C = a_src.shape
    if (tuple(z.shape[:-2]) != tuple(lead) or keep.shape != edges.shape
            or tuple(dst.shape) != (*lead, S) or a_dst.shape != (H, C)
            or H * C != HC):
        raise ValueError(f"{name}: z {tuple(z.shape)}, edges "
                         f"{tuple(edges.shape)}, dst {tuple(dst.shape)}, "
                         f"keep {tuple(keep.shape)}, a_src "
                         f"{tuple(a_src.shape)}, a_dst {tuple(a_dst.shape)}; "
                         f"expected (..., N, H * C), (..., S, F), (..., S), "
                         f"(..., S, F) and (H, C)")
    B = math.prod(lead)
    if B * S * (F + 1) >= 2 ** 31 or B * N + 1 >= 2 ** 31:
        raise ValueError(f"{name}: {B * S * (F + 1)} slots, {B * N} table "
                         f"rows; the kernels' int32 ids take fewer than "
                         f"2**31 of each")
    return B, N, S, F, H, C


def _vec(C: int, *xs: torch.Tensor) -> int:
    return int(C % 4 == 0 and all(x.data_ptr() % 16 == 0 for x in xs))


def gat_attention(z: torch.Tensor, edges: torch.Tensor, dst: torch.Tensor,
                  keep: torch.Tensor, a_src: torch.Tensor,
                  a_dst: torch.Tensor, slope: float = SLOPE):
    """The attention's forward (same contract as ``gat_attention_plain``);
    the CUDA kernel for CUDA tensors, the plain version for CPU ones."""
    xs = (z, edges, dst, keep, a_src, a_dst)
    if all(x.device.type == "cpu" for x in xs):
        return gat_attention_plain(*xs, slope)
    B, N, S, F, H, C = _shapes("gat_attention", *xs)
    _check("gat_attention", (z, a_src, a_dst), (edges, dst), keep, F, H, C)
    z, edges, dst, keep, a_src, a_dst = (x.contiguous() for x in xs)
    out = torch.empty((*keep.shape[:-1], H, C), dtype=z.dtype,
                      device=z.device)
    alpha = torch.empty((*keep.shape[:-1], F + 1, H), dtype=z.dtype,
                        device=z.device)
    with torch.cuda.device(z.device):
        err = _lib("gat_attention_launch")(
            z.data_ptr(), edges.data_ptr(), dst.data_ptr(), keep.data_ptr(),
            a_src.data_ptr(), a_dst.data_ptr(), B * S, S, N, F, H, C,
            _vec(C, z, a_src, a_dst, out), float(slope), out.data_ptr(),
            alpha.data_ptr(), torch.cuda.current_stream().cuda_stream)
    gat_attention.launches += 1
    _build.check_launch("gat_attention", err)
    return out, alpha


gat_attention.launches = 0


def gat_attention_backward(grad: torch.Tensor, z: torch.Tensor,
                           edges: torch.Tensor, dst: torch.Tensor,
                           keep: torch.Tensor, a_src: torch.Tensor,
                           a_dst: torch.Tensor, alpha: torch.Tensor,
                           slope: float = SLOPE):
    """The attention's gradients (same contract as
    ``gat_attention_backward_plain``); the CUDA kernels for CUDA tensors,
    the plain version for CPU ones.  On the card the table's gradient
    gathers over the transpose ``sage_backward_index`` builds from every
    slot's id, in a fixed order (the same bits on every call); the
    attention vectors' gradients are the sum, over the per-destination
    pass's blocks by one PyTorch reduction, of each block's sum over its
    rows in row order."""
    xs = (grad, z, edges, dst, keep, a_src, a_dst, alpha)
    if all(x.device.type == "cpu" for x in xs):
        return gat_attention_backward_plain(*xs, slope)
    B, N, S, F, H, C = _shapes("gat_attention_backward", z, edges, dst, keep,
                               a_src, a_dst)
    _check("gat_attention_backward", (grad, z, a_src, a_dst, alpha),
           (edges, dst), keep, F, H, C)
    rows, K = B * S, F + 1
    if grad.numel() != rows * H * C or alpha.shape != (*keep.shape[:-1], K,
                                                       H):
        raise ValueError(f"gat_attention_backward: grad "
                         f"{tuple(grad.shape)}, alpha {tuple(alpha.shape)} "
                         f"for {rows} rows, {F} edges, {H} heads of {C}")
    grad, z, edges, dst, keep, a_src, a_dst, alpha = (x.contiguous()
                                                      for x in xs)
    dev = z.device
    rowptr, slots, _ = sage_backward_index(_slot_ids(edges, dst), N)
    dz = torch.empty_like(z)
    dpre = torch.empty((rows, K, H), dtype=z.dtype, device=dev)
    sdp = torch.empty((rows, H), dtype=z.dtype, device=dev)
    with torch.cuda.device(dev):
        blocks = _lib("gat_attention_backward_blocks")(rows)
        part = torch.empty((2, blocks, H, C), dtype=z.dtype, device=dev)
        # a partial row for each CHUNK positions of the transpose
        chunks = torch.empty((-(-rows * K // CHUNK), H * C), dtype=z.dtype,
                             device=dev)
        err = _lib("gat_attention_backward_launch")(
            grad.data_ptr(), z.data_ptr(), edges.data_ptr(), dst.data_ptr(),
            keep.data_ptr(), a_src.data_ptr(), a_dst.data_ptr(),
            alpha.data_ptr(), rowptr.data_ptr(), slots.data_ptr(), rows, S,
            N, B * N, F, H, C,
            _vec(C, grad, z, a_src, a_dst, chunks, dz), float(slope),
            dpre.data_ptr(), sdp.data_ptr(), part[0].data_ptr(),
            part[1].data_ptr(), chunks.data_ptr(), dz.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    gat_attention_backward.launches += 1
    _build.check_launch("gat_attention_backward", err)
    da = part.sum(dim=1)
    return dz, da[0], da[1]


gat_attention_backward.launches = 0
