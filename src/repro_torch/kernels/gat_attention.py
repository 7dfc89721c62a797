"""GAT's attention over a destination's sampled edges and itself: CUDA
kernels (forward and backward) + plain versions.

Replaces no ``repro`` kernel: ``repro``'s ``gat`` attends in jnp over the
sampled edges alone.  This is the attention of the port's ``gatv1`` conv
(the original, static GAT attention with PyG's self loop), run by
``models/gnn.py``'s ``gatv1`` layers between the row-chunked products;
``csrc/gat_attention.cu``'s header says what bounds the kernels and how
they are laid out.

Per destination row i and head h (C wide), the slots are i itself (slot 0,
``z_dst[i]``) and its F sampled edges (slot f + 1, ``z_nb[i, f]``), slot f
+ 1 taken where ``keep[i, f]`` (a valid edge whose source is not i; the
self slot always): ``e_k = LeakyReLU(z_k . a_src + z_i . a_dst)``, ``alpha
= softmax`` over the kept slots, ``out_i = sum_k alpha_k z_k``.  Shapes:
z_nb (rows, F, H * C), z_dst (rows, H * C), keep (rows, F) bool, a_src and
a_dst (H, C); out (rows, H, C) and the weights alpha (rows, F + 1, H),
zero in a slot not kept, which the backward takes.  The slots' maximum,
sum and weighted sum run in slot order, in both versions.

``gat_attention`` and ``gat_attention_backward`` run the plain version for
CPU tensors only; for CUDA tensors they launch their kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SLOPE = 0.2            # LeakyReLU's negative slope (GAT's, PyG's default)
MAX_HEADS = 32         # a block holds one warp a head
SMEM_BYTES = 200_000   # the kernels' shared memory: scores and partials


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


def gat_attention_plain(z_nb: torch.Tensor, z_dst: torch.Tensor,
                        keep: torch.Tensor, a_src: torch.Tensor,
                        a_dst: torch.Tensor, slope: float = SLOPE):
    """(out (rows, H, C), alpha (rows, F + 1, H)) as the module docstring
    defines them."""
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


def gat_attention_backward_plain(grad: torch.Tensor, z_nb: torch.Tensor,
                                 z_dst: torch.Tensor, keep: torch.Tensor,
                                 a_src: torch.Tensor, a_dst: torch.Tensor,
                                 alpha: torch.Tensor, slope: float = SLOPE):
    """Gradients of ``gat_attention_plain``'s ``out`` from the upstream
    ``grad`` (rows, H, C) and the forward's ``alpha``: ``(dz_nb (rows, F,
    H * C), dz_dst (rows, H * C), da_src (H, C), da_dst (H, C))``.  With
    ``da_k = grad . z_k`` and ``go = sum_k alpha_k da_k``, a slot's score
    takes ``dpre_k = alpha_k (da_k - go)`` times LeakyReLU's slope at its
    pre-activation; ``dz_k = alpha_k grad + dpre_k a_src`` (zero where not
    kept) and the self slot adds ``(sum_k dpre_k) a_dst``."""
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


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# C entry point: (argument types, result type)
_ENTRY_POINTS = {
    "gat_attention_launch": ([_P] * 5 + [_L, _I, _I, _I, _I, _F, _P, _P,
                                         _P], _I),
    "gat_attention_backward_blocks": ([_L], _I),
    "gat_attention_backward_launch": ([_P] * 7 + [_L, _I, _I, _I, _I, _F]
                                      + [_P] * 5, _I),
}


def _lib(name: str):
    argtypes, restype = _ENTRY_POINTS[name]
    fn = getattr(_build.load("gat_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
    return fn


def _check(name: str, floats, keep, F: int, H: int, C: int):
    """Raise unless every tensor is on one CUDA device, the floats are
    float32 and keep bool, and the shapes fit the kernels."""
    xs = (*floats, keep)
    dev = xs[0].device
    if dev.type != "cuda" or any(x.device != dev for x in xs):
        raise ValueError(f"{name}: tensors on "
                         f"{sorted({str(x.device) for x in xs})}; all must "
                         f"be on one CUDA device")
    if any(x.dtype != torch.float32 for x in floats) \
            or keep.dtype != torch.bool:
        raise TypeError(f"{name} takes float32 tensors and a bool keep, "
                        f"got {[x.dtype for x in xs]}")
    if H > MAX_HEADS or 4 * (3 * H * (F + 1) + 2 * H * C) > SMEM_BYTES:
        raise ValueError(f"{name}: {H} heads of {C} at fanout {F}; the "
                         f"kernels take at most {MAX_HEADS} heads and "
                         f"{SMEM_BYTES} bytes of scores and partials")


def _shapes(name, z_nb, z_dst, keep, a_src, a_dst):
    rows, F, HC = z_nb.shape
    H, C = a_src.shape
    if (z_dst.shape != (rows, HC) or keep.shape != (rows, F)
            or a_dst.shape != (H, C) or H * C != HC):
        raise ValueError(f"{name}: z_nb {tuple(z_nb.shape)}, z_dst "
                         f"{tuple(z_dst.shape)}, keep {tuple(keep.shape)}, "
                         f"a_src {tuple(a_src.shape)}, a_dst "
                         f"{tuple(a_dst.shape)}; expected (rows, F, H * C), "
                         f"(rows, H * C), (rows, F) and (H, C)")
    return rows, F, H, C


def _vec(C: int, *xs: torch.Tensor) -> int:
    return int(C % 4 == 0 and all(x.data_ptr() % 16 == 0 for x in xs))


def gat_attention(z_nb: torch.Tensor, z_dst: torch.Tensor,
                  keep: torch.Tensor, a_src: torch.Tensor,
                  a_dst: torch.Tensor, slope: float = SLOPE):
    """The attention's forward (same contract as ``gat_attention_plain``);
    the CUDA kernel for CUDA tensors, the plain version for CPU ones."""
    xs = (z_nb, z_dst, keep, a_src, a_dst)
    if all(x.device.type == "cpu" for x in xs):
        return gat_attention_plain(*xs, slope)
    rows, F, H, C = _shapes("gat_attention", *xs)
    _check("gat_attention", (z_nb, z_dst, a_src, a_dst), keep, F, H, C)
    z_nb, z_dst, keep, a_src, a_dst = (x.contiguous() for x in xs)
    out = torch.empty((rows, H, C), dtype=z_nb.dtype, device=z_nb.device)
    alpha = torch.empty((rows, F + 1, H), dtype=z_nb.dtype,
                        device=z_nb.device)
    with torch.cuda.device(z_nb.device):
        err = _lib("gat_attention_launch")(
            z_nb.data_ptr(), z_dst.data_ptr(), keep.data_ptr(),
            a_src.data_ptr(), a_dst.data_ptr(), rows, F, H, C,
            _vec(C, z_nb, z_dst, a_src, a_dst, out), float(slope),
            out.data_ptr(), alpha.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    gat_attention.launches += 1
    _build.check_launch("gat_attention", err)
    return out, alpha


gat_attention.launches = 0


def gat_attention_backward(grad: torch.Tensor, z_nb: torch.Tensor,
                           z_dst: torch.Tensor, keep: torch.Tensor,
                           a_src: torch.Tensor, a_dst: torch.Tensor,
                           alpha: torch.Tensor, slope: float = SLOPE):
    """The attention's gradients (same contract as
    ``gat_attention_backward_plain``); the CUDA kernel for CUDA tensors,
    the plain version for CPU ones.  On the card the attention vectors'
    gradients are the sum, over the kernel's blocks by one PyTorch
    reduction, of each block's sum over its rows in row order."""
    xs = (grad, z_nb, z_dst, keep, a_src, a_dst, alpha)
    if all(x.device.type == "cpu" for x in xs):
        return gat_attention_backward_plain(*xs, slope)
    rows, F, H, C = _shapes("gat_attention_backward", z_nb, z_dst, keep,
                            a_src, a_dst)
    _check("gat_attention_backward", (grad, z_nb, z_dst, a_src, a_dst,
                                      alpha), keep, F, H, C)
    if grad.numel() != rows * H * C or alpha.shape != (rows, F + 1, H):
        raise ValueError(f"gat_attention_backward: grad "
                         f"{tuple(grad.shape)}, alpha {tuple(alpha.shape)} "
                         f"for {rows} rows, {F} edges, {H} heads of {C}")
    grad, z_nb, z_dst, keep, a_src, a_dst, alpha = (x.contiguous()
                                                    for x in xs)
    dz_nb, dz_dst = torch.empty_like(z_nb), torch.empty_like(z_dst)
    with torch.cuda.device(z_nb.device):
        blocks = _lib("gat_attention_backward_blocks")(rows)
        part = torch.empty((2, blocks, H, C), dtype=z_nb.dtype,
                           device=z_nb.device)
        err = _lib("gat_attention_backward_launch")(
            grad.data_ptr(), z_nb.data_ptr(), z_dst.data_ptr(),
            keep.data_ptr(), a_src.data_ptr(), a_dst.data_ptr(),
            alpha.data_ptr(), rows, F, H, C,
            _vec(C, grad, z_nb, z_dst, a_src, a_dst, dz_nb, dz_dst),
            float(slope), dz_nb.data_ptr(), dz_dst.data_ptr(),
            part[0].data_ptr(), part[1].data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    gat_attention_backward.launches += 1
    _build.check_launch("gat_attention_backward", err)
    da = part.sum(dim=1)
    return dz_nb, dz_dst, da[0], da[1]


gat_attention_backward.launches = 0
