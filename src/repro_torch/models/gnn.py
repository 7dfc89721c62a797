"""GNNs over MFGs: GraphSAGE (the paper's §4 model), GCN, GAT (``repro``'s
variant and the published one) and GIN — forward, loss and accuracy.

Counterpart of ``repro.models.gnn``.  Parameters are a plain list of
per-layer dicts in ``repro``'s layout — ``{"w_self": (d_in, d_out),
"w_neigh": (d_in, d_out), "b": (d_out,)}``, plus ``attn_src`` /
``attn_dst`` (H, d_out / H) for a gat layer whose width the heads divide,
and a 0-d ``eps``, ``w_mlp`` (d_out, d_out) and ``b_mlp`` (d_out,) for gin
— so ``params_from_numpy`` carries ``repro``'s parameters across unchanged.
A gatv1 layer (no ``repro`` counterpart) holds ``w_neigh`` (d_in, H * C),
``attn_src`` / ``attn_dst`` (H, C), the conv's bias ``b_att`` (H * C, or C
where the last layer averages its heads) beside ``w_self`` and ``b``, the
skip's; C is d_out / H in a hidden layer and the classes in the last.
Layers consume MFGs bottom-up (layer 1 eats the bottom-most MFG) and every
activation may carry the leading worker axis.

The neighbour mean of sage, gcn, gin (whose sum is the mean times the
valid count) and of gat's head-indivisible last layer goes through the
``sage_aggregate`` kernels (forward and backward) on CUDA tensors.  gat's
attention is plain PyTorch: a gather, a masked softmax and the weighted
sum, whose sums over the fanout are pairwise trees of elementwise adds
(``_sum_over``), so their order depends on F alone.  Every product,
gat's per-head scores included, is ``rowwise_matmul``: fixed-shape
(``ROW_CHUNK``, d_in) row blocks.  cuBLAS picks its kernel, and with it
the reduction order, from the shape, so one product over all rows would
give a seed's logits bits that depend on how many seeds share the batch.

A sage hidden layer's tail (the two products' sum, the bias, relu and
dropout) is one ``torch.autograd.Function``, ``sage_hidden_tail``: the
products go block by block into two buffers (no cat), the rest through
the ``sage_epilogue`` kernels (forward and backward) on CUDA tensors, with
the chain's bits forward.  The last layer and the other convs keep their
tails in plain PyTorch.  A gatv1 layer projects its whole source table
once (``block_matmul``: ``rowwise_matmul``'s blocks and bits, written into
one buffer, its gradients block by block) and its attention, the
``gat_attention`` kernels on CUDA tensors, gathers each slot's row from
that table by id and writes the table's gradient.

Dropout masks come from an explicit ``torch.Generator`` (``repro`` draws
them with ``jax.random``, whose bits torch cannot reproduce); without a
generator, or with ``dropout == 0``, no dropout is applied.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.mfg import MFG
from repro_torch.kernels.gat_attention import (gat_attention,
                                               gat_attention_backward)
from repro_torch.kernels.sage_aggregate import sage_aggregate
from repro_torch.kernels.sage_epilogue import (sage_epilogue,
                                               sage_epilogue_backward)
from repro_torch.obs import trace as _trace

ROW_CHUNK = 4096


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    in_dim: int
    hidden_dim: int = 256
    num_classes: int = 47
    num_layers: int = 3
    fanouts: tuple[int, ...] = (15, 10, 5)   # (N_L, ..., N_1), top first
    dropout: float = 0.5                      # training only
    conv: str = "sage"                        # sage | gcn | gat | gatv1 | gin
    gat_heads: int = 4                        # attention heads (gat, gatv1)

    def __post_init__(self):
        if self.conv not in CONVS:
            raise ValueError(f"unknown conv {self.conv!r}; available: "
                             f"{CONVS}")
        if (self.conv == "gatv1" and self.num_layers > 1
                and self.hidden_dim % self.gat_heads):
            raise ValueError(f"gatv1's hidden width {self.hidden_dim} is "
                             f"not a multiple of its {self.gat_heads} heads")


CONVS = ("sage", "gcn", "gat", "gatv1", "gin")


def init_gnn_params(cfg: GNNConfig, generator: torch.Generator,
                    device) -> list[dict]:
    """``repro``'s parameters, shapes and scales: He-scaled normal weights
    and zero biases; gat's attention vectors normal * 0.1 where the heads
    divide the layer's width (the last layer, 47 wide, takes the mean
    instead); gin's ``eps`` 0 and a He-scaled ``w_mlp``; gatv1's
    ``w_neigh`` (d_in, H * C), its attention vectors as gat's and
    ``b_att`` zero.  Drawn on the CPU from ``generator`` (per layer:
    w_self, w_neigh, then the conv's own) and moved to ``device``."""
    dims = ([cfg.in_dim] + [cfg.hidden_dim] * (cfg.num_layers - 1)
            + [cfg.num_classes])
    params = []
    for layer in range(cfg.num_layers):
        d_in, d_out = dims[layer], dims[layer + 1]
        scale = (2.0 / d_in) ** 0.5
        last = layer == cfg.num_layers - 1
        # gatv1's heads: C = d_out / H wide, averaged in the last layer
        width = (cfg.gat_heads * d_out if last else d_out) \
            if cfg.conv == "gatv1" else d_out
        p = {"w_self": torch.randn((d_in, d_out), generator=generator)
             * scale,
             "w_neigh": torch.randn((d_in, width), generator=generator)
             * scale,
             "b": torch.zeros((d_out,))}
        if cfg.conv == "gat" and d_out % cfg.gat_heads == 0:
            shape = (cfg.gat_heads, d_out // cfg.gat_heads)
            p["attn_src"] = torch.randn(shape, generator=generator) * 0.1
            p["attn_dst"] = torch.randn(shape, generator=generator) * 0.1
        if cfg.conv == "gatv1":
            shape = (cfg.gat_heads, width // cfg.gat_heads)
            p["attn_src"] = torch.randn(shape, generator=generator) * 0.1
            p["attn_dst"] = torch.randn(shape, generator=generator) * 0.1
            p["b_att"] = torch.zeros((d_out,))
        if cfg.conv == "gin":
            p["eps"] = torch.zeros(())
            p["w_mlp"] = (torch.randn((d_out, d_out), generator=generator)
                          * (2.0 / d_out) ** 0.5)
            p["b_mlp"] = torch.zeros((d_out,))
        params.append({k: v.to(device) for k, v in p.items()})
    return params


def params_from_numpy(params_np, device) -> list[dict]:
    """``repro``'s parameter list (numpy arrays, or anything
    ``np.asarray`` takes) -> the port's, on ``device``."""
    return [{k: torch.from_numpy(np.array(v, np.float32)).to(device)
             for k, v in layer.items()} for layer in params_np]


def params_to_numpy(params) -> list[dict]:
    """The port's parameter list -> ``repro``'s layout as numpy arrays."""
    return [{k: v.detach().cpu().numpy() for k, v in layer.items()}
            for layer in params]


def _row_blocks(x2: torch.Tensor) -> list[torch.Tensor]:
    """x2 (M, K) -> its (ROW_CHUNK, K) row blocks, the last zero-padded."""
    if x2.shape[0] == 0:
        return []
    # one split, not a slice a block: the gradient of a split is one cat,
    # that of a slice a zero-filled tensor of all M rows
    *pieces, last = x2.split(ROW_CHUNK)
    tail = last.shape[0]
    if tail < ROW_CHUNK:
        last = torch.nn.functional.pad(last, (0, 0, 0, ROW_CHUNK - tail))
    return [*pieces, last]


def rowwise_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x (..., K), w (K, N), as ``torch.matmul`` over
    (ROW_CHUNK, K) row blocks, the last one zero-padded: every row goes
    through the same product shape whatever the row count, so its bits do
    not depend on the batch it shares.  The blocks are concatenated (no
    ``out=``), so autograd runs through it."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    if M == 0:
        return x2.new_zeros((*lead, w.shape[1]))
    blocks = [torch.matmul(blk, w) for blk in _row_blocks(x2)]
    blocks[-1] = blocks[-1][:M - (len(blocks) - 1) * ROW_CHUNK]
    out = blocks[0] if len(blocks) == 1 else torch.cat(blocks)
    return out.reshape(*lead, w.shape[1])


def _block_products(blocks: list[torch.Tensor],
                    w: torch.Tensor) -> torch.Tensor:
    """Each block's ``torch.matmul(block, w)``, written in place into its
    rows of one (len(blocks) * ROW_CHUNK, N) buffer: the products of
    ``rowwise_matmul`` with no cat (``out=`` takes no autograd)."""
    out = w.new_empty((len(blocks) * ROW_CHUNK, w.shape[1]))
    for i, x in enumerate(blocks):
        torch.matmul(x, w, out=out[i * ROW_CHUNK:(i + 1) * ROW_CHUNK])
    return out


class _SageHiddenTail(torch.autograd.Function):
    """``dropout(relu(rowwise_matmul(h_dst, w_self) + rowwise_matmul(agg,
    w_neigh) + b))``: the products block by block into two buffers, the
    rest one ``sage_epilogue`` pass; the backward one
    ``sage_epilogue_backward`` pass (the pre-activation gradient and the
    bias's), then per-block products for the weights (summed in block
    order) and, where asked for, the inputs."""

    @staticmethod
    def forward(ctx, h_dst, agg, w_self, w_neigh, b, u, p):
        x_self = _row_blocks(h_dst.reshape(-1, h_dst.shape[-1]))
        x_neigh = _row_blocks(agg.reshape(-1, agg.shape[-1]))
        rows = math.prod(h_dst.shape[:-1])
        ctx.p = p if u is not None else 0.0
        out = sage_epilogue(
            _block_products(x_self, w_self)[:rows],
            _block_products(x_neigh, w_neigh)[:rows], b,
            None if u is None else u.reshape(rows, w_self.shape[1]), ctx.p)
        out = out.reshape(*h_dst.shape[:-1], w_self.shape[1])
        # the padded last blocks, so that the backward need not pad again
        ctx.save_for_backward(h_dst, agg, w_self, w_neigh, out,
                              *x_self[-1:], *x_neigh[-1:])
        return out

    @staticmethod
    def backward(ctx, grad):
        h_dst, agg, w_self, w_neigh, out, *last = ctx.saved_tensors
        need = ctx.needs_input_grad
        H = out.shape[-1]
        rows = out.numel() // H
        blocks = -(-rows // ROW_CHUNK)
        dx, db = sage_epilogue_backward(
            grad.reshape(rows, H), out.reshape(rows, H), ctx.p,
            rows_pad=blocks * ROW_CHUNK)
        g = list(dx.split(ROW_CHUNK)) if blocks else []
        g_in, g_w = [None, None], [None, None]
        for k, (x, w) in enumerate(((h_dst, w_self), (agg, w_neigh))):
            if need[k]:
                g_in[k] = _block_products(g, w.t())[:rows].reshape(x.shape)
            if need[2 + k]:
                xb = list(x.reshape(-1, x.shape[-1]).split(ROW_CHUNK))
                g_w[k] = torch.zeros_like(w)
                for xi, gi in zip(xb[:-1] + last[k:k + 1], g):
                    g_w[k].addmm_(xi.t(), gi)
        return (*g_in, *g_w, db if need[4] else None, None, None)


def sage_hidden_tail(h_dst: torch.Tensor, agg: torch.Tensor, layer: dict,
                     u: torch.Tensor | None = None,
                     p: float = 0.0) -> torch.Tensor:
    """A sage hidden layer's output from its destination rows ``h_dst``
    and their neighbour means ``agg`` (..., S, D_in): ``relu(h_dst @
    w_self + agg @ w_neigh + b)`` with ``rowwise_matmul``'s row blocks
    (the same bits), then dropout where ``u`` (..., S, D_out) holds the
    uniforms (kept where ``u >= p``, scaled by ``1 / (1 - p)``).  Its
    gradients: the pre-activation's through ``sage_epilogue_backward``,
    the weights' as per-block products summed in block order."""
    return _SageHiddenTail.apply(h_dst, agg, layer["w_self"],
                                 layer["w_neigh"], layer["b"], u, p)


class _BlockProducts(torch.autograd.Function):
    """``rowwise_matmul(x, w)``'s row blocks written in place into one
    buffer (no cat); the backward: the weight's gradient as per-block
    products summed in block order and, where asked for, the input's
    block by block into one buffer."""

    @staticmethod
    def forward(ctx, x, w):
        blocks = _row_blocks(x.reshape(-1, x.shape[-1]))
        rows = math.prod(x.shape[:-1])
        # the padded last block, so that the backward need not pad again
        ctx.save_for_backward(x, w, *blocks[-1:])
        return _block_products(blocks, w)[:rows].reshape(
            *x.shape[:-1], w.shape[1])

    @staticmethod
    def backward(ctx, grad):
        x, w, *last = ctx.saved_tensors
        rows = math.prod(x.shape[:-1])
        g = _row_blocks(grad.reshape(rows, w.shape[1]))
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _block_products(g, w.t())[:rows].reshape(x.shape)
        if ctx.needs_input_grad[1]:
            xb = list(x.reshape(-1, x.shape[-1]).split(ROW_CHUNK))
            dw = torch.zeros_like(w)
            for xi, gi in zip(xb[:-1] + last, g):
                dw.addmm_(xi.t(), gi)
        return dx, dw


def block_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x (..., K), w (K, N) with ``rowwise_matmul``'s bits
    (the same (ROW_CHUNK, K) blocks), the blocks written into one buffer
    instead of concatenated; the gradients block by block (the weight's
    summed in block order)."""
    return _BlockProducts.apply(x, w)


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[..., idx, :]`` per leading index: table (..., N, D), idx
    (..., *K) in [0, N) -> (..., *K, D).  One advanced index into the
    flattened table, whose gradient CUDA accumulates by sorted index
    rather than by atomics.  gat's attention gathers with it; gatv1's
    kernels gather from their table themselves."""
    N, D = table.shape[-2:]
    lead = table.shape[:-2]
    if not lead:
        return table[idx]
    B = math.prod(lead)
    off = torch.arange(B, device=idx.device).reshape(
        *lead, *([1] * (idx.dim() - len(lead)))) * N
    return table.reshape(B * N, D)[idx + off]


def _sum_over(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum of ``x`` over ``dim`` as a pairwise tree of elementwise adds,
    zero-padded to a power of two: the order of a sum depends on the
    length of ``dim`` alone, never on the other dims (a library reduction
    picks its split from the whole shape).  Free of atomics."""
    dim = dim % x.dim()
    n = x.shape[dim]
    if n == 0:
        return x.sum(dim)
    width = 1 << (n - 1).bit_length()
    if width != n:
        pad = [0, 0] * (x.dim() - 1 - dim) + [0, width - n]
        x = torch.nn.functional.pad(x, pad)
    while width > 1:
        width //= 2
        x = x.narrow(dim, 0, width) + x.narrow(dim, width, width)
    return x.squeeze(dim)


def _per_head(attn: torch.Tensor) -> torch.Tensor:
    """(H, dh) attention vectors -> the block-diagonal (H * dh, H) matrix
    whose product with z (..., H * dh) is ``einsum("...hd,hd->...h")``."""
    H, dh = attn.shape
    eye = torch.eye(H, dtype=attn.dtype, device=attn.device)
    return (attn[:, :, None] * eye[:, None, :]).reshape(H * dh, H)


def gat_project(layer, h_src: torch.Tensor) -> tuple:
    """gat's per-source tables: ``z = h_src @ w_neigh`` (..., N, d_out)
    and, where the layer has attention, each source's per-head score ``z .
    attn_src`` (..., N, H) (else None).  Exact inference builds them once
    a layer for all its batches."""
    z = rowwise_matmul(h_src, layer["w_neigh"])
    if "attn_src" not in layer:
        return z, None
    return z, rowwise_matmul(z, _per_head(layer["attn_src"]))


def _gat_aggregate(layer, mfg: MFG, h_src: torch.Tensor,
                   h_dst: torch.Tensor, heads: int,
                   projected: tuple | None) -> torch.Tensor:
    """Masked GAT attention over the sampled edges, ``repro``'s
    ``_gat_aggregate`` on ``z = h @ w_neigh``: returns (..., S, d_out); a
    row with no valid edge is 0.  Each edge's projected source and score
    are gathered from ``projected`` (``gat_project``'s tables) when the
    caller has them (exact inference projects once a layer for all its
    batches), else projected from the gathered ``h_src`` rows: the same
    bits (a row of ``rowwise_matmul`` does not depend on the others).
    Training takes the second way: its gradient then scatters into the
    ``h_src`` rows only, and not at all in the first layer, whose sources
    are the fetched features.  Through the table, gat's training step at
    PRODUCTS widths took 2.3 to 2.6 times as long on an H100 80GB HBM3
    at 700 W, its device busy 3.3 times (``chip_smoke.py`` phase 12 times
    both)."""
    mask = mfg.edge_mask[..., None]                          # (..., S, F, 1)
    idx = mfg.edges.clamp(min=0)
    if projected is None:
        z_nb = rowwise_matmul(_rows(h_src, idx), layer["w_neigh"])
        s_nb = rowwise_matmul(z_nb, _per_head(layer["attn_src"]))
    else:
        z_nb, s_nb = _rows(projected[0], idx), _rows(projected[1], idx)
    z_dst = rowwise_matmul(h_dst, layer["w_neigh"])
    s_dst = rowwise_matmul(z_dst, _per_head(layer["attn_dst"]))
    e = torch.nn.functional.leaky_relu(s_nb + s_dst[..., None, :], 0.2)
    e = torch.where(mask, e, -1e30)                          # (..., S, F, H)
    p = torch.exp(e - e.amax(dim=-2, keepdim=True).detach())
    a = torch.where(mask, p / _sum_over(p, -2)[..., None, :], 0.0)
    z_nb = z_nb.reshape(*z_nb.shape[:-1], heads, -1)         # (..., S, F, H, dh)
    out = _sum_over(a[..., None] * z_nb, -3)                 # (..., S, H, dh)
    return out.reshape(*out.shape[:-2], -1)


class _GATAttention(torch.autograd.Function):
    """gatv1's attention (``gat_attention``'s contract, its ``out``) with
    ``gat_attention_backward`` as its gradient: the table's and the
    attention vectors'; the ids and ``keep`` take none."""

    @staticmethod
    def forward(ctx, z, edges, dst, keep, a_src, a_dst):
        out, alpha = gat_attention(z, edges, dst, keep, a_src, a_dst)
        ctx.save_for_backward(z, edges, dst, keep, a_src, a_dst, alpha)
        return out

    @staticmethod
    def backward(ctx, grad):
        dz, da_src, da_dst = gat_attention_backward(grad, *ctx.saved_tensors)
        return dz, None, None, None, da_src, da_dst


def _gatv1_layer(layer, mfg: MFG, h_src: torch.Tensor,
                 h_dst: torch.Tensor | None, cfg: GNNConfig, *,
                 is_last: bool, generator: torch.Generator | None,
                 projected: tuple | None, index: int | None) -> torch.Tensor:
    """A gatv1 layer, PyG's ``GATConv`` (self loops removed, then one
    added) plus a skip: ``attention + b_att + h_dst @ w_self + b``, the
    heads concatenated in a hidden layer (then ELU and dropout) and
    averaged in the last.  The attention reads the table ``z = h_src @
    w_neigh``: projected here once, every source row (``block_matmul``), or
    ``projected[0]`` when the caller has it (exact inference, the whole
    graph's).  Each slot's row is named by id: an edge's source, and the
    destination's own row, its position among the sources (the prefix) or
    its global id where ``h_dst`` is given; an edge whose source is its
    destination is left out, the self slot stands for it."""
    if h_dst is None:
        h_dst = h_src[..., : mfg.num_dst, :]
        self_pos = torch.arange(mfg.num_dst, device=mfg.edges.device)
    else:
        self_pos = mfg.dst_nodes
    heads = layer["attn_src"].shape[0]
    z = block_matmul(h_src, layer["w_neigh"]) if projected is None \
        else projected[0]
    keep = mfg.edge_mask & (mfg.edges != self_pos[..., None])
    dst = self_pos.to(torch.int32).expand(keep.shape[:-1])
    *lead, S, F = keep.shape
    # a tracer's span alone: the card's idle gaps here stay model/forward's
    with _trace.host_span("model/gat_attention", cat="step", layer=index,
                          edges=math.prod(lead) * S * F, heads=heads,
                          table_rows=math.prod(z.shape[:-1])):
        att = _GATAttention.apply(z, mfg.edges.to(torch.int32), dst, keep,
                                  layer["attn_src"], layer["attn_dst"])
    att = att.mean(dim=-2) if is_last else att.flatten(-2)
    out = (att + layer["b_att"] + block_matmul(h_dst, layer["w_self"])
           + layer["b"])
    if is_last:
        return out
    out = torch.nn.functional.elu(out)
    u = _dropout_uniforms(out.shape, cfg, generator, out.device)
    return out if u is None else out * (u >= cfg.dropout) / (1 - cfg.dropout)


def _dropout_uniforms(shape, cfg: GNNConfig,
                      generator: torch.Generator | None,
                      device) -> torch.Tensor | None:
    """A hidden layer's dropout uniforms for an output of ``shape`` (an
    element is kept where its uniform is >= ``cfg.dropout``), or None
    where no dropout applies: no generator, or ``cfg.dropout == 0``."""
    if generator is None or cfg.dropout <= 0:
        return None
    return torch.rand(shape, generator=generator, device=device)


def apply_layer(layer, mfg: MFG, h_src: torch.Tensor, cfg: GNNConfig, *,
                is_last: bool, generator: torch.Generator | None = None,
                aggregate: Callable = sage_aggregate,
                h_dst: torch.Tensor | None = None,
                projected: tuple | None = None,
                index: int | None = None) -> torch.Tensor:
    """One layer of ``cfg.conv``: (..., src_capacity, D_in) -> (...,
    num_dst, D_out).  ``aggregate(edges, h_src)`` is the neighbour mean
    (the kernel wrapper by default; ``sage_aggregate_plain`` for a
    plain-version forward).  ``h_dst`` holds the destination rows when
    they are not the prefix of ``h_src`` (exact inference reads its
    sources from the whole table, by global id); ``projected`` is gat's
    ``gat_project(layer, h_src)`` when the caller has it; ``index`` is the
    layer's, for gatv1's span.  Hidden layers apply dropout with masks
    drawn from ``generator`` (on the activations' device) when it is given
    and ``cfg.dropout > 0``; gatv1's take ELU before it, the others
    relu."""
    if cfg.conv == "gatv1":
        return _gatv1_layer(layer, mfg, h_src, h_dst, cfg, is_last=is_last,
                            generator=generator, projected=projected,
                            index=index)
    if h_dst is None:
        h_dst = h_src[..., : mfg.num_dst, :]      # prefix convention
    if cfg.conv == "sage":
        agg = aggregate(mfg.edges, h_src)
        if not is_last:
            u = _dropout_uniforms((*h_dst.shape[:-1], layer["b"].shape[0]),
                                  cfg, generator, h_dst.device)
            return sage_hidden_tail(h_dst, agg, layer, u, cfg.dropout)
        out = (rowwise_matmul(h_dst, layer["w_self"])
               + rowwise_matmul(agg, layer["w_neigh"]) + layer["b"])
    elif cfg.conv == "gcn":                        # aggregate incl. self
        agg = aggregate(mfg.edges, h_src)
        out = rowwise_matmul(0.5 * (h_dst + agg), layer["w_neigh"]) \
            + layer["b"]
    elif cfg.conv == "gat":
        if "attn_src" in layer:
            out = _gat_aggregate(layer, mfg, h_src, h_dst, cfg.gat_heads,
                                 projected)
        else:                                      # head-indivisible layer
            z_src = projected[0] if projected else \
                rowwise_matmul(h_src, layer["w_neigh"])
            out = aggregate(mfg.edges, z_src)
        out = out + rowwise_matmul(h_dst, layer["w_self"]) + layer["b"]
    else:                                          # gin: sum = mean * count
        agg = aggregate(mfg.edges, h_src)
        count = mfg.edge_mask.sum(dim=-1, keepdim=True).to(agg.dtype)
        pre = rowwise_matmul((1.0 + layer["eps"]) * h_dst + agg * count,
                             layer["w_neigh"]) + layer["b"]
        out = rowwise_matmul(torch.relu(pre), layer["w_mlp"]) \
            + layer["b_mlp"]
    if not is_last:
        out = torch.relu(out)
        u = _dropout_uniforms(out.shape, cfg, generator, out.device)
        if u is not None:
            out = out * (u >= cfg.dropout) / (1 - cfg.dropout)
    return out


def gnn_forward(params, mfgs: Sequence[MFG], h0: torch.Tensor,
                cfg: GNNConfig, *, generator: torch.Generator | None = None,
                aggregate: Callable = sage_aggregate) -> torch.Tensor:
    """mfgs top level first (sampler order); ``h0`` aligns with
    ``mfgs[-1].src_nodes``.  Returns logits for the top-level seeds."""
    if len(mfgs) != cfg.num_layers:
        raise ValueError(f"{len(mfgs)} MFGs for a {cfg.num_layers}-layer "
                         f"model")
    h = h0
    for layer in range(cfg.num_layers):
        mfg = mfgs[cfg.num_layers - 1 - layer]
        h = apply_layer(params[layer], mfg, h, cfg,
                        is_last=(layer == cfg.num_layers - 1),
                        generator=generator, aggregate=aggregate,
                        index=layer)
    return h


def gnn_loss(params, mfgs, h0, labels, valid, cfg: GNNConfig, *,
             generator: torch.Generator | None = None,
             aggregate: Callable = sage_aggregate) -> torch.Tensor:
    """Masked cross-entropy over the labeled seeds (eq. 3), per worker:
    ``labels``/``valid`` are (..., batch) and the result has the leading
    (worker) dims — the mean over each worker's labeled seeds."""
    logits = gnn_forward(params, mfgs, h0, cfg, generator=generator,
                         aggregate=aggregate)
    labels_ok = valid & (labels >= 0)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.clamp(min=0).long()[..., None]
                        )[..., 0]
    nll = torch.where(labels_ok, nll, torch.zeros((), dtype=nll.dtype,
                                                  device=nll.device))
    return nll.sum(dim=-1) / labels_ok.sum(dim=-1).clamp(min=1)


def gnn_accuracy(params, mfgs, h0, labels, valid,
                 cfg: GNNConfig) -> torch.Tensor:
    """Share of labeled seeds whose argmax logit is the label, per
    worker."""
    logits = gnn_forward(params, mfgs, h0, cfg)
    pred = torch.argmax(logits, dim=-1)
    ok = valid & (labels >= 0)
    correct = ok & (pred == labels)
    return correct.sum(dim=-1) / ok.sum(dim=-1).clamp(min=1)
