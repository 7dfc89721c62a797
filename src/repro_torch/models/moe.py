"""Mixture-of-Experts FFN with top-k routing and sort-based dispatch
(counterpart of ``repro.models.moe``).

Tokens are routed to (expert, slot) positions by a stable argsort over
their expert assignments, then the expert FFNs run as one batched einsum
over the (E, C, d) buffer.  Static capacity C = ``moe_capacity``; overflow
tokens are dropped (their gate contribution is zero), the standard
GShard/Switch discipline, with the same drops as ``repro``'s.

On DTensors (``repro_torch.models.spmd``) the dispatch is data-dependent
(argsort, searchsorted, a scatter), and DTensor has no sharding strategy
for those ops: the routing and the tokens are replicated and each rank
runs the dispatch and the combine whole, as GSPMD lowers ``repro``'s
dispatch, while the expert FFNs run on the experts' shards.
``moe_shard_constraints`` pins the dispatch buffer and the expert output
to the experts' layout, as ``repro``'s ``with_sharding_constraint`` does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.models import spmd
from repro_torch.models.layers import (dense_init, dtype_of, gelu,
                                       init_device)


def moe_capacity(cfg: ModelConfig, num_tokens: int) -> int:
    c = int(cfg.capacity_factor * num_tokens * cfg.top_k
            // max(cfg.num_experts, 1)) + 1
    return max(c, cfg.top_k)


def init_moe(generator, cfg: ModelConfig, *, lead=(), device=None):
    dt = dtype_of(cfg.param_dtype)
    device = init_device(generator, device)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    kw = dict(lead=lead, device=device)
    # experts (E, d_in, d_out), each scaled by 1/sqrt(d_in)
    p = {"router": dense_init(generator, d, E, torch.float32, **kw),
         "w1": dense_init(generator, d, f, dt, lead=(*lead, E),
                          device=device),
         "w2": dense_init(generator, f, d, dt, lead=(*lead, E),
                          device=device)}
    if cfg.act == "swiglu":
        p["w3"] = dense_init(generator, d, f, dt, lead=(*lead, E),
                             device=device)
    return p


def _route(logits, E: int, k: int):
    """Router softmax, top-k gates renormalized, Switch aux loss."""
    gates_full = torch.softmax(logits, dim=-1)
    top_g, top_e = torch.topk(gates_full, k, dim=-1)
    top_g = top_g / torch.clamp(top_g.sum(-1, keepdim=True), min=1e-9)
    # load-balance auxiliary loss (Switch): E * sum_e f_e * P_e
    lead = tuple(range(gates_full.ndim - 1))
    me = gates_full.mean(lead)
    ce = F.one_hot(top_e, E).to(torch.float32).sum(-2).mean(lead)
    aux = E * (me * ce).sum() / k
    return top_g, top_e, aux


def dispatch(top_e, E: int, C: int):
    """Sort-based dispatch of one group: top_e (T, k) expert ids ->
    (se, st, slot, keep, order), each over the T*k assignments in stable
    expert order: the expert, the token, its slot in the expert's buffer,
    whether the slot is within capacity ``C``, and the permutation of the
    flat (token-major) assignments."""
    T, k = top_e.shape
    flat_e = top_e.reshape(-1)
    flat_t = torch.arange(T, device=top_e.device).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    se, st = flat_e[order], flat_t[order]
    seg_start = torch.searchsorted(se, torch.arange(E, device=se.device))
    slot = torch.arange(T * k, device=se.device) - seg_start[se]
    keep = slot < C
    return se, st, slot, keep, order


def _experts(p, buf, cfg, eq_in: str, eq_out: str):
    h = torch.einsum(eq_in, buf, p["w1"])
    if cfg.act == "swiglu":
        h = F.silu(h) * torch.einsum(eq_in, buf, p["w3"])
    else:
        h = gelu(h)
    return torch.einsum(eq_out, h, p["w2"])


def _scatter(xf, se, st, slot, keep, E: int, C: int):
    """The (E, C, d) buffer; dropped assignments go to slot ``C`` of a
    (E, C + 1, d) buffer, which is cut off."""
    buf = xf.new_zeros((E, C + 1, xf.shape[-1]))
    buf = buf.index_put((se, torch.where(keep, slot, C)), xf[st])
    return buf[:, :C]


def _combine(out, se, st, sg, slot, keep, T: int, dtype):
    tok_out = out[se, torch.where(keep, slot, 0)]            # (T*k, d)
    w = torch.where(keep, sg, 0.0).to(dtype)[:, None]
    return out.new_zeros((T, out.shape[-1]), dtype=dtype).index_add(
        0, st, tok_out * w)


def apply_moe(p, x, cfg: ModelConfig):
    """x (B, S, d) -> (y (B, S, d), aux_loss scalar)."""
    if cfg.moe_num_groups:
        return apply_moe_grouped(p, x, cfg)
    B, S, d = x.shape
    T = B * S
    E, k = cfg.num_experts, cfg.top_k
    C = moe_capacity(cfg, T)
    xf = x.reshape(T, d)

    logits = xf.to(torch.float32) @ p["router"]                 # (T, E)
    top_g, top_e, aux = _route(logits, E, k)

    # on DTensors: the dispatch and the combine run replicated, as plain
    # tensors (no sharding strategy for argsort / searchsorted / index_put)
    top_e, mesh = spmd.to_plain(top_e)
    top_g, _ = spmd.to_plain(top_g)
    xp, _ = spmd.to_plain(xf)
    se, st, slot, keep, order = dispatch(top_e, E, C)
    sg = top_g.reshape(-1)[order]
    buf = spmd.from_plain(_scatter(xp, se, st, slot, keep, E, C), mesh)
    buf = _pin_experts(buf, cfg)                                # (E, C, d)
    out = _experts(p, buf, cfg, "ecd,edf->ecf", "ecf,efd->ecd")
    out, _ = spmd.to_plain(_pin_experts(out, cfg))
    y = _combine(out, se, st, sg, slot, keep, T, x.dtype)
    return spmd.from_plain(y, mesh, like=xf).reshape(B, S, d), aux


def _pin_experts(t, cfg: ModelConfig):
    """``moe_shard_constraints``: pin a DTensor (..., E, C, d) to the
    experts' layout (experts -> 'data' when E divides 16, else d_model ->
    'data'), ``repro``'s constraint; the identity otherwise."""
    if not cfg.moe_shard_constraints or not spmd.is_dtensor(t):
        return t
    e_axis = "data" if cfg.num_experts % 16 == 0 else None
    d_axis = None if e_axis else "data"
    lead = (None,) * (t.ndim - 3)
    return spmd.constrain(t, (*lead, e_axis, None, d_axis))


def apply_moe_grouped(p, x, cfg: ModelConfig):
    """GShard-style group-local dispatch: tokens split into
    ``moe_num_groups`` groups, each sorted and packed against its own
    capacity.  The same routing as the flat path up to per-group (instead
    of global) capacity truncation."""
    B, S, d = x.shape
    T = B * S
    E, k = cfg.num_experts, cfg.top_k
    G = cfg.moe_num_groups
    if T % G:
        raise ValueError(f"{T} tokens do not split into {G} groups")
    Tg = T // G
    Cg = max(int(cfg.capacity_factor * Tg * k // max(E, 1)) + 1, k)

    xg = x.reshape(G, Tg, d)
    logits = xg.to(torch.float32) @ p["router"]                 # (G, Tg, E)
    top_g, top_e, aux = _route(logits, E, k)

    # on DTensors: replicated plain dispatch and combine, as in apply_moe
    top_e, mesh = spmd.to_plain(top_e)
    top_g, _ = spmd.to_plain(top_g)
    xp, _ = spmd.to_plain(xg)
    metas, bufs = [], []
    for g in range(G):
        se, st, slot, keep, order = dispatch(top_e[g], E, Cg)
        metas.append((se, st, top_g[g].reshape(-1)[order], slot, keep))
        bufs.append(_scatter(xp[g], se, st, slot, keep, E, Cg))
    buf = _pin_experts(spmd.from_plain(torch.stack(bufs), mesh), cfg)
    out = _experts(p, buf, cfg, "gecd,edf->gecf", "gecf,efd->gecd")
    out, _ = spmd.to_plain(_pin_experts(out, cfg))              # (G,E,Cg,d)
    y = torch.stack([_combine(out[g], *metas[g], Tg, out.dtype)
                     for g in range(G)])
    y = spmd.from_plain(y, mesh, like=xg)
    return y.reshape(B, S, d).to(x.dtype), aux
