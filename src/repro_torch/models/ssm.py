"""Mamba2 (SSD — state-space duality) blocks [arXiv:2405.21060]
(counterpart of ``repro.models.ssm``).

Training/prefill uses the chunked SSD algorithm: intra-chunk "attention-like"
quadratic term + inter-chunk linear recurrence over per-chunk states (a
sequential loop over chunks — S/chunk steps, O(S) total).  Decode carries
an explicit (B, H, P, N) state plus a depthwise-conv buffer, giving the
O(1)-per-token, O(1)-memory path that makes long_500k tractable.

Layout: d_in = expand * d_model; heads H = d_in / head_dim (P = head_dim);
B/C projections are shared across heads (ngroups = 1), A is scalar per head.
On DTensors the SSD scan runs on each rank's batch rows and heads
(``repro_torch.models.spmd.local_heads``); ``ssm_state_constraints`` pins
the scan's chunk carry to the batch-only sharding (heads whole on every
rank), ``repro``'s constraint.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.models import spmd
from repro_torch.models.layers import (dense_init, dtype_of, init_device,
                                       normal)

CHUNK = 128


def ssm_dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_head_dim
    return d_in, nheads, cfg.ssm_state, cfg.ssm_head_dim


def init_ssm(generator, cfg: ModelConfig, *, lead=(), device=None):
    dt = dtype_of(cfg.param_dtype)
    device = init_device(generator, device)
    d = cfg.d_model
    d_in, H, N, P = ssm_dims(cfg)
    conv_dim = d_in + 2 * N
    f32 = dict(dtype=torch.float32, device=device)

    def per_head(values):
        return values.expand(*lead, H).clone()

    return {
        # order: [z (d_in) | x (d_in) | B (N) | C (N) | dt (H)]
        "in_proj": dense_init(generator, d, 2 * d_in + 2 * N + H, dt,
                              lead=lead, device=device),
        "conv_w": (normal((*lead, cfg.ssm_conv_width, conv_dim), generator,
                          device) * 0.1).to(dt),
        "conv_b": torch.zeros((*lead, conv_dim), **f32),
        "A_log": per_head(torch.log(torch.linspace(1.0, 16.0, H, **f32))),
        "D": torch.ones((*lead, H), **f32),
        "dt_bias": torch.full((*lead, H), -2.0, **f32),
        "norm_scale": torch.ones((*lead, d_in), **f32),
        "out_proj": dense_init(generator, d_in, d, dt, lead=lead,
                               device=device),
    }


def _split_proj(zxbcdt, cfg):
    d_in, H, N, _ = ssm_dims(cfg)
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[..., d_in:d_in + d_in + 2 * N]
    dt = zxbcdt[..., -H:]
    return z, xBC, dt


def _causal_depthwise_conv(xBC, w, b):
    """xBC (B, S, C); w (W, C) depthwise causal conv, silu activation."""
    W = w.shape[0]
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    out = sum(pad[:, i:i + xBC.shape[1], :] * w[i] for i in range(W))
    return F.silu(out + b.to(out.dtype))


def _segsum(x):
    """x (..., T) -> (..., T, T): cumulative sums over segments (i >= j),
    ``-inf`` above the diagonal.  The mask comes before any ``exp``: the
    masked differences are positive and would overflow, and ``inf * 0``
    gives NaN in the value and the gradient."""
    T = x.shape[-1]
    xc = torch.cumsum(x, dim=-1)
    diff = xc[..., :, None] - xc[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return diff.masked_fill(~mask, -torch.inf)


def ssd_chunked(x, A, Bm, Cm, chunk=CHUNK):
    """Chunked SSD scan.

    x (B, S, H, P); A (B, S, H) [negative decay rates * dt];
    Bm/Cm (B, S, N).  Returns (y (B, S, H, P), final_state (B, H, P, N)).
    """
    b, S, H, P = x.shape
    N = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"sequence length {S} is not divisible by the SSD "
                         f"chunk {chunk}")
    c = S // chunk
    xc = x.reshape(b, c, chunk, H, P)
    Ac = A.reshape(b, c, chunk, H).permute(0, 1, 3, 2)        # (b,c,H,L)
    Bc = Bm.reshape(b, c, chunk, N)
    Cc = Cm.reshape(b, c, chunk, N)

    A_cum = torch.cumsum(Ac, dim=-1)                          # (b,c,H,L)
    A_total = A_cum[..., -1]                                  # (b,c,H)

    # 1. intra-chunk (diagonal blocks): quadratic within the chunk
    L = torch.exp(_segsum(Ac))                                # (b,c,H,L,L)
    Y_diag = torch.einsum("bcln,bcsn,bchls,bcshp->bclhp", Cc, Bc, L, xc)

    # 2. per-chunk input -> state contribution
    decay_states = torch.exp(A_total[..., None] - A_cum)      # (b,c,H,L)
    states = torch.einsum("bcln,bchl,bclhp->bchpn", Bc, decay_states, xc)

    # 3. inter-chunk recurrence (sequential over chunks); chunk i reads the
    # state before it
    carry = x.new_zeros((b, H, P, N))
    prev = []
    for i in range(c):
        prev.append(carry)
        carry = carry * torch.exp(A_total[:, i])[:, :, None, None] \
            + states[:, i]
    prev_states = torch.stack(prev, 1)                        # (b,c,H,P,N)

    # 4. state -> output within each chunk
    state_decay = torch.exp(A_cum)                            # (b,c,H,L)
    Y_off = torch.einsum("bcln,bchpn,bchl->bclhp", Cc, prev_states,
                         state_decay)

    y = (Y_diag + Y_off).reshape(b, S, H, P)
    return y, carry


def _gated_rmsnorm(y, z, scale):
    """Mamba2's norm before out_proj, in float32."""
    y = y * F.silu(z.to(torch.float32))
    ms = (y * y).mean(-1, keepdim=True)
    return y * torch.rsqrt(ms + 1e-5) * scale


def apply_ssm(p, x, cfg: ModelConfig, chunk=CHUNK):
    """Full-sequence Mamba2 block: x (B, S, d) -> (B, S, d)."""
    d_in, H, N, P = ssm_dims(cfg)
    # on DTensors the projection's gradient is kept in its layout: sharded
    # along the sequence, it would make in_proj's gradient a strided shard
    z, xBC, dt = _split_proj(spmd.grad_as_input(x @ p["in_proj"]), cfg)
    xBC = spmd.local_rows(_causal_depthwise_conv, xBC, p["conv_w"],
                          p["conv_b"])
    xs = spmd.split_dim(xBC[..., :d_in], -1, (H, P))
    Bm = xBC[..., d_in:d_in + N]
    Cm = xBC[..., d_in + N:]

    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])      # (B,S,H)
    A = -torch.exp(p["A_log"])                                # (H,)
    # on DTensors each rank scans its own batch rows and heads;
    # ssm_state_constraints keeps the chunk carry batch-only (heads whole)
    y, _ = spmd.local_heads(
        lambda x, A, Bm, Cm: ssd_chunked(x, A, Bm, Cm, chunk=chunk),
        (xs * dt[..., None]).to(torch.float32), dt * A,
        Bm.to(torch.float32), Cm.to(torch.float32),
        heads=not cfg.ssm_state_constraints, head_args=(True, False, False),
        out_head_dims=(2, 1))
    y = y + xs.to(torch.float32) * p["D"][None, None, :, None]
    y = _gated_rmsnorm(spmd.merge_dims(y, 2, 2), z, p["norm_scale"])
    return y.to(x.dtype) @ p["out_proj"]


# -- decode ------------------------------------------------------------------

@dataclasses.dataclass
class SSMCache:
    """Decode state of one SSM layer (or of L, stacked); ``decode_ssm``
    updates both buffers in place."""
    state: torch.Tensor      # (B, H, P, N)
    conv_buf: torch.Tensor   # (B, W-1, conv_dim) last inputs

    def __getitem__(self, i) -> "SSMCache":
        """Layer ``i`` of a stacked cache, as views of its buffers."""
        return SSMCache(state=self.state[i], conv_buf=self.conv_buf[i])


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=None, *, lead=(),
                   device=None) -> SSMCache:
    d_in, H, N, P = ssm_dims(cfg)
    dt = dtype or torch.float32
    conv_dim = d_in + 2 * N
    return SSMCache(
        state=torch.zeros((*lead, batch, H, P, N), dtype=dt, device=device),
        conv_buf=torch.zeros((*lead, batch, cfg.ssm_conv_width - 1,
                              conv_dim), dtype=dt, device=device))


def decode_ssm(p, x, cache: SSMCache, cfg: ModelConfig):
    """One-token decode: x (B, 1, d) -> (out (B, 1, d), cache), the cache
    updated in place.  O(1)."""
    d_in, H, N, P = ssm_dims(cfg)
    B_ = x.shape[0]
    z, xBC, dt = _split_proj(x[:, 0, :] @ p["in_proj"], cfg)

    # depthwise conv over the last W-1 inputs and this one
    w = p["conv_w"]
    hist = torch.cat([cache.conv_buf,
                      xBC[:, None, :].to(cache.conv_buf.dtype)], dim=1)
    conv = (hist * w[None]).sum(1) + p["conv_b"]
    xBC_t = F.silu(conv)
    cache.conv_buf.copy_(hist[:, 1:, :])

    xs = xBC_t[..., :d_in].reshape(B_, H, P)
    Bm = xBC_t[..., d_in:d_in + N]
    Cm = xBC_t[..., d_in + N:]

    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])         # (B,H)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A)                                         # (B,H)
    upd = (dt[..., None] * xs.to(torch.float32))[..., None] \
        * Bm.to(torch.float32)[:, None, None, :]                   # (B,H,P,N)
    cache.state.copy_(cache.state * dA[..., None, None] + upd)
    if spmd.is_dtensor(cache.state):
        # the state may be sharded on P; the einsum's (H*P) merge would read
        # a strided shard, which DTensor's bmm has no strategy for: the
        # same product as a batched
        # (P, N) @ (N, 1); then P unsharded, for the (H*P) merge below
        y = (cache.state @ Cm.to(torch.float32)[:, None, :, None])[..., 0]
        y = spmd.replicate_dims(y, 2)
    else:
        y = torch.einsum("bhpn,bn->bhp", cache.state, Cm.to(torch.float32))
    y = y + xs.to(torch.float32) * p["D"][None, :, None]
    y = _gated_rmsnorm(y.reshape(B_, d_in), z, p["norm_scale"])
    out = (y.to(x.dtype) @ p["out_proj"])[:, None, :]
    return out, cache
