"""GQA attention: training (full-sequence), prefill, and cached decode
(counterpart of ``repro.models.attention``).

Supports grouped KV heads, QKV bias (Qwen2), sliding-window masks (Mixtral /
Danube), M-RoPE (Qwen2-VL), and cross-attention (Whisper).  Decode keeps a
KV cache of ``min(window, context)`` slots; sliding-window archs use it as a
ring buffer, so a 512k context costs O(window) memory.

Scores follow ``repro``'s formula: an einsum, the ``-1e30`` mask, a float32
softmax, and the probabilities cast to the compute dtype before the PV
product.  No fused library attention is used: its softmax sums in another
order.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import ModelConfig
from repro_torch.models import spmd
from repro_torch.models.layers import (apply_rope, dense_init, dtype_of,
                                       init_device)

MASKED = -1e30


def init_attention(generator, cfg: ModelConfig, *, cross: bool = False,
                   lead=(), device=None):
    dt = dtype_of(cfg.param_dtype)
    device = init_device(generator, device)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    kw = dict(lead=lead, device=device)
    p = {
        "wq": dense_init(generator, d, H * hd, dt, **kw),
        "wk": dense_init(generator, d, Hkv * hd, dt, **kw),
        "wv": dense_init(generator, d, Hkv * hd, dt, **kw),
        "wo": dense_init(generator, H * hd, d, dt, **kw),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", Hkv * hd),
                            ("bv", Hkv * hd)):
            p[name] = torch.zeros((*lead, width), dtype=torch.float32,
                                  device=device)
    return p


def _project_q(p, x, cfg):
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
    return spmd.split_dim(q, -1, (cfg.num_heads, cfg.resolved_head_dim))


def _project_kv(p, x, cfg):
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    heads = (cfg.num_kv_heads, cfg.resolved_head_dim)
    return spmd.split_dim(k, -1, heads), spmd.split_dim(v, -1, heads)


def _gqa_scores(q, k):
    """q (B,Sq,H,Dh), k (B,Sk,Hkv,Dh) -> (B,Hkv,G,Sq,Sk) grouped scores."""
    H, Dh = q.shape[2:]
    Hkv = k.shape[2]
    G = H // Hkv
    qg = spmd.split_dim(q, 2, (Hkv, G))
    return torch.einsum("bqhgd,bkhd->bhgqk", qg, k) / (Dh ** 0.5)


def _gqa_out(probs, v, B, Sq, H, Dh):
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, H * Dh)


def attend(p, x, positions, cfg: ModelConfig, *, causal: bool = True,
           kv_x: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence attention (training / prefill / encoder / cross)."""
    S = x.shape[1]

    q = _project_q(p, x, cfg)
    src = kv_x if kv_x is not None else x
    k, v = _project_kv(p, src, cfg)

    is_self = kv_x is None
    if is_self:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)

    if is_self and causal and cfg.attn_chunk and S % cfg.attn_chunk == 0 \
            and S > cfg.attn_chunk:
        out = spmd.local_heads(
            lambda q, k, v: _chunked_causal_attention(q, k, v, cfg), q, k, v)
        return spmd.merge_dims(out, 2, 2) @ p["wo"]

    out = spmd.local_heads(
        lambda q, k, v: _attend_core(q, k, v, cfg,
                                     causal=is_self and causal), q, k, v)
    return out @ p["wo"]


def _attend_core(q, k, v, cfg: ModelConfig, *, causal: bool):
    """Scores, the causal (and window) mask, softmax, the PV product:
    (B, S, H, Dh) queries over (B, Sk, Hkv, Dh) keys -> (B, S, H * Dh)."""
    B, S, H, Dh = q.shape
    scores = _gqa_scores(q, k).to(torch.float32)

    Sk = k.shape[1]
    if causal:
        qi = torch.arange(S, device=q.device)[:, None]
        ki = torch.arange(Sk, device=q.device)[None, :]
        mask = ki <= qi
        if cfg.window:
            mask &= ki > qi - cfg.window
        scores = scores.masked_fill(~mask, MASKED)

    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return _gqa_out(probs, v, B, S, H, Dh)


def _chunked_causal_attention(q, k, v, cfg: ModelConfig):
    """Flash-style online-softmax attention over KV chunks.

    Never materializes the (S, S) score matrix: a loop over KV chunks
    carries the running max / denominator / weighted sum.  ``repro``'s scan
    also visits the chunks past the diagonal, whose masked scores add
    ``exp(-1e30 - m) = 0`` and scale by ``exp(0) = 1``; skipping them
    leaves every value as it is.
    """
    B, S, H, Dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    C = cfg.attn_chunk
    n = S // C
    qg = spmd.split_dim(spmd.split_dim(q, 2, (Hkv, G)), 1, (n, C))
    kc = spmd.split_dim(k, 1, (n, C))
    vc = spmd.split_dim(v, 1, (n, C))
    ar = torch.arange(C, device=q.device)

    outs = []
    for qi in range(n):
        q_blk = qg[:, qi]                              # (B, C, Hkv, G, Dh)
        m = torch.full((B, Hkv, G, C), -torch.inf, dtype=torch.float32,
                       device=q.device)
        den = torch.zeros((B, Hkv, G, C), dtype=torch.float32,
                          device=q.device)
        acc = torch.zeros((B, Hkv, G, C, Dh), dtype=torch.float32,
                          device=q.device)
        for j in range(qi + 1):
            s = torch.einsum("bqhgd,bkhd->bhgqk", q_blk, kc[:, j]
                             ).to(torch.float32) / (Dh ** 0.5)
            qpos = qi * C + ar[:, None]
            kpos = j * C + ar[None, :]
            mask = kpos <= qpos
            if cfg.window:
                mask &= kpos > qpos - cfg.window
            s = s.masked_fill(~mask, MASKED)
            m_new = torch.maximum(m, s.amax(-1))
            scale = torch.exp(m - m_new)
            p_blk = torch.exp(s - m_new[..., None])
            den = den * scale + p_blk.sum(-1)
            acc = acc * scale[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p_blk, vc[:, j].to(torch.float32))
            m = m_new
        outs.append(acc / torch.clamp(den[..., None], min=1e-30))
    out = torch.stack(outs, 1)                         # (B,n,Hkv,G,C,Dh)
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(B, S, H, Dh)
    return out.to(q.dtype)


# -- cached decode -----------------------------------------------------------

@dataclasses.dataclass
class KVCache:
    """KV cache; a ring buffer when cache_len < context length.  Decode
    writes into ``k`` and ``v`` in place."""
    k: torch.Tensor        # (B, C, Hkv, Dh), or (L, B, C, Hkv, Dh) stacked
    v: torch.Tensor

    @property
    def cache_len(self) -> int:
        return self.k.shape[-3]

    def __getitem__(self, i) -> "KVCache":
        """Layer ``i`` of a stacked cache, as views of its buffers."""
        return KVCache(k=self.k[i], v=self.v[i])


def init_kv_cache(cfg: ModelConfig, batch: int, context: int, dtype=None,
                  *, lead=(), device=None) -> KVCache:
    """Cache sized min(window, context) — the sub-quadratic carve-out."""
    C = min(cfg.window, context) if cfg.window else context
    dt = dtype or dtype_of(cfg.compute_dtype)
    shape = (*lead, batch, C, cfg.num_kv_heads, cfg.resolved_head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dt, device=device),
                   v=torch.zeros(shape, dtype=dt, device=device))


def decode_attend(p, x, pos, cache: KVCache, cfg: ModelConfig):
    """One-token decode: x (B, 1, d); pos () current position, a 0-d
    integer tensor on x's device.

    Returns (out (B, 1, d), cache): the new key and value are written into
    ``cache`` in place (at slot ``pos % C``, a ring buffer when the cache is
    a sliding window), keys roped at their absolute position first.
    """
    B = x.shape[0]
    C = cache.cache_len

    q = _project_q(p, x, cfg)
    k_new, v_new = _project_kv(p, x, cfg)

    pos_b = pos.expand(3, B, 1) if cfg.mrope_sections else pos.expand(B, 1)
    q = apply_rope(q, pos_b, cfg.rope_theta, cfg.mrope_sections)
    k_new = apply_rope(k_new, pos_b, cfg.rope_theta, cfg.mrope_sections)

    slot = torch.remainder(pos, C).reshape(1).to(torch.long)
    spmd.write_slot(cache.k, 1, slot, k_new.to(cache.k.dtype))
    spmd.write_slot(cache.v, 1, slot, v_new.to(cache.v.dtype))

    out = spmd.local_heads(
        lambda q, k, v, pos: _decode_core(q, k, v, pos, cfg), q, cache.k,
        cache.v, pos)
    return out @ p["wo"], cache


def _decode_core(q, k, v, pos, cfg: ModelConfig):
    """One query position over the cache: q (B, 1, H, Dh), k / v
    (B, C, Hkv, Dh), the slots past ``pos`` masked -> (B, 1, H * Dh)."""
    B, _, H, Dh = q.shape
    C = k.shape[1]
    scores = _gqa_scores(q, k).to(torch.float32)   # (B,Hkv,G,1,C)
    idx = torch.arange(C, device=q.device)
    if cfg.window and C < cfg.window + 1:
        # ring buffer: every live slot is within the window
        mask = (idx <= pos) | (pos >= C)             # pre-fill vs wrapped
    else:
        mask = idx <= pos
    scores = scores.masked_fill(~mask, MASKED)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return _gqa_out(probs, v, B, 1, H, Dh)


def cross_attend_cached(p, x, k, v, cfg: ModelConfig):
    """Cross-attention against precomputed encoder K/V (whisper decode)."""
    q = _project_q(p, x, cfg)
    out = spmd.local_heads(
        lambda q, k, v: _attend_core(q, k, v, cfg, causal=False), q, k, v)
    return out @ p["wo"]
