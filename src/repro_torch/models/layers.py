"""Shared transformer building blocks: norms, MLPs, embeddings, RoPE/M-RoPE
(counterpart of ``repro.models.layers``).

Parameters are plain nested dicts of tensors; initializers take an explicit
``torch.Generator`` and draw on its device (``generator=None`` with
``device="meta"`` gives shapes and dtypes only).  ``lead`` prefixes a
parameter's shape, so a stack of L layers is drawn as one tensor.  Norms
compute in float32 and cast back; matmuls take the compute dtype, and the
LM launchers switch off reduced-precision bf16 reductions on the card, so
products accumulate in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.models import spmd


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def normal(shape, generator, device) -> torch.Tensor:
    """Standard normal float32 draws from ``generator`` on ``device``."""
    return torch.randn(tuple(shape), generator=generator, device=device,
                       dtype=torch.float32)


def dense_init(generator, d_in, d_out, dtype, scale=None, *, lead=(),
               device=None) -> torch.Tensor:
    scale = scale if scale is not None else (1.0 / d_in) ** 0.5
    return (normal((*lead, d_in, d_out), generator, device)
            * scale).to(dtype)


def init_device(generator, device):
    """Where an initializer draws: the generator's device unless given."""
    return device if device is not None else generator.device


# -- norms -------------------------------------------------------------------

def init_norm(cfg: ModelConfig, d=None, *, lead=(), device=None):
    d = d or cfg.d_model
    p = {"scale": torch.ones((*lead, d), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((*lead, d), dtype=torch.float32,
                                device=device)
    return p


def apply_norm(p, x, cfg: ModelConfig, eps=1e-5):
    xf = x.to(torch.float32)
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:                                          # rmsnorm
        ms = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p["scale"]
    return out.to(x.dtype)


# -- MLP ---------------------------------------------------------------------

def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def init_mlp(generator, cfg: ModelConfig, d=None, f=None, *, lead=(),
             device=None):
    d = d or cfg.d_model
    f = f or cfg.d_ff
    dt = dtype_of(cfg.param_dtype)
    device = init_device(generator, device)
    p = {"w1": dense_init(generator, d, f, dt, lead=lead, device=device),
         "w2": dense_init(generator, f, d, dt, lead=lead, device=device)}
    if cfg.act == "swiglu":
        p["w3"] = dense_init(generator, d, f, dt, lead=lead, device=device)
    return p


def apply_mlp(p, x, cfg: ModelConfig):
    h = x @ p["w1"]
    if cfg.act == "swiglu":
        h = F.silu(h) * (x @ p["w3"])
    else:
        h = gelu(h)
    return h @ p["w2"]


# -- embeddings --------------------------------------------------------------

def init_embedding(generator, cfg: ModelConfig, *, device=None):
    dt = dtype_of(cfg.param_dtype)
    device = init_device(generator, device)
    p = {"tokens": dense_init(generator, cfg.vocab_size, cfg.d_model, dt,
                              scale=1.0, device=device)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(generator, cfg.d_model, cfg.vocab_size, dt,
                               device=device)
    return p


def embed(p, tokens, cfg: ModelConfig):
    return spmd.embed_rows(p["tokens"], tokens)


def unembed(p, h, cfg: ModelConfig):
    if cfg.tie_embeddings:
        # tied head: rescale so init logits match the untied 1/sqrt(d) head
        return (h @ p["tokens"].T).to(torch.float32) / (cfg.d_model ** 0.5)
    return (h @ p["head"]).to(torch.float32)


# -- RoPE --------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: tuple[int, ...] = ()) -> torch.Tensor:
    """Rotary embedding.

    x: (B, S, H, Dh).  positions: (B, S) for standard RoPE or (3, B, S) for
    M-RoPE (Qwen2-VL), where the head-dim halves are split into
    ``mrope_sections`` groups rotated by the t/h/w coordinate respectively.
    """
    half = x.shape[-1] // 2
    inv = rope_freqs(x.shape[-1], theta, x.device)        # (half,)
    if mrope_sections:
        if positions.ndim != 3 or sum(mrope_sections) != half:
            raise ValueError(f"M-RoPE needs (3, B, S) positions and sections "
                             f"summing to {half}; got {positions.ndim}-d, "
                             f"{mrope_sections}")
        # pick which coordinate (t/h/w) drives each frequency slot
        sect = torch.tensor([i for i, n in enumerate(mrope_sections)
                             for _ in range(n)], device=x.device)  # (half,)
        pos = positions[sect]                                  # (half, B, S)
        ang = torch.einsum("hbs,h->bsh", pos.to(torch.float32), inv)
    else:
        if positions.ndim != 2:
            raise ValueError(f"RoPE needs (B, S) positions, got "
                             f"{positions.ndim}-d")
        ang = positions[..., None].to(torch.float32) * inv     # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
