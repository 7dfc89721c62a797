"""Model assembly for every LM architecture family (counterpart of
``repro.models.lm``).

One parameter tree + three entry points:

  * ``forward(params, batch, cfg)``       -> logits (train / prefill)
  * ``init_decode_state(cfg, batch, ctx)`` -> per-layer caches + position
  * ``decode_step(params, state, batch)``  -> (logits, state)   [1 token]

Per-layer parameters are STACKED along a leading L axis (``"blocks"``), as
in ``repro``, so a JAX parameter tree crosses over leaf by leaf
(``params_from_numpy``); the forward takes the layers as views of the
stacks (``layers``).  ``remat=True`` recomputes each layer in the backward
(``torch.utils.checkpoint``).

Families:
  dense        pre-norm GQA attention + MLP
  moe          attention + top-k expert FFN (repro_torch.models.moe)
  ssm          Mamba2 SSD blocks (repro_torch.models.ssm), optional MLP
  hybrid       Mamba2 backbone + ONE weight-shared attention+MLP block
               applied every ``shared_attn_every`` layers (Zamba2)
  vlm          dense + M-RoPE positions + stubbed patch embeddings
  audio        whisper-style encoder-decoder (stubbed conv frontend)
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import spmd
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_mlp, apply_norm, dtype_of,
                                       embed, init_embedding, init_mlp,
                                       init_norm, unembed)
from repro_torch.optim.optimizers import tree_map


# ===========================================================================
# init
# ===========================================================================

def _init_decoder_blocks(gen, cfg: ModelConfig, n: int, device, *,
                         cross: bool = False):
    lead = (n,)
    p = {"ln1": init_norm(cfg, lead=lead, device=device)}
    if cfg.family in ("ssm", "hybrid"):
        p["ssm"] = ssm_mod.init_ssm(gen, cfg, lead=lead, device=device)
    else:
        p["attn"] = attn.init_attention(gen, cfg, lead=lead, device=device)
    if cross:
        p["ln_cross"] = init_norm(cfg, lead=lead, device=device)
        p["cross"] = attn.init_attention(gen, cfg, cross=True, lead=lead,
                                         device=device)
    if cfg.num_experts and cfg.family == "moe":
        p["ln2"] = init_norm(cfg, lead=lead, device=device)
        p["moe"] = moe_mod.init_moe(gen, cfg, lead=lead, device=device)
    elif cfg.d_ff and cfg.family != "hybrid":
        p["ln2"] = init_norm(cfg, lead=lead, device=device)
        p["mlp"] = init_mlp(gen, cfg, lead=lead, device=device)
    return p


def _init_attn_mlp_blocks(gen, cfg: ModelConfig, lead, device):
    """Zamba2's weight-shared block (``lead=()``: one param set) and the
    whisper encoder's blocks: attention + MLP."""
    return {"ln1": init_norm(cfg, lead=lead, device=device),
            "attn": attn.init_attention(gen, cfg, lead=lead, device=device),
            "ln2": init_norm(cfg, lead=lead, device=device),
            "mlp": init_mlp(gen, cfg, lead=lead, device=device)}


def init_model(cfg: ModelConfig, generator: torch.Generator | None = None,
               *, device=None):
    """Seeded random parameters in ``repro``'s tree, shapes and dtypes, drawn
    from ``generator`` on its device (``generator=None, device="meta"``
    gives shapes and dtypes only).  ``repro`` draws with ``jax.random``,
    whose bits torch cannot reproduce: parity runs take ``repro``'s
    parameters through ``params_from_numpy``."""
    device = device if device is not None else generator.device
    params = {
        "embed": init_embedding(generator, cfg, device=device),
        "blocks": _init_decoder_blocks(generator, cfg, cfg.num_layers,
                                       device, cross=cfg.is_encdec),
        "final_norm": init_norm(cfg, device=device),
    }
    if cfg.family == "hybrid":
        params["shared"] = _init_attn_mlp_blocks(generator, cfg, (), device)
    if cfg.is_encdec:
        params["enc_blocks"] = _init_attn_mlp_blocks(
            generator, cfg, (cfg.encoder_layers,), device)
        params["enc_norm"] = init_norm(cfg, device=device)
    return params


def params_from_numpy(params_np, device):
    """``repro``'s parameter tree (numpy arrays, or anything ``np.asarray``
    takes; bfloat16 leaves as ``ml_dtypes`` arrays) -> the port's, on
    ``device``, dtypes kept."""
    def one(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))
        return t.to(device)
    return tree_map(one, params_np)


def params_to_numpy(params):
    """The port's parameter tree -> numpy arrays in ``repro``'s layout;
    bfloat16 leaves come out as float32 (exact)."""
    def one(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()
    return tree_map(one, params)


def layers(blocks, n: int) -> list:
    """The ``n`` layers of a stacked tree, as views.  ``unbind`` makes the
    gradients of the n views one stack; indexing each layer would add n
    zero-filled copies of every stacked leaf into its gradient."""
    if isinstance(blocks, dict):
        per_key = {k: layers(v, n) for k, v in blocks.items()}
        return [{k: per_key[k][i] for k in blocks} for i in range(n)]
    return list(blocks.unbind(0))


# ===========================================================================
# forward (train / prefill)
# ===========================================================================

def _dense_block_fwd(blk, h, positions, cfg, enc_out=None):
    a = attn.attend(blk["attn"], apply_norm(blk["ln1"], h, cfg), positions,
                    cfg, causal=True)
    h = _add(h, a)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if "cross" in blk:
        c = attn.attend(blk["cross"], apply_norm(blk["ln_cross"], h, cfg),
                        positions, cfg, kv_x=enc_out)
        h = _add(h, c)
    if "moe" in blk:
        m, aux = moe_mod.apply_moe(blk["moe"],
                                   apply_norm(blk["ln2"], h, cfg), cfg)
        h = _add(h, m)
    elif "mlp" in blk:
        h = _add(h, apply_mlp(blk["mlp"], apply_norm(blk["ln2"], h, cfg),
                              cfg))
    return h, aux


def _ssm_block_fwd(blk, h, cfg):
    h = _add(h, ssm_mod.apply_ssm(blk["ssm"], apply_norm(blk["ln1"], h, cfg),
                                  cfg))
    if "mlp" in blk:
        h = _add(h, apply_mlp(blk["mlp"], apply_norm(blk["ln2"], h, cfg),
                              cfg))
    return h


def _shared_block_fwd(shared, h, positions, cfg, causal=True):
    a = attn.attend(shared["attn"], apply_norm(shared["ln1"], h, cfg),
                    positions, cfg, causal=causal)
    h = _add(h, a)
    h = _add(h, apply_mlp(shared["mlp"], apply_norm(shared["ln2"], h, cfg),
                          cfg))
    return h


def _add(h, delta):
    """The residual add.  On DTensors the branch's output (a Partial sum
    after its last product) is first laid out as the stream is: the
    all-reduce GSPMD places there, which keeps DTensor from carrying the
    Partial into the next norm's products."""
    return h + spmd.match(delta, h)


def _run(fn, remat: bool, *args):
    """``fn(*args)``, recomputed in the backward when ``remat``."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _positions(B: int, S: int, device):
    return torch.arange(S, device=device).expand(B, S)


def _encode(params, frames, cfg):
    """Whisper encoder over stubbed frame embeddings (B, S_enc, d)."""
    h = frames.to(dtype_of(cfg.compute_dtype))
    positions = _positions(h.shape[0], h.shape[1], h.device)
    for blk in layers(params["enc_blocks"], cfg.encoder_layers):
        h = _shared_block_fwd(blk, h, positions, cfg, causal=False)
    return apply_norm(params["enc_norm"], h, cfg)


def forward(params, batch: dict, cfg: ModelConfig, *, remat: bool = True,
            last_only: bool = False):
    """Returns (logits (B, S, V) float32, aux_loss scalar).

    last_only=True slices the hidden state to the final position BEFORE the
    unembedding matmul — prefill only needs next-token logits.  A batch with
    ``"__return_hidden__"`` set returns the final normed hidden state
    instead of the logits.
    """
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = embed(params["embed"], tokens, cfg)
    h = spmd.match(h.to(dtype_of(cfg.compute_dtype)), tokens)

    if cfg.family == "vlm":
        # stubbed vision frontend: patch embeddings occupy the prompt prefix
        vis = batch["vision_embeds"].to(h.dtype)
        n_patch = vis.shape[1]
        h = torch.cat([vis, h[:, n_patch:, :]], dim=1)
        positions = batch["positions"]                  # (3, B, S) M-RoPE
    else:
        positions = _positions(B, S, h.device)

    enc_out = None
    if cfg.is_encdec:
        enc_out = _encode(params, batch["frames"], cfg)

    if cfg.family in ("ssm", "hybrid"):
        h, aux = _forward_ssm_stack(params, h, positions, cfg, remat)
    else:
        auxs = []
        for blk in layers(params["blocks"], cfg.num_layers):
            h, a = _run(_dense_block_fwd, remat, blk, h, positions, cfg,
                        enc_out)
            auxs.append(a)
        aux = torch.stack(auxs).sum()

    h = apply_norm(params["final_norm"], h, cfg)
    if last_only:
        h = h[:, -1:, :]
    if batch.get("__return_hidden__"):
        return h, aux
    return unembed(params["embed"], h, cfg), aux


def _forward_ssm_stack(params, h, positions, cfg, remat):
    """SSM layers in order; for the hybrid, the shared block after each
    group of ``shared_attn_every`` of them and after the remainder."""
    every = cfg.shared_attn_every
    L = cfg.num_layers
    hybrid = cfg.family == "hybrid" and every
    for i, blk in enumerate(layers(params["blocks"], L)):
        h = _run(_ssm_block_fwd, remat, blk, h, cfg)
        if hybrid and ((i + 1) % every == 0 or i == L - 1):
            h = _run(_shared_block_fwd, remat, params["shared"], h,
                     positions, cfg)
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


# ===========================================================================
# loss
# ===========================================================================

def _nll_sum(logits, labels):
    if spmd.is_dtensor(logits):
        return _nll_sum_sharded(logits, labels)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, labels.clamp(min=0)[..., None].long()
                        )[..., 0]
    return torch.where(labels >= 0, nll, 0.0).sum()


def _nll_sum_sharded(logits, labels):
    """``_nll_sum`` over DTensor logits, whose vocab may be sharded: the
    log-sum-exp and the label's logit are reduced across the vocab's
    shards (vocab-parallel cross-entropy, the reductions GSPMD places), so
    no rank gathers the vocab."""
    lf = spmd.grad_as_input(logits.to(torch.float32))
    m = lf.amax(-1, keepdim=True).detach()
    lse = torch.log(torch.exp(lf - m).sum(-1)) + m[..., 0]
    ids = spmd.arange_like(lf, -1)
    hit = ids == labels.clamp(min=0)[..., None].to(ids.dtype)
    nll = lse - torch.where(hit, lf, 0.0).sum(-1)
    return torch.where(labels >= 0, nll, 0.0).sum()


def lm_loss(params, batch: dict, cfg: ModelConfig, *, remat: bool = True,
            aux_weight: float = 0.01):
    labels = batch["labels"]
    valid = labels >= 0
    count = valid.sum().clamp(min=1)

    if cfg.ce_seq_chunk and labels.shape[1] % cfg.ce_seq_chunk == 0 \
            and labels.shape[1] > cfg.ce_seq_chunk:
        # never materialize the (B, S, V) f32 logits — unembed and CE per
        # sequence chunk.  Mathematically identical to the flat path.
        h, aux = forward(params, dict(batch, __return_hidden__=True), cfg,
                         remat=remat)
        Ck = cfg.ce_seq_chunk
        sums = [_nll_sum(unembed(params["embed"], h[:, s:s + Ck], cfg),
                         labels[:, s:s + Ck])
                for s in range(0, labels.shape[1], Ck)]
        loss = torch.stack(sums).sum() / count
        return loss + aux_weight * aux, {"ce": loss, "aux": aux}

    logits, aux = forward(params, batch, cfg, remat=remat)
    loss = _nll_sum(logits, labels) / count
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}


# ===========================================================================
# decode (serve_step)
# ===========================================================================

@dataclasses.dataclass
class DecodeState:
    """Decode caches, stacked over layers, and the next position.

    ``decode_step`` consumes a state: it writes the new token's keys,
    values and SSM states into these buffers in place and returns a state
    that shares them, with ``pos + 1``.
    """
    pos: torch.Tensor                  # () int32, next position to write
    kv: attn.KVCache | None = None     # (L, B, C, Hkv, Dh) stacked
    ssm: ssm_mod.SSMCache | None = None
    shared_kv: attn.KVCache | None = None   # hybrid: one cache per app
    cross_kv: tuple | None = None      # encdec: (k, v), (L, B, S_enc, ...)


def num_shared_apps(cfg: ModelConfig) -> int:
    G, r = divmod(cfg.num_layers, cfg.shared_attn_every)
    return G + (1 if r else 0)


@torch.no_grad()
def init_decode_state(cfg: ModelConfig, batch: int, context: int,
                      enc_out=None, params=None, *,
                      device=None) -> DecodeState:
    """Caches for ``batch`` sequences of up to ``context`` tokens on
    ``device`` (by default that of ``params``, else the GPU).  For
    whisper, the cross K/V of every decoder layer is projected from
    ``enc_out`` once here."""
    if device is None:
        device = (params["final_norm"]["scale"].device if params
                  else resolve_device(None))
    dt = dtype_of(cfg.compute_dtype)
    kv = ssm = shared = cross = None
    if cfg.family in ("ssm", "hybrid"):
        ssm = ssm_mod.init_ssm_cache(cfg, batch, torch.float32,
                                     lead=(cfg.num_layers,), device=device)
        if cfg.family == "hybrid":
            shared = attn.init_kv_cache(cfg, batch, context, dt,
                                        lead=(num_shared_apps(cfg),),
                                        device=device)
    else:
        kv = attn.init_kv_cache(cfg, batch, context, dt,
                                lead=(cfg.num_layers,), device=device)
    if cfg.is_encdec:
        if enc_out is not None and params is not None:
            # precompute cross K/V per decoder layer from encoder output
            ks, vs = zip(*(attn._project_kv(blk["cross"], enc_out, cfg)
                           for blk in layers(params["blocks"],
                                             cfg.num_layers)))
            cross = (torch.stack(ks).to(dt), torch.stack(vs).to(dt))
        else:
            shape = (cfg.num_layers, batch, cfg.encoder_seq,
                     cfg.num_kv_heads, cfg.resolved_head_dim)
            cross = (torch.zeros(shape, dtype=dt, device=device),
                     torch.zeros(shape, dtype=dt, device=device))
    return DecodeState(pos=torch.zeros((), dtype=torch.int32, device=device),
                       kv=kv, ssm=ssm, shared_kv=shared, cross_kv=cross)


@torch.no_grad()
def decode_step(params, state: DecodeState, batch: dict, cfg: ModelConfig):
    """One token for the whole batch: batch['tokens'] (B, 1).

    Returns (logits (B, 1, V) float32, state).  The caches of ``state`` are
    updated in place (the state is consumed); the returned state shares
    them and holds ``pos + 1``.
    """
    tokens = batch["tokens"]
    h = embed(params["embed"], tokens, cfg).to(dtype_of(cfg.compute_dtype))
    h = spmd.match(h, tokens)
    pos = state.pos

    if cfg.family in ("ssm", "hybrid"):
        h = _decode_ssm_stack(params, h, state, cfg)
    else:
        for i, blk in enumerate(layers(params["blocks"], cfg.num_layers)):
            a, _ = attn.decode_attend(
                blk["attn"], apply_norm(blk["ln1"], h, cfg), pos,
                state.kv[i], cfg)
            h = _add(h, a)
            if "cross" in blk:
                ck, cv = state.cross_kv
                h = _add(h, attn.cross_attend_cached(
                    blk["cross"], apply_norm(blk["ln_cross"], h, cfg),
                    ck[i], cv[i], cfg))
            if "moe" in blk:
                m, _ = moe_mod.apply_moe(blk["moe"],
                                         apply_norm(blk["ln2"], h, cfg), cfg)
                h = _add(h, m)
            elif "mlp" in blk:
                h = _add(h, apply_mlp(blk["mlp"],
                                      apply_norm(blk["ln2"], h, cfg), cfg))

    h = apply_norm(params["final_norm"], h, cfg)
    return (unembed(params["embed"], h, cfg),
            dataclasses.replace(state, pos=pos + 1))


def _decode_ssm_stack(params, h, state, cfg):
    pos = state.pos
    every = cfg.shared_attn_every
    L = cfg.num_layers
    hybrid = cfg.family == "hybrid" and every
    shared = params.get("shared")
    app = 0
    for i, blk in enumerate(layers(params["blocks"], L)):
        out, _ = ssm_mod.decode_ssm(
            blk["ssm"], apply_norm(blk["ln1"], h, cfg), state.ssm[i], cfg)
        h = _add(h, out)
        if "mlp" in blk:
            h = _add(h, apply_mlp(blk["mlp"],
                                  apply_norm(blk["ln2"], h, cfg), cfg))
        if hybrid and ((i + 1) % every == 0 or i == L - 1):
            a, _ = attn.decode_attend(
                shared["attn"], apply_norm(shared["ln1"], h, cfg), pos,
                state.shared_kv[app], cfg)
            h = _add(h, a)
            h = _add(h, apply_mlp(shared["mlp"],
                                  apply_norm(shared["ln2"], h, cfg), cfg))
            app += 1
    return h
