"""Meta-device stand-ins + sharding trees for every (arch x shape)
(counterpart of ``repro.launch.specs``).

Nothing here allocates memory: parameters, optimizer state, model inputs
and decode caches are meta tensors with their shapes and dtypes, and their
shardings come from the rules in ``repro_torch.sharding``.  A sharding
tree matches its tree leaf for leaf and holds ``PartitionSpec``\\s;
``repro_torch.sharding.placements`` / ``distribute`` turn them into
DTensors on a ``DeviceMesh``.
"""
from __future__ import annotations

import torch

from repro_torch.configs import ModelConfig, ShapeConfig
from repro_torch.models import lm
from repro_torch.optim import init_opt_state
from repro_torch.optim.optimizers import OptState
from repro_torch.sharding import (P, batch_spec, cache_spec, dp_axes,
                                  mesh_axes, param_specs, tree_map_with_path)

VLM_PATCH_FRACTION = 4      # n_patches = seq_len // 4 for vlm shapes
META = torch.device("meta")


def moment_dtype_for(cfg: ModelConfig) -> torch.dtype:
    """bf16 Adam moments for >=100B-param configs (documented trade-off)."""
    return torch.bfloat16 if cfg.param_count() > 100e9 else torch.float32


def abstract_params(cfg: ModelConfig):
    return lm.init_model(cfg, None, device=META)


def abstract_opt_state(cfg: ModelConfig, params_struct):
    return init_opt_state(params_struct, kind="adamw",
                          moment_dtype=moment_dtype_for(cfg))


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Model-input meta tensors for one input shape."""
    B, S = shape.global_batch, shape.seq_len
    ids = dict(dtype=torch.int32, device=META)
    if shape.kind == "decode":
        return {"tokens": torch.empty((B, 1), **ids)}
    batch = {"tokens": torch.empty((B, S), **ids),
             "labels": torch.empty((B, S), **ids)}
    if cfg.family == "vlm":
        n_patch = S // VLM_PATCH_FRACTION
        batch["vision_embeds"] = torch.empty(
            (B, n_patch, cfg.d_model), dtype=torch.bfloat16, device=META)
        batch["positions"] = torch.empty((3, B, S), **ids)
    if cfg.is_encdec:
        batch["frames"] = torch.empty(
            (B, cfg.encoder_seq, cfg.d_model), dtype=torch.bfloat16,
            device=META)
    return batch


def abstract_decode_state(cfg: ModelConfig, shape: ShapeConfig):
    return lm.init_decode_state(cfg, shape.global_batch, shape.seq_len,
                                device=META)


# ---------------------------------------------------------------------------
# sharding trees
# ---------------------------------------------------------------------------

def batch_shardings(batch_struct: dict, mesh) -> dict:
    def one(name, s):
        if name == "positions":                       # (3, B, S)
            dp = dp_axes(mesh)
            ax = dp if len(dp) > 1 else dp[0]
            return P(None, ax, None) \
                if s.shape[1] % _prod(mesh, dp) == 0 else P()
        return batch_spec(tuple(s.shape), mesh)
    return {k: one(k, v) for k, v in batch_struct.items()}


def _prod(mesh, axes) -> int:
    mesh = mesh_axes(mesh)
    out = 1
    for a in axes:
        out *= mesh.shape[a]
    return out


def decode_state_shardings(state_struct, mesh):
    """Specs of a ``DecodeState``.  Its paths are ``repro``'s: the position
    of each field (``pos, kv, ssm, shared_kv, cross_kv``) and of each
    cache's buffer, e.g. ``2/0`` for the SSM state, so ``"ssm" in name``
    never holds there and the SSM state (L, B, H, P, N) takes the KV
    cache's rule, in both packages."""
    def rule(name, leaf):
        shp = tuple(leaf.shape)
        if len(shp) == 0:
            return P()
        if "ssm" in name and len(shp) == 5:           # (L,B,H,P,N)
            return cache_spec(shp, mesh, kv_head_dim=2)
        if len(shp) == 5:                              # kv caches (L,B,C,H,D)
            return cache_spec(shp, mesh, kv_head_dim=3)
        if len(shp) >= 2:                              # conv buffers etc.
            sp = [None] * len(shp)
            dp = dp_axes(mesh)
            ax = dp if len(dp) > 1 else dp[0]
            if shp[1] % _prod(mesh, dp) == 0:
                sp[1] = ax
            return P(*sp)
        return P()
    return tree_map_with_path(rule, state_struct)


def param_shardings_tree(params_struct, mesh):
    return param_specs(params_struct, mesh)


def opt_shardings_tree(opt_struct, params_struct, mesh) -> OptState:
    pspecs = param_specs(params_struct, mesh)
    return OptState(step=P(), mu=pspecs, nu=pspecs)
