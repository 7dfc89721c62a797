"""Meta-device stand-ins for every (arch x shape): parameters, optimizer
state, model inputs and decode caches with their shapes and dtypes, and no
memory (counterpart of the unsharded half of ``repro.launch.specs``; its
sharding trees wait for the port's mesh).
"""
from __future__ import annotations

import torch

from repro_torch.configs import ModelConfig, ShapeConfig
from repro_torch.models import lm
from repro_torch.optim import init_opt_state

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
