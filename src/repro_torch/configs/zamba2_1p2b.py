"""Zamba2-1.2B — Mamba2 backbone + weight-shared attention blocks
[arXiv:2411.15242]."""
import dataclasses

from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32000, head_dim=64,
    ssm_state=64, ssm_head_dim=64, ssm_conv_width=4, ssm_expand=2,
    shared_attn_every=6,              # one shared attn+MLP block per 6 layers
    window=4096,                      # shared block uses windowed attention
                                      # (keeps long_500k sub-quadratic)
    norm="rmsnorm", act="swiglu", rope_theta=1e4,
    source="arXiv:2411.15242 (Zamba2)",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="zamba2-1.2b-reduced", num_layers=4, d_model=128,
        num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512,
        ssm_state=16, ssm_head_dim=32, shared_attn_every=2, window=64,
        param_dtype="float32", compute_dtype="float32")
