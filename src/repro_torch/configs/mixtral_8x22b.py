"""Mixtral-8x22B — 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088]."""
import dataclasses

from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=32768, head_dim=128,
    num_experts=8, top_k=2, capacity_factor=1.25,
    window=4096,                      # Mixtral's SWA
    rope_theta=1e6, norm="rmsnorm", act="swiglu",
    source="arXiv:2401.04088 (Mixtral of Experts)",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="mixtral-8x22b-reduced", num_layers=2, d_model=256,
        num_heads=4, num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
        num_experts=4, top_k=2, window=64,
        param_dtype="float32", compute_dtype="float32")
