"""Kimi-K2 1T-A32B — trillion-parameter MoE, 384 experts top-8 (paper-table
config) [arXiv:2501.kimi2].

d_ff=2048 is the per-expert FFN width; 61 x 384 x 3 x 7168 x 2048 ~= 1.0e12
expert params, ~32B active per token with top-8 routing.
"""
import dataclasses

from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    d_ff=2048, vocab_size=163840, head_dim=128,
    num_experts=384, top_k=8, capacity_factor=1.25,
    rope_theta=1e6, norm="rmsnorm", act="swiglu",
    source="arXiv:2501.kimi2 (Kimi K2, paper-table)",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="kimi-k2-reduced", num_layers=2, d_model=256,
        num_heads=4, num_kv_heads=2, head_dim=64, d_ff=128, vocab_size=512,
        num_experts=4, top_k=2,
        param_dtype="float32", compute_dtype="float32")
