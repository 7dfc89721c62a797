"""Qwen2-7B — GQA with QKV bias [arXiv:2407.10671]."""
import dataclasses

from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b", family="dense",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab_size=152064, head_dim=128, qkv_bias=True,
    rope_theta=1e6, norm="rmsnorm", act="swiglu",
    source="arXiv:2407.10671 (Qwen2)",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen2-7b-reduced", num_layers=2, d_model=256,
        num_heads=4, num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
        param_dtype="float32", compute_dtype="float32")
