"""StableLM-2-1.6B [hf:stabilityai/stablelm-2-1_6b]."""
import dataclasses

from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=5632, vocab_size=100352, head_dim=64,
    rope_theta=1e4, norm="layernorm", act="swiglu",
    source="hf:stabilityai/stablelm-2-1_6b",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="stablelm-1.6b-reduced", num_layers=2, d_model=256,
        num_heads=4, num_kv_heads=4, head_dim=64, d_ff=512, vocab_size=512,
        param_dtype="float32", compute_dtype="float32")
