"""Minitron-4B — width/depth-pruned Nemotron [arXiv:2407.14679]."""
import dataclasses

from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", family="dense",
    num_layers=32, d_model=3072, num_heads=24, num_kv_heads=8,
    d_ff=9216, vocab_size=256000, head_dim=128,
    act="gelu",                       # Minitron keeps Nemotron's squared-ReLU
                                      # family MLP (2-matrix); gelu variant
    rope_theta=1e4, norm="rmsnorm",
    source="arXiv:2407.14679 (pruned Nemotron-4)",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="minitron-4b-reduced", num_layers=2, d_model=256,
        num_heads=4, num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
        param_dtype="float32", compute_dtype="float32")
