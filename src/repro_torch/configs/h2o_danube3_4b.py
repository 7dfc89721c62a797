"""H2O-Danube3-4B — llama+mistral mix with sliding-window attention
[arXiv:2401.16818]."""
import dataclasses

from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    num_layers=24, d_model=3840, num_heads=32, num_kv_heads=8,
    d_ff=10240, vocab_size=32000, head_dim=120,
    window=4096,                      # mistral-style SWA
    rope_theta=1e4, norm="rmsnorm", act="swiglu",
    source="arXiv:2401.16818 (H2O-Danube)",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="h2o-danube-3-4b-reduced", num_layers=2, d_model=256,
        num_heads=4, num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
        window=64, param_dtype="float32", compute_dtype="float32")
