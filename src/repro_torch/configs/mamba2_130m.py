"""Mamba2-130M — attention-free SSD state-space model [arXiv:2405.21060]."""
import dataclasses

from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    num_layers=24, d_model=768, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, ssm_conv_width=4, ssm_expand=2,
    norm="rmsnorm", tie_embeddings=True,
    source="arXiv:2405.21060 (Mamba2 / SSD)",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="mamba2-130m-reduced", num_layers=2, d_model=128,
        ssm_state=16, ssm_head_dim=32, vocab_size=512,
        param_dtype="float32", compute_dtype="float32")
