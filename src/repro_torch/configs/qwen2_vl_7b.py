"""Qwen2-VL-7B — M-RoPE, dynamic-resolution VLM backbone [arXiv:2409.12191].

The ViT vision encoder + projector is STUBBED (allowed carve-out):
``input_specs`` feeds precomputed patch embeddings (batch, num_patches,
d_model) interleaved with text tokens; M-RoPE position ids (3, batch, seq)
carry the temporal/height/width coordinates of the dynamic-resolution grid.
"""
import dataclasses

from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab_size=152064, head_dim=128, qkv_bias=True,
    mrope_sections=(16, 24, 24),      # t/h/w split of head_dim/2
    rope_theta=1e6, norm="rmsnorm", act="swiglu",
    source="arXiv:2409.12191 (Qwen2-VL)",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen2-vl-7b-reduced", num_layers=2, d_model=256,
        num_heads=4, num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
        mrope_sections=(8, 12, 12),
        param_dtype="float32", compute_dtype="float32")
