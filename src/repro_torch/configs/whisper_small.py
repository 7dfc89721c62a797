"""Whisper-small — encoder-decoder ASR backbone [arXiv:2212.04356].

The mel-spectrogram + conv feature extractor is STUBBED (allowed carve-out):
``input_specs`` feeds precomputed frame embeddings of shape
(batch, encoder_seq, d_model).  Deviation note: positions use RoPE instead of
Whisper's learned/sinusoidal embeddings — the backbone dimensions are what
this config exercises.
"""
import dataclasses

from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=51865, head_dim=64,
    encoder_layers=12, encoder_seq=1500,      # 30 s of audio at 50 Hz
    norm="layernorm", act="gelu", rope_theta=1e4,
    source="arXiv:2212.04356 (Whisper)",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="whisper-small-reduced", num_layers=2,
        encoder_layers=2, encoder_seq=64, d_model=128, num_heads=4,
        num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512,
        param_dtype="float32", compute_dtype="float32")
