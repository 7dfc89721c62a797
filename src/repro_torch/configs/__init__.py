"""Model configurations of the port: the LM configs, input shapes and the
arch registry (counterpart of ``repro.configs``, field for field).

Every LM architecture lives in its own module
(``src/repro_torch/configs/<id>.py``) exporting ``CONFIG`` (the published
dimensions, source cited) and ``reduced()`` (a small same-family variant for
CPU tests: <=4 layers, d_model<=512, <=4 experts).  The GNN's configurations
are in ``graphsage_paper``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense|moe|ssm|hybrid|audio|vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads
    qkv_bias: bool = False
    # MoE
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    # hybrid (zamba2): one weight-shared attention block every k ssm layers
    shared_attn_every: int = 0
    # attention
    window: int = 0                   # sliding-window size, 0 = full
    rope_theta: float = 1e6
    mrope_sections: tuple[int, ...] = ()   # M-RoPE (qwen2-vl)
    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0              # stubbed frontend frame count
    # performance knobs beyond the published models (default = baseline
    # semantics; the dry-runs flip them with their --opt flags)
    # a sharding hint of the dispatch buffer (inert without DTensors)
    moe_shard_constraints: bool = False   # explicit dispatch shardings
    moe_num_groups: int = 0               # group-local dispatch (GShard-style)
    attn_chunk: int = 0                   # online-softmax KV chunking
    prefill_last_only: bool = False       # slice h before unembed
    ce_seq_chunk: int = 0                 # chunked logits+CE (no (B,S,V) f32)
    # a sharding hint of the SSD carry (inert without DTensors)
    ssm_state_constraints: bool = False   # pin SSD scan-carry sharding
    # numerics
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    act: str = "swiglu"               # swiglu | gelu
    tie_embeddings: bool = False
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # provenance
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k decode (O(window) or O(1) cache)."""
        return self.family in ("ssm", "hybrid") or self.window > 0

    def param_count(self) -> int:
        """Analytic parameter count (drives MODEL_FLOPS in the roofline)."""
        d, f, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        qkv = d * hd * (self.num_heads + 2 * self.num_kv_heads)
        attn = qkv + self.num_heads * hd * d
        if self.qkv_bias:
            attn += hd * (self.num_heads + 2 * self.num_kv_heads)
        n_ff = 3 if self.act == "swiglu" else 2
        per_layer = 0
        if self.family == "ssm":
            per_layer = _ssm_params(self)
        elif self.family == "hybrid":
            per_layer = _ssm_params(self)
        else:
            per_layer = attn
            if self.num_experts:
                per_layer += d * self.num_experts            # router
                per_layer += self.num_experts * n_ff * d * f
            else:
                per_layer += n_ff * d * f
        total = self.num_layers * per_layer
        if self.family == "hybrid":
            total += attn + n_ff * d * f                     # one shared block
        if self.is_encdec:
            enc_attn = attn
            total += self.encoder_layers * (enc_attn + n_ff * d * f)
            total += self.num_layers * attn                  # cross-attn
        emb = V * d * (1 if self.tie_embeddings else 2)
        return total + emb

    def active_param_count(self) -> int:
        """Activated params per token (N_active for the MoE roofline)."""
        if not self.num_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        n_ff = 3 if self.act == "swiglu" else 2
        dense_expert = self.num_experts * n_ff * d * f
        active_expert = self.top_k * n_ff * d * f
        return self.param_count() - self.num_layers * (dense_expert
                                                       - active_expert)


def _ssm_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    nheads = d_in // cfg.ssm_head_dim
    n = cfg.ssm_state
    in_proj = d * (2 * d_in + 2 * n + nheads)
    conv = cfg.ssm_conv_width * (d_in + 2 * n)
    out = d_in * d
    mlp = 0
    if cfg.d_ff:
        mlp = (3 if cfg.act == "swiglu" else 2) * d * cfg.d_ff
    return in_proj + conv + out + nheads * 2 + d_in + mlp


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = [
    "minitron_4b", "whisper_small", "qwen2_7b", "mamba2_130m",
    "zamba2_1p2b", "mixtral_8x22b", "stablelm_1p6b", "h2o_danube3_4b",
    "qwen2_vl_7b", "kimi_k2_1t_a32b",
]

# public CLI ids (dashes) -> module names
ARCH_ALIASES = {
    "minitron-4b": "minitron_4b",
    "whisper-small": "whisper_small",
    "qwen2-7b": "qwen2_7b",
    "mamba2-130m": "mamba2_130m",
    "zamba2-1.2b": "zamba2_1p2b",
    "mixtral-8x22b": "mixtral_8x22b",
    "stablelm-1.6b": "stablelm_1p6b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
}


def get_config(arch: str) -> ModelConfig:
    mod_name = ARCH_ALIASES.get(arch, arch.replace("-", "_"))
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def get_reduced(arch: str) -> ModelConfig:
    mod_name = ARCH_ALIASES.get(arch, arch.replace("-", "_"))
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.reduced()


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]
