"""Model / shape configuration system.

One `ModelConfig` per assigned architecture (`repro_torch/configs/<id>.py`
holds the exact published numbers). `ShapeConfig` captures the assigned
input-shape cells (train_4k / prefill_32k / decode_32k / long_500k).

A verbatim copy of the JAX package's `models/config.py`, kept here so that
the port imports nothing of it."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

VOCAB_PAD = 256  # pad vocab to a multiple (even TP sharding; logits masked)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | encdec | vlm | xlstm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 → d_model // n_heads
    qkv_bias: bool = False
    rotary_pct: float = 1.0      # stablelm uses partial rotary
    # attention pattern
    sliding_window: int = 0      # >0: local attention window
    local_global_ratio: int = 0  # gemma3: N local layers per 1 global
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # enc-dec (seamless: encoder over stub audio frames)
    n_enc_layers: int = 0
    audio_downsample: int = 4    # S_frames = seq // downsample
    # vlm (paligemma: stub patch embeddings, prefix-LM mask)
    n_img_tokens: int = 0
    # ssm / hybrid
    ssm_state: int = 0
    mamba_expand: int = 2
    mamba_conv: int = 4
    mamba_headdim: int = 64
    attn_every: int = 0          # zamba2: shared attention every k blocks
    slstm_every: int = 0         # xlstm: sLSTM block every k blocks (0 = none)
    # numerics
    dtype: str = "bfloat16"
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    remat: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        return -(-self.vocab // VOCAB_PAD) * VOCAB_PAD

    @property
    def param_count(self) -> int:
        """Total parameters (analytic; MoE counts all experts)."""
        d, f, v, hd = self.d_model, self.d_ff, self.vocab_padded, self.hd
        att = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads + hd * self.n_heads * d
        if self.family == "xlstm":
            per = self._xlstm_params()
        elif self.family == "hybrid":
            per = self._mamba_params()
            shared = att + 3 * d * f + 2 * d * d  # one shared attn+mlp block
            return self.n_layers * per + shared + 2 * v * d
        else:
            mlp = 3 * d * f
            if self.n_experts:
                mlp = self.n_experts * 3 * d * f + d * self.n_experts
            per = att + mlp
        n = self.n_layers * per + 2 * v * d
        if self.n_enc_layers:
            n += self.n_enc_layers * (att + 3 * d * f)
        return n

    @property
    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top-k experts only)."""
        if not self.n_experts:
            return self.param_count
        d, f = self.d_model, self.d_ff
        att = (d * self.hd * self.n_heads + 2 * d * self.hd * self.n_kv_heads
               + self.hd * self.n_heads * d)
        mlp = self.top_k * 3 * d * f + d * self.n_experts
        return self.n_layers * (att + mlp) + 2 * self.vocab_padded * d

    def _xlstm_params(self) -> int:
        d = self.d_model
        di = self.mamba_expand * d
        return 2 * d * di + di * d + 3 * di * di // 4  # rough: proj + gates

    def _mamba_params(self) -> int:
        d = self.d_model
        di = self.mamba_expand * d
        nh = di // self.mamba_headdim
        return d * (2 * di + 2 * self.ssm_state + nh) + di * d


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                    # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)


def get_shape(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def long_context_capable(cfg: ModelConfig) -> bool:
    """long_500k runs only for sub-quadratic archs (DESIGN.md §4)."""
    return cfg.family in ("xlstm", "hybrid") or cfg.local_global_ratio > 0


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Smoke-test variant: same family/topology, tiny sizes."""
    base = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=256,
        vocab=512,
        head_dim=32,
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        n_enc_layers=min(cfg.n_enc_layers, 2) if cfg.n_enc_layers else 0,
        n_img_tokens=min(cfg.n_img_tokens, 16) if cfg.n_img_tokens else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        mamba_headdim=32 if cfg.ssm_state else cfg.mamba_headdim,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        attn_every=min(cfg.attn_every, 2) if cfg.attn_every else 0,
        slstm_every=cfg.slstm_every,
        dtype="float32",
        remat=False,
    )
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
