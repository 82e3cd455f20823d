"""Unified model configuration, field for field as in the JAX package.

A model is described as a repeating *period* of heterogeneous blocks.  Each
block has a mixer (attention / mamba / sLSTM / mLSTM) and an optional FFN
(dense SwiGLU or MoE).  ``n_layers`` must be divisible by ``len(period)``.
Every field of the JAX ``ModelConfig`` is kept, so a config copies over
1:1; the dtype fields hold ``torch`` dtypes.  The torch ``Model`` runs
every block kind, the encoder-decoder path and the vision frontend; it
refuses sliding-window attention.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

MIXER_ATTN = "attn"
MIXER_MAMBA = "mamba"
MIXER_SLSTM = "slstm"
MIXER_MLSTM = "mlstm"

FFN_DENSE = "dense"
FFN_MOE = "moe"
FFN_NONE = "none"


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One layer of the repeating period."""

    mixer: str = MIXER_ATTN
    ffn: str = FFN_DENSE


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 128

    # Repeating block structure; default = homogeneous attention+dense.
    period: Tuple[BlockSpec, ...] = (BlockSpec(),)

    # Attention options
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 500_000.0
    causal: bool = True
    sliding_window: Optional[int] = None

    # MoE options
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0          # expert FFN width (defaults to d_ff)
    capacity_factor: float = 1.25

    # Mamba options (jamba-style)
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0     # 0 -> ceil(d_model/16)

    # xLSTM options
    xlstm_proj_factor: float = 2.0

    # Encoder-decoder (whisper-style)
    n_encoder_layers: int = 0
    encoder_seq: int = 1500    # whisper: 30s audio -> 1500 frames after conv

    # Modality frontend stub: none | audio | vision
    frontend: str = "none"
    n_patches: int = 256       # vision stub: patch embeddings prepended

    # Norm / embedding
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # vocab padded up to a multiple of this for clean TP sharding
    vocab_pad_multiple: int = 256

    # Precision
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    # -- derived ------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def n_periods(self) -> int:
        if self.n_layers % len(self.period):
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"period {len(self.period)}")
        return self.n_layers // len(self.period)

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.mamba_dt_rank or max(1, -(-self.d_model // 16))

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return all(b.mixer != MIXER_ATTN for b in self.period)

    @property
    def subquadratic(self) -> bool:
        """True when decode state does not grow quadratically with context."""
        n_attn = sum(1 for b in self.period if b.mixer == MIXER_ATTN)
        return n_attn < len(self.period) or self.attention_free

    def scaled(self, **overrides) -> "ModelConfig":
        """Return a reduced copy for smoke tests."""
        return dataclasses.replace(self, **overrides)

    # Parameter count (embedding + blocks), used for MODEL_FLOPS = 6*N*D.
    def param_count(self, active_only: bool = False) -> int:
        d, h, kv, dh = self.d_model, self.n_heads, self.n_kv_heads, self.d_head
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        total = emb
        per_period = 0
        for blk in self.period:
            if blk.mixer == MIXER_ATTN:
                per_period += d * (h * dh) + 2 * d * (kv * dh) + (h * dh) * d
                if self.qkv_bias:
                    per_period += (h + 2 * kv) * dh
            elif blk.mixer == MIXER_MAMBA:
                di, ds, dtr = self.mamba_d_inner, self.mamba_d_state, self.dt_rank
                per_period += d * 2 * di            # in_proj
                per_period += di * self.mamba_d_conv  # conv
                per_period += di * (dtr + 2 * ds)   # x_proj
                per_period += dtr * di + di         # dt_proj
                per_period += di * ds + di          # A_log, D
                per_period += di * d                # out_proj
            elif blk.mixer in (MIXER_SLSTM, MIXER_MLSTM):
                dp = int(self.xlstm_proj_factor * d)
                per_period += 4 * d * dp + 2 * d * dp  # gates-ish + up/down
            if blk.ffn == FFN_DENSE and self.d_ff > 0:
                per_period += 3 * d * self.d_ff
            elif blk.ffn == FFN_MOE:
                eff = self.expert_d_ff
                n_e = self.top_k if active_only else self.n_experts
                per_period += n_e * 3 * d * eff + d * self.n_experts
            per_period += 2 * d  # norms
        total += per_period * self.n_periods
        if self.is_encdec:
            # encoder: attn + dense ffn per layer, plus decoder cross-attn.
            enc = self.n_encoder_layers * (
                d * (h * dh) + 2 * d * (kv * dh) + (h * dh) * d
                + 3 * d * self.d_ff + 2 * d)
            cross = self.n_layers * (
                d * (h * dh) + 2 * d * (kv * dh) + (h * dh) * d + d)
            total += enc + cross
        return int(total)
