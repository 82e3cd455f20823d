"""jamba-1.5-large-398b [hybrid] 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2 — Mamba+attn 1:7 interleave, MoE.
[arXiv:2403.19887; hf]

Period of 8 layers: one attention layer (position 3) per 7 mamba layers;
MoE FFN on every other layer (4 per period), dense SwiGLU on the rest.
"""
from repro_torch.models.config import (
    BlockSpec, ModelConfig, FFN_DENSE, FFN_MOE, MIXER_ATTN, MIXER_MAMBA)

_PERIOD = tuple(
    BlockSpec(
        mixer=MIXER_ATTN if i == 3 else MIXER_MAMBA,
        ffn=FFN_MOE if i % 2 == 1 else FFN_DENSE,
    )
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=24576, vocab_size=65_536,
    period=_PERIOD,
    n_experts=16, top_k=2, moe_d_ff=24576,
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
    rope_theta=10_000.0,
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
                         d_head=16, d_ff=128, vocab_size=256,
                         n_experts=4, moe_d_ff=128)
