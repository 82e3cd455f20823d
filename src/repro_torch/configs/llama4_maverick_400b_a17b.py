"""llama4-maverick-400b-a17b [moe] 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128e top-1 — MoE, early fusion (dense/MoE
interleave).  [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.models.config import (BlockSpec, ModelConfig, FFN_DENSE,
                                       FFN_MOE)

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab_size=202_048,
    period=(BlockSpec(ffn=FFN_DENSE), BlockSpec(ffn=FFN_MOE)),
    n_experts=128, top_k=1, moe_d_ff=8192,
    rope_theta=500_000.0,
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_head=16, d_ff=128, vocab_size=256,
                         n_experts=4, moe_d_ff=128)
