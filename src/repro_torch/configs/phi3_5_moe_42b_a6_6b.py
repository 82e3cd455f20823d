"""phi3.5-moe-42b-a6.6b [moe] 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16e top-2.  [hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from repro_torch.models.config import BlockSpec, ModelConfig, FFN_MOE

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=6400, vocab_size=32_064,
    period=(BlockSpec(ffn=FFN_MOE),),
    n_experts=16, top_k=2, moe_d_ff=6400,
    rope_theta=10_000.0,
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_head=16, d_ff=128, vocab_size=256,
                         n_experts=4, moe_d_ff=128)
