"""llama3.2-3b [dense] 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256.  [hf:meta-llama/Llama-3.2-1B; unverified]"""
from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab_size=128_256,
    period=(BlockSpec(),),
    rope_theta=500_000.0,
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_head=16, d_ff=128, vocab_size=256)
