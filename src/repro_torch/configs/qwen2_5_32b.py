"""qwen2.5-32b [dense] 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064 — GQA, QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]"""
from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=27648, vocab_size=152_064,
    period=(BlockSpec(),),
    qkv_bias=True,
    rope_theta=1_000_000.0,
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_head=16, d_ff=160, vocab_size=256)
