"""internvl2-1b [vlm] 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655 — InternViT + InternLM2/Qwen2 backbone.
[arXiv:2404.16821; hf]

The ViT frontend is a stub, as in the JAX package: the model takes
precomputed patch embeddings (B, n_patches, d_model), projected by
``vis_proj`` and prepended to the text sequence
(``models.io.make_batch``).
"""
from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_head=64,
    d_ff=4864, vocab_size=151_655,
    period=(BlockSpec(),),
    qkv_bias=True,
    frontend="vision", n_patches=256,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_head=16, d_ff=128, vocab_size=256, n_patches=8)
