"""whisper-medium [audio] 24L d_model=1024 16H (kv=16) d_ff=4096
vocab=51865 — enc-dec, conv frontend (stub).  [arXiv:2212.04356; unverified]

The conv frontend is a stub, as in the JAX package: the model takes
precomputed frame embeddings (B, encoder_seq, d_model)
(``models.io.make_batch``).
"""
from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_head=64,
    d_ff=4096, vocab_size=51_865,
    period=(BlockSpec(),),
    n_encoder_layers=24, encoder_seq=1500,
    frontend="audio",
    rope_theta=10_000.0,
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                         d_head=16, d_ff=128, vocab_size=256,
                         n_encoder_layers=2, encoder_seq=32)
