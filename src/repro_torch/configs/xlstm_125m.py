"""xlstm-125m [ssm] 12L d_model=768 4H (GQA kv=4) d_ff=0 vocab=50304 —
sLSTM + mLSTM blocks (alternating).  [arXiv:2405.04517; unverified]

d_ff=0: xLSTM blocks own their up/down projections; there is no separate
FFN sub-block.
"""
from repro_torch.models.config import (
    BlockSpec, ModelConfig, FFN_NONE, MIXER_MLSTM, MIXER_SLSTM)

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, d_head=192,
    d_ff=0, vocab_size=50_304,
    period=(BlockSpec(mixer=MIXER_SLSTM, ffn=FFN_NONE),
            BlockSpec(mixer=MIXER_MLSTM, ffn=FFN_NONE)),
    xlstm_proj_factor=2.0,
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                         d_head=16, vocab_size=256)
