"""llama3.1-8b — the paper's own in-house benchmarking subject
(LLaMA 3.1-8B served with vLLM on H100; here the PyTorch/CUDA engine).
[arXiv:2407.21783]"""
from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="llama3.1-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab_size=128_256,
    period=(BlockSpec(),),
    rope_theta=500_000.0,
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_head=16, d_ff=128, vocab_size=256)
