"""Architecture registry: ``get_config(arch_id)`` + smoke-size reductions.

Every arch of the JAX package: the five dense ones (attention + SwiGLU
blocks, with QKV bias, QK-norm and tied embeddings where their configs
ask for them), the two MoE ones, xLSTM's recurrent blocks, jamba's
Mamba + attention + MoE hybrid, whisper's encoder-decoder and
internvl2's vision frontend (both frontends stubs, as in the JAX
package: the model takes precomputed frame or patch embeddings).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "llama3.1-8b": "llama3_1_8b",
    "llama3.2-3b": "llama3_2_3b",
    "qwen2.5-32b": "qwen2_5_32b",
    "command-r-35b": "command_r_35b",
    "qwen3-0.6b": "qwen3_0_6b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b_a6_6b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "xlstm-125m": "xlstm_125m",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "whisper-medium": "whisper_medium",
    "internvl2-1b": "internvl2_1b",
}
ARCHS = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke()
