"""Architecture registry: ``get_config(arch_id)`` + smoke-size reductions.

Only the archs the torch model can run are ported: the five dense ones
(attention + SwiGLU blocks, with QKV bias, QK-norm and tied embeddings
where their configs ask for them), the two MoE ones, xLSTM's recurrent
blocks and jamba's Mamba + attention + MoE hybrid.  The encoder and
vision archs keep their names here so that a lookup says where they
stand instead of "unknown".
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
}
ARCHS = tuple(_MODULES)

# Archs of the JAX package that later slices port (ROADMAP queue A).
_NOT_YET_PORTED = (
    "whisper-medium",
    "internvl2-1b",
)


def _module(arch: str):
    if arch in _NOT_YET_PORTED:
        raise KeyError(f"arch {arch!r} is not ported to torch yet; it comes "
                       f"with a later slice (ROADMAP queue A). Ported: "
                       f"{list(ARCHS)}")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke()
