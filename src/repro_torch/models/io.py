"""Model input construction: input specs and concrete batches (tests / real
runs) from an (arch config, ShapeSpec) cell.

The arrays are drawn as the JAX package draws them, with numpy's
``default_rng(seed)`` in the same order (tokens, labels, then frames or
patches), and only then made tensors, so a seed gives the same batch bit
for bit in both packages.  ``draw`` takes the generator itself, so that
a caller drawing one request after another (``ServingEngine.
measure_throughput``) continues one stream.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models.config import ModelConfig


def _token_shapes(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, tuple]:
    b, s = shape.global_batch, shape.seq_len
    out = {}
    if shape.kind in ("train", "prefill"):
        if cfg.frontend == "vision":
            text = s - cfg.n_patches
            out["tokens"] = (b, text)
            out["patches"] = (b, cfg.n_patches, cfg.d_model)
            if shape.kind == "train":
                out["labels"] = (b, text)
        else:
            out["tokens"] = (b, s)
            if shape.kind == "train":
                out["labels"] = (b, s)
        if cfg.frontend == "audio":
            out["frames"] = (b, cfg.encoder_seq, cfg.d_model)
    else:  # decode
        out["tokens"] = (b, 1)
    return out


def input_specs(cfg: ModelConfig,
                shape: ShapeSpec) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """``{name: (shape, dtype)}`` of a batch: int32 token ids (and
    labels), frames or patches in ``cfg.compute_dtype``."""
    return {name: (shp, torch.int32 if name in ("tokens", "labels")
                   else cfg.compute_dtype)
            for name, shp in _token_shapes(cfg, shape).items()}


def draw(cfg: ModelConfig, shape: ShapeSpec,
         rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """The batch's numpy arrays drawn from ``rng``: token ids in
    [0, vocab_size) as int32, frames or patches standard normal in
    float32 (cast by ``make_batch``)."""
    batch = {}
    for name, shp in _token_shapes(cfg, shape).items():
        if name in ("tokens", "labels"):
            batch[name] = rng.integers(0, cfg.vocab_size, size=shp,
                                       dtype=np.int32)
        else:
            batch[name] = rng.standard_normal(shp, dtype=np.float32)
    return batch


def make_batch(cfg: ModelConfig, shape: ShapeSpec, seed: int = 0,
               device="cpu") -> Dict[str, torch.Tensor]:
    """Concrete random batch matching ``input_specs``, on ``device``: ids
    int32, frames and patches rounded to ``cfg.compute_dtype`` (as
    ``jnp.asarray`` rounds them)."""
    arrays = draw(cfg, shape, np.random.default_rng(seed))
    return {name: torch.from_numpy(a).to(
        device, dtype=None if a.dtype == np.int32 else cfg.compute_dtype)
        for name, a in arrays.items()}
