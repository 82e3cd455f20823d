"""Deterministic, resumable synthetic LM data pipeline.

A copy of the reference package's ``data/pipeline.py`` (numpy only): the
port keeps its own because it imports nothing of the reference, and its
batches are the reference's bit for bit.

Batches are a pure function of (seed, step): restart at step k reproduces
exactly the batch stream a non-failing run would have seen — the data-side
half of fault tolerance.  The generator synthesizes power-law token
streams with local n-gram structure so the training loss actually
decreases, while remaining fully offline.  Batches are numpy arrays; the
trainer moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class PipelineConfig:
    seed: int = 0
    zipf_a: float = 1.2          # vocabulary power law
    ngram_order: int = 3
    ngram_strength: float = 0.7  # prob. of following the n-gram process


class SyntheticPipeline:
    def __init__(self, cfg: ModelConfig, shape: ShapeSpec,
                 pcfg: Optional[PipelineConfig] = None):
        self.cfg = cfg
        self.shape = shape
        self.pcfg = pcfg or PipelineConfig()
        # deterministic n-gram transition hash parameters
        root = np.random.default_rng(self.pcfg.seed)
        self._mix = root.integers(1, 2**31 - 1, size=self.pcfg.ngram_order)
        self._bias = int(root.integers(0, 2**31 - 1))

    def _next_token(self, ctx: np.ndarray, rnd: np.ndarray) -> np.ndarray:
        """Hash-based deterministic 'n-gram LM' over the vocab."""
        v = self.cfg.vocab_size
        h = (ctx @ self._mix + self._bias) % (2**31 - 1)
        ngram_tok = (h % max(v // 8, 2)).astype(np.int32)
        follow = rnd < self.pcfg.ngram_strength
        return np.where(follow, ngram_tok, -1)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.pcfg.seed, step]))
        b = self.shape.global_batch
        s = self.shape.seq_len
        v = self.cfg.vocab_size
        order = self.pcfg.ngram_order
        # base zipf stream (clipped to vocab)
        base = rng.zipf(self.pcfg.zipf_a, size=(b, s + 1)).astype(np.int64)
        toks = (base % v).astype(np.int32)
        # overwrite with n-gram process where 'follow' fires
        rnd = rng.random((b, s + 1))
        for t in range(order, s + 1):
            nxt = self._next_token(toks[:, t - order:t], rnd[:, t])
            toks[:, t] = np.where(nxt >= 0, nxt, toks[:, t])
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.frontend == "vision":
            p = self.cfg.n_patches
            text = s - p
            batch = {"tokens": toks[:, :text], "labels": toks[:, 1:text + 1],
                     "patches": rng.standard_normal(
                         (b, p, self.cfg.d_model)).astype(np.float32)}
        if self.cfg.frontend == "audio":
            batch["frames"] = rng.standard_normal(
                (b, self.cfg.encoder_seq, self.cfg.d_model)
            ).astype(np.float32)
        return batch
