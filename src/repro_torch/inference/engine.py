"""Batched serving engine.

Serves homogeneous batches (fixed ii -> oo at batch size bb) — the same
workload regime the paper benchmarks and that ALA models.  Prefill runs
the prompt once; decode is a plain Python loop of ``decode_step`` calls
that update the KV cache in place.

``measure_throughput`` produces (ii, oo, bb, thpt) rows by running the
model on the card.  Timers are ``time.perf_counter`` around work that ends
in ``torch.cuda.synchronize()``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.inference.sampling import sample
from repro_torch.models.transformer import Model


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray          # (B, oo)
    prefill_s: float
    decode_s: float
    tokens_per_s: float         # output-token throughput (the paper's thpt)


class ServingEngine:
    def __init__(self, model: Model, temperature: float = 0.0,
                 device=None):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"the model lives on {model.device}, the engine "
                             f"on {self.device}")
        self.model = model
        self.temperature = temperature

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, max_new_tokens: int,
                 max_len: Optional[int] = None) -> GenerationResult:
        """prompts: (B, ii) integer token ids."""
        b, ii = prompts.shape
        max_len = max_len or (ii + max_new_tokens)
        vocab = self.model.cfg.vocab_size
        # a fixed seed, as the JAX engine samples with fixed keys
        gen = torch.Generator(device=self.device).manual_seed(0)
        tokens = torch.as_tensor(prompts, dtype=torch.int64,
                                 device=self.device)
        t0 = time.perf_counter()
        logits, cache = self.model.prefill(tokens, max_len)
        tok = sample(logits, gen, temperature=self.temperature,
                     vocab_size=vocab)
        self._sync()
        t1 = time.perf_counter()
        toks = [tok]
        for _ in range(max_new_tokens - 1):
            logits, cache = self.model.decode_step(cache, tok)
            tok = sample(logits, gen, temperature=self.temperature,
                         vocab_size=vocab)
            toks.append(tok)
        self._sync()
        t2 = time.perf_counter()
        out = torch.cat(toks, dim=1).cpu().numpy().astype(np.int32)
        return GenerationResult(
            tokens=out, prefill_s=t1 - t0, decode_s=t2 - t1,
            tokens_per_s=b * max_new_tokens / max(t2 - t0, 1e-9))

    # -- benchmarking path ---------------------------------------------------
    def measure_throughput(self, ii: int, oo: int, bb: int, reps: int = 3,
                           seed: int = 0, warmup: int = 1) -> List[Dict]:
        rng = np.random.default_rng(seed)
        rows = []
        for r in range(warmup + reps):
            prompts = rng.integers(
                0, self.model.cfg.vocab_size, size=(bb, ii), dtype=np.int32)
            res = self.generate(prompts, oo)
            if r >= warmup:
                rows.append(dict(ii=ii, oo=oo, bb=bb,
                                 thpt=res.tokens_per_s,
                                 prefill_s=res.prefill_s,
                                 decode_s=res.decode_s))
        return rows
