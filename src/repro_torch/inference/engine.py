"""Batched serving engine.

Serves homogeneous batches (fixed ii -> oo at batch size bb) — the same
workload regime the paper benchmarks and that ALA models.  Prefill runs
the prompt once.  On a card, decode replays one CUDA graph a step
(``DecodeGraph``): the step, greedy sampling included, is captured once
for each (batch, max_len) signature, as the JAX engine jits its decode
scan once for each signature, so the timed loop runs compiled steps, not
Python dispatch.  On the CPU, decode is a plain Python loop of
``decode_step`` calls that update the decode cache in place.

``measure_throughput`` produces (ii, oo, bb, thpt) rows by running the
model on the card.  A model with a stub frontend takes its frames or
patches through ``generate``'s ``inputs`` (a hook the JAX engine lacks:
it serves tokens only); ``measure_throughput`` draws them seeded with
each request's prompts, as ``models.io`` draws a batch.  Timers are
``time.perf_counter`` around work that ends in
``torch.cuda.synchronize()``; capture happens before them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.device import resolve_device
from repro_torch.inference.sampling import sample
from repro_torch.models import io
from repro_torch.models.transformer import Model
from repro_torch.compiles import note_compile


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray          # (B, oo)
    prefill_s: float
    decode_s: float
    tokens_per_s: float         # output-token throughput (the paper's thpt)


class DecodeGraph:
    """One decode step of ``model`` at (batch, max_len), captured as a CUDA
    graph on buffers it owns: the decode cache and its ``pos_t``, the input
    token ``tok`` (B, 1), the step's ``logits`` (B, 1, V) and ``history``
    (B, max_len + 1), where each replay writes the greedy next token at its
    position.  A replay reads ``tok`` and ``pos_t``, writes K/V at pos_t
    and each recurrent block's next state in place, the logits, the greedy
    token into ``tok`` and ``history``, and advances pos_t: replays in a
    row decode greedily with no host work between.

    Before the capture one eager step runs on a side stream, so kernel
    builds, function attributes and cuBLAS workspaces are set up outside
    it (its launches count like any other); the cache's states and
    ``pos_t`` are zeroed after.  Fill the cache with
    ``model.prefill(..., cache=graph.cache)`` (with the frames where the
    model takes them: their cross K/V land in the captured buffers too).
    The launch counters of the captured kernels tick once, at capture,
    not at replays; a capture counts as one compilation for
    ``staticcheck.tracers.assert_max_compiles``."""

    @torch.inference_mode()
    def __init__(self, model: Model, batch: int, max_len: int):
        self.model = model
        self.signature = (batch, max_len)
        self.cache = model.init_cache(batch, max_len)
        dev = model.device
        self.tok = torch.zeros((batch, 1), dtype=torch.int64, device=dev)
        self.history = torch.zeros((batch, max_len + 1), dtype=torch.int64,
                                   device=dev)
        self._capture()

    def _capture(self) -> None:
        dev = self.model.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._step()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.cache.pos_t.zero_()
        # the captured graph is kept beside its instance, so that
        # ``kernel_names`` can list its nodes; instantiated here, not at the
        # first replay
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(self.graph):
            self.logits = self._step()
        self.graph.instantiate()
        note_compile("capture")
        self.cache.zero_()
        torch.cuda.synchronize(dev)

    def _step(self):
        logits, _ = self.model.decode_step(self.cache, self.tok)
        nxt = sample(logits, vocab_size=self.model.cfg.vocab_size)
        self.tok.copy_(nxt)
        self.history.index_copy_(1, self.cache.pos_t, nxt)
        return logits

    @torch.inference_mode()
    def start(self, tok) -> None:
        """Takes the token sampled from the prefill's logits as the first
        replay's input, and as the history's entry at pos_t."""
        self.tok.copy_(tok)
        self.history.index_copy_(1, self.cache.pos_t, tok)

    def replay(self) -> None:
        self.graph.replay()

    def kernel_names(self) -> List[str]:
        """The names of the kernels one replay launches, in the graph's node
        order, read from the captured graph through the CUDA driver (12.3 or
        later): what a replay runs, independent of any tracer."""
        import ctypes
        cu = ctypes.CDLL("libcuda.so.1")
        ptr, size_p = ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)
        for fn, args in (("cuGraphGetNodes", [ptr, ptr, size_p]),
                         ("cuGraphNodeGetType", [ptr, ptr]),
                         ("cuGraphKernelNodeGetParams_v2", [ptr, ptr]),
                         ("cuFuncGetName", [ptr, ptr]),
                         ("cuKernelGetName", [ptr, ptr])):
            f = getattr(cu, fn)
            f.argtypes, f.restype = args, ctypes.c_int

        def check(rc, what):
            if rc != 0:
                raise RuntimeError(f"{what} failed with CUresult {rc}")

        graph = ptr(self.graph.raw_cuda_graph())
        n = ctypes.c_size_t(0)
        check(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)),
              "cuGraphGetNodes")
        nodes = (ptr * n.value)()
        check(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)),
              "cuGraphGetNodes")
        names = []
        for node in nodes:
            kind = ctypes.c_int(-1)
            check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)),
                  "cuGraphNodeGetType")
            if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
                continue
            # CUDA_KERNEL_NODE_PARAMS_v2: func at byte 0, kern at byte 56
            params = (ctypes.c_uint64 * 16)()
            check(cu.cuGraphKernelNodeGetParams_v2(node, params),
                  "cuGraphKernelNodeGetParams")
            name = ctypes.c_char_p()
            if params[0]:
                check(cu.cuFuncGetName(ctypes.byref(name), ptr(params[0])),
                      "cuFuncGetName")
            else:
                check(cu.cuKernelGetName(ctypes.byref(name), ptr(params[7])),
                      "cuKernelGetName")
            names.append(name.value.decode())
        return names


class ServingEngine:
    def __init__(self, model: Model, temperature: float = 0.0,
                 device=None):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"the model lives on {model.device}, the engine "
                             f"on {self.device}")
        self.model = model
        self.temperature = temperature
        self._graph: Optional[DecodeGraph] = None
        self.captures = 0   # decode graphs captured
        self.replays = 0    # decode steps replayed

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def decode_graph(self, batch: int, max_len: int) -> DecodeGraph:
        """The decode graph of (batch, max_len), captured now unless it is
        the one held; only one is held at a time."""
        g = self._graph
        if g is None or g.signature != (batch, max_len):
            self._graph = g = None  # free the old one before capturing
            g = self._graph = DecodeGraph(self.model, batch, max_len)
            self.captures += 1
        return g

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, max_new_tokens: int,
                 max_len: Optional[int] = None,
                 inputs: Optional[Dict] = None) -> GenerationResult:
        """prompts: (B, ii) integer token ids; ``inputs``: what else the
        model's prefill takes (``frames`` or ``patches``, arrays or
        tensors), moved to the device before the clock starts.  The cache
        holds ``model.n_prefix`` positions before the prompt (the vision
        stub's patches) and ``max_len`` in all."""
        b, ii = prompts.shape
        seq = self.model.n_prefix + ii
        max_len = max_len or (seq + max_new_tokens)
        if seq + max_new_tokens - 1 > max_len:
            raise ValueError(f"{seq} + {max_new_tokens} positions need more "
                             f"than {max_len} cache slots")
        vocab = self.model.cfg.vocab_size
        extra = {k: torch.as_tensor(v).to(self.device,
                                          self.model.cfg.compute_dtype)
                 for k, v in (inputs or {}).items()}
        # a fixed seed, as the JAX engine samples with fixed keys
        gen = torch.Generator(device=self.device).manual_seed(0)
        tokens = torch.as_tensor(prompts, dtype=torch.int64,
                                 device=self.device)
        graph = (self.decode_graph(b, max_len)
                 if self.device.type == "cuda" else None)
        t0 = time.perf_counter()
        logits, cache = self.model.prefill(
            tokens, max_len, cache=graph.cache if graph else None, **extra)
        tok = sample(logits, gen, temperature=self.temperature,
                     vocab_size=vocab)
        self._sync()
        t1 = time.perf_counter()
        toks = [tok]
        if graph is None:
            for _ in range(max_new_tokens - 1):
                logits, cache = self.model.decode_step(cache, tok)
                tok = sample(logits, gen, temperature=self.temperature,
                             vocab_size=vocab)
                toks.append(tok)
        else:
            graph.start(tok)
            for _ in range(max_new_tokens - 1):
                graph.replay()
                if self.temperature > 0.0:
                    tok = sample(graph.logits, gen,
                                 temperature=self.temperature,
                                 vocab_size=vocab)
                    graph.tok.copy_(tok)
                    toks.append(tok)
            self.replays += max_new_tokens - 1
            if self.temperature <= 0.0:
                toks = [graph.history[:, seq:seq + max_new_tokens]]
        self._sync()
        t2 = time.perf_counter()
        out = torch.cat(toks, dim=1).cpu().numpy().astype(np.int32)
        return GenerationResult(
            tokens=out, prefill_s=t1 - t0, decode_s=t2 - t1,
            tokens_per_s=b * max_new_tokens / max(t2 - t0, 1e-9))

    # -- benchmarking path ---------------------------------------------------
    def measure_throughput(self, ii: int, oo: int, bb: int, reps: int = 3,
                           seed: int = 0, warmup: int = 1) -> List[Dict]:
        """Rows of ``warmup + reps`` requests of ``bb`` prompts of ``ii``
        tokens and ``oo`` new ones, the warm-up dropped.  Each request's
        prompts (and frames or patches) are drawn from one
        ``default_rng(seed)`` stream in ``io.draw``'s order."""
        rng = np.random.default_rng(seed)
        shape = ShapeSpec("request", self.model.n_prefix + ii, bb, "prefill")
        rows = []
        for r in range(warmup + reps):
            batch = io.draw(self.model.cfg, shape, rng)
            res = self.generate(batch.pop("tokens"), oo, inputs=batch)
            if r >= warmup:
                rows.append(dict(ii=ii, oo=oo, bb=bb,
                                 thpt=res.tokens_per_s,
                                 prefill_s=res.prefill_s,
                                 decode_s=res.decode_s))
        return rows
