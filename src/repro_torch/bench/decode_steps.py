"""Wall and device time of llama3.1-8b decode steps on one CUDA card,
eager and replayed as a CUDA graph, in the same run.

    PYTHONPATH=src python -m repro_torch.bench.decode_steps [--ii 512]
        [--oo 64] [--bb 8] [--steps 32] [--reps 3]

Builds the full-width model with seeded random weights and one
``DecodeGraph`` at (bb, ii + oo).  Each run prefills ``bb`` prompts of
``ii`` tokens into the graph's cache, then times ``steps`` decode steps by
the host clock (ending in a synchronize; the prefill is not timed):
eager ``decode_step`` calls, or graph replays, on the same cache and
model, in turns (eager, graphed, graphed, eager, ...) for ``reps``
rounds.  One more run of 8 steps each way is traced with torch.profiler
(the steps alone) for the device's busy time and share, and the
decode-attention and RMSNorm kernels' device time and launches a step.
It prints one JSON line.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import time

import torch

from repro_torch.configs import get_config
from repro_torch.inference.engine import DecodeGraph
from repro_torch.models.transformer import Model


def main() -> None:
    ap = argparse.ArgumentParser()
    for name, default in (("ii", 512), ("oo", 64), ("bb", 8), ("steps", 32),
                          ("reps", 3)):
        ap.add_argument(f"--{name}", type=int, default=default)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("decode_steps: needs a CUDA card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config("llama3.1-8b")
    model = Model(cfg).init(torch.Generator("cuda").manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (a.bb, a.ii), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(3))
    graph = DecodeGraph(model, a.bb, a.ii + a.oo)

    def eager():
        """Prefills into the graph's cache; returns a run of n eager
        steps."""
        _, cache = model.prefill(prompts, cache=graph.cache)

        def run(n, cache=cache, tok=prompts[:, -1:]):
            for _ in range(n):
                _, cache = model.decode_step(cache, tok)
        return run

    def graphed():
        """Prefills into the graph's cache; returns a run of n replays."""
        model.prefill(prompts, cache=graph.cache)
        graph.start(prompts[:, -1:])

        def run(n):
            for _ in range(n):
                graph.replay()
        return run

    def timed(make, n, prof=None):
        """ms a step of n steps after a prefill, the steps alone timed
        (and traced, given a profiler)."""
        run = make()
        torch.cuda.synchronize()
        with prof or contextlib.nullcontext():
            t0 = time.perf_counter()
            run(n)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / n

    steps = min(a.steps, a.oo - 1)
    timed(eager, steps), timed(graphed, steps)  # warm-up
    wall = {"eager": [], "graphed": []}
    for r in range(a.reps):
        for make in ((eager, graphed) if r % 2 == 0 else (graphed, eager)):
            wall[make.__name__].append(timed(make, steps))
    traced = {}
    for make in (eager, graphed):
        prof = profile(activities=[ProfilerActivity.CUDA])
        ms = timed(make, 8, prof)
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        busy = sum(e.device_time_total for e in kernels) / 1e3 / 8
        traced[make.__name__] = dict(
            wall_ms_a_step=ms, device_busy_ms_a_step=busy,
            busy_share=busy / ms,
            **{f"{k}_device_ms_a_step": sum(
                e.device_time_total for e in kernels if k in e.name) / 1e3 / 8
               for k in ("decode_attn", "rmsnorm")},
            **{f"{k}_launches_a_step": sum(
                k in e.name for e in kernels) / 8
               for k in ("decode_attn", "rmsnorm")})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps(dict(
        cell=[a.ii, a.oo, a.bb], steps=steps,
        eager_wall_ms_a_step=wall["eager"],
        graphed_wall_ms_a_step=wall["graphed"], traced=traced, card=smi)))


if __name__ == "__main__":
    main()
