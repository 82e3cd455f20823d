"""Wall and device time of llama3.1-8b decode steps on one CUDA card.

    PYTHONPATH=src python -m repro_torch.bench.decode_steps [--ii 512]
        [--oo 64] [--bb 8] [--steps 32] [--reps 3]

Builds the full-width model with seeded random weights, prefills ``bb``
prompts of ``ii`` tokens into a cache of ``ii + oo`` slots, then times
``reps`` runs of ``steps`` decode steps by the host clock (each run ends
in a synchronize), and traces one more run with torch.profiler for the
device's busy time and the decode-attention kernels' share of it.  It
prints one JSON line.  Run from two checkouts in turns on one card,
it compares their decode steps; it uses only the model's public
interface, so it runs unchanged on an older checkout.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from repro_torch.configs import get_config
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
    tok = prompts[:, -1:]

    def run(n):
        _, cache = model.prefill(prompts, a.ii + a.oo)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            _, cache = model.decode_step(cache, tok)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    steps = min(a.steps, a.oo)
    run(steps)  # warm-up
    wall = [run(steps) for _ in range(a.reps)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced = run(8)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kernels) / 1e3 / 8
    decode = sum(e.device_time_total for e in kernels
                 if "decode" in e.name) / 1e3 / 8
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps(dict(
        cell=[a.ii, a.oo, a.bb], steps=steps, wall_ms_a_step=wall,
        traced_wall_ms_a_step=traced, device_busy_ms_a_step=busy,
        decode_attention_device_ms_a_step=decode, card=smi)))


if __name__ == "__main__":
    main()
