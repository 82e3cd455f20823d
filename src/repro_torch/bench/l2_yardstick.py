"""How ``chip_smoke.py``'s timing reads a bytes-bound kernel whose output
fits in the L2, on one CUDA card.

    PYTHONPATH=src python -m repro_torch.bench.l2_yardstick [--rows 12288] [--d 896] [--passes 4]

K1 (``rmsnorm``) and a ``copy_`` of the same bytes, bf16, their inputs
rotated over enough sets to exceed the L2 three times (as
``chip_smoke._n_sets``), under two output policies: ``reused``, each
call's output freed at once, so the allocator hands the same block back
and (for ``copy_``) one destination for all calls; and ``held``, each
output kept until its input set comes round again, so outputs rotate
through as many buffers as the inputs.  For each pass it prints the
device ms a launch read two ways: torch.profiler's kernel events (for
``copy_`` every kernel, a call being one), divided by the events it
found (their count beside it), and CUDA events around the replay of a
CUDA graph of 20 calls; then the bytes bound at 3.35 TB/s and the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import math
import subprocess

import torch

from repro_torch.kernels.rmsnorm import ops as rms_ops

L2_BYTES, PEAK_BYTES, CALLS = 50e6, 3.35e12, 20


def _calls(fn, sets, policy):
    """``CALLS`` calls of ``fn`` over ``sets`` in turn under ``policy``."""
    outs = [None] * len(sets)
    for i in range(CALLS):
        out = fn(*sets[i % len(sets)])
        if policy == "held":
            outs[i % len(sets)] = out
        del out


def profiler_ms(fn, sets, policy, kernel):
    """(device ms a launch, launches the trace holds) of the kernels whose
    names hold ``kernel`` ("" matches every kernel) over ``CALLS``
    calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    _calls(fn, sets, policy)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _calls(fn, sets, policy)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and kernel in e.name]
    total = sum(e.device_time_total for e in events) / 1e3
    return (total / len(events) if events else math.nan), len(events)


def graph_ms(fn, sets, policy):
    """Device ms a call from CUDA events around replays of a graph of
    ``CALLS`` calls (the calls' own memory from the graph's pool)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _calls(fn, sets, policy)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _calls(fn, sets, policy)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * CALLS)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=12288)
    ap.add_argument("--d", type=int, default=896)
    ap.add_argument("--passes", type=int, default=4)
    args = ap.parse_args()
    rows, d = args.rows, args.d
    nbytes = 2 * rows * d * 2          # one bf16 read and one write
    n = max(2, math.ceil(3 * L2_BYTES / nbytes))
    gen = torch.Generator("cuda").manual_seed(0)
    xs = [torch.randn((rows, d), generator=gen, device="cuda").bfloat16()
          for _ in range(n)]
    dsts = [torch.empty_like(x) for x in xs]
    scale = torch.ones(d, device="cuda")
    cases = {
        "rmsnorm": ({"reused": [(x, scale) for x in xs],
                     "held": [(x, scale) for x in xs]},
                    rms_ops.rmsnorm, "rmsnorm"),
        "copy_": ({"reused": [(dsts[0], x) for x in xs],
                   "held": list(zip(dsts, xs))},
                  lambda dst, src: dst.copy_(src), ""),
    }
    print(f"{rows} x {d} bf16, {n} input sets, bound "
          f"{1e3 * (nbytes + 4 * d) / PEAK_BYTES:.4f} ms (bytes at 3.35 "
          f"TB/s)")
    for p in range(args.passes):
        for name, (sets, fn, kernel) in cases.items():
            for policy in ("reused", "held"):
                ms, found = profiler_ms(fn, sets[policy], policy, kernel)
                g = graph_ms(fn, sets[policy], policy)
                print(f"pass {p} {name} {policy}: profiler {ms:.4f} device "
                      f"ms a launch ({found} of {CALLS} launches in the "
                      f"trace), graph {g:.4f} ms a call")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())


if __name__ == "__main__":
    main()
