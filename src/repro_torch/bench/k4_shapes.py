"""Device time of K4's two kernels across shapes on one CUDA card.

    PYTHONPATH=src python -m repro_torch.bench.k4_shapes

Times ``build_node_histograms`` over (L, n, f, nodes, bins) shapes (rows
from 0 to 16,384, where its row tiles show) and ``split_level`` at
searching and last levels of the ALA's fits, each as device ms a launch
from torch.profiler over 20 launches after a warm-up.  Each split launch
starts from the same level: the rows, predictions and level it moves are
restored between launches and not counted.  Prints one line a shape and
the card's name and power limit.
"""
from __future__ import annotations

import subprocess

import numpy as np
import torch

from repro_torch.kernels.gbt_hist import ops as gh_ops
from repro_torch.kernels.gbt_hist.cases import level_case, level_state

HIST_SHAPES = ((1, 0, 8, 1, 64), (1, 32, 8, 1, 64), (1, 256, 8, 1, 64),
               (1, 2048, 8, 1, 64), (1, 4096, 8, 1, 64), (1, 8192, 8, 1, 64),
               (1, 16384, 8, 1, 64), (1, 8192, 8, 1, 8), (3, 48, 7, 16, 64),
               (15, 48, 7, 16, 64), (1, 32, 24, 16, 4), (1, 125, 24, 8, 4))
# (L, n, f, nodes, bins): Alg 3's and Alg 7's levels, 64 to 4 bins
SPLIT_SHAPES = ((3, 48, 7, 8, 64), (3, 48, 7, 1, 64), (15, 48, 7, 8, 64),
                (3, 48, 7, 8, 16), (3, 48, 7, 8, 4), (1, 125, 24, 8, 4),
                (3, 48, 7, 8, 128))


def device_ms(fn, kernel: str, calls: int = 20) -> float:
    """Device ms a launch of the kernels named ``kernel`` over ``calls``
    calls of ``fn`` after two warm-up calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    fn()
    torch.cuda.synchronize()
    for _ in range(3):   # again if the tracer saw no device work
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA and kernel in e.name]
        if ev:
            return sum(e.device_time_total for e in ev) / 1e3 / len(ev)
    raise RuntimeError(f"the traces show no {kernel}")


def hist_ms(L, n, f, nodes, n_bins, seed=0) -> float:
    rng = np.random.default_rng(seed)
    t = [torch.from_numpy(a).cuda() for a in (
        rng.integers(0, n_bins, (L, n, f)).astype(np.int32),
        rng.standard_normal((L, n)).astype(np.float32),
        rng.random((L, n)).astype(np.float32),
        rng.integers(0, nodes, (L, n)).astype(np.int32))]
    return device_ms(lambda: gh_ops.build_node_histograms(*t, nodes, n_bins),
                     "gbt_hist_kernel")


def split_ms(L, n, f, width, n_bins, search: bool, seed=0) -> float:
    c = level_case(seed, L, width, f, n_bins, n=n)
    c["n_valid"][:] = width
    depth = width.bit_length() - 1
    max_depth = depth + 1 if search else depth
    hist = torch.from_numpy(c["hist"]).cuda()
    start = level_state(c, 1, max_depth, "cuda")
    s = level_state(c, 1, max_depth, "cuda")

    def step():
        for k in ("pred", "node", "level"):
            getattr(s, k).copy_(getattr(start, k))
        gh_ops.split_level(hist, s, 0, depth, max_depth, 1.0, 1.0, 0.1)

    return device_ms(step, "gbt_split_kernel")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k4_shapes: needs a CUDA card")
    for shape in HIST_SHAPES:
        print(f"gbt_hist L{shape[0]} n{shape[1]} f{shape[2]} nodes{shape[3]} "
              f"bins{shape[4]}: {hist_ms(*shape):.4f} device ms")
    for shape in SPLIT_SHAPES:
        print(f"gbt_split L{shape[0]} n{shape[1]} f{shape[2]} "
              f"nodes{shape[3]} bins{shape[4]}: searching "
              f"{split_ms(*shape, True):.4f}, last level "
              f"{split_ms(*shape, False):.4f} device ms")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
