"""Where a whole GBT fit's time goes in K4's ``gbt_grow``, on one CUDA card.

    PYTHONPATH=src python -m repro_torch.bench.k4_grow

Builds ``csrc/gbt_hist.cu`` a second time with ``-DGBT_GROW_PROFILE``
(thread 0 of block 0 adds the clock cycles of each part of a level into a
device array; the library ``ops.grow_fit`` loads has no such marks) and
runs each of ``cases.MAIN_FITS`` once through it.  For each fit it prints
the launch's CUDA-event ms, the microseconds a level of each part (block
0's cycles over the card's maximum SM clock, which ``nvidia-smi`` reads),
and the same fit grown level by level (``core.gbt._grow_levels``: two
launches a level) timed with CUDA events; then the card's name and power
limit.
"""
from __future__ import annotations

import ctypes
import subprocess

import torch

from repro_torch.core import gbt
from repro_torch.kernels import _build
from repro_torch.kernels.gbt_hist.cases import MAIN_FITS, fit_case, fit_state

PARTS = ("set-up", "histograms", "totals", "search", "cluster barrier",
         "decisions", "row moves", "last level")
FLAG = "-DGBT_GROW_PROFILE"


def profiled_library() -> ctypes.CDLL:
    """``csrc/gbt_hist.cu`` built with the profile marks, next to the
    kernels' own build."""
    out = _build.library_path("gbt_hist").with_suffix(".profile.so")
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._tool(), *_build.NVCC_FLAGS, FLAG, "-o",
                        str(out), str(_build.CSRC / "gbt_hist.cu")],
                       check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.gbt_grow.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 6
                             + [ctypes.c_double] * 2
                             + [ctypes.c_float, ctypes.c_void_p])
    lib.gbt_grow_profile.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def _events_ms(fn) -> float:
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1])


def _smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader,nounits"],
                          capture_output=True, text=True,
                          check=True).stdout.strip()


def profile_fit(lib, name: str, mhz: float) -> dict:
    """One ``MAIN_FITS[name]`` fit through the profiled library (after one
    warm-up fit) and through the level-by-level path."""
    L, n, f, nb, d, T, distinct = MAIN_FITS[name]
    c = fit_case(len(name), L, n, f, nb, distinct=distinct)

    def launch(s):
        code = lib.gbt_grow(*(x.data_ptr() for x in (
            s.bins, s.y, s.w, s.pred, s.grad, s.hess, s.node, s.level,
            s.feature, s.threshold, s.left, s.right, s.value, s.n_nodes)),
            L, n, f, nb, T, d, 1.0, 1.0, 0.1,
            torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"gbt_grow failed with CUDA error {code}")

    launch(fit_state(c, T, d, "cuda"))
    s = fit_state(c, T, d, "cuda")
    lib.gbt_grow_profile(None, 1)
    ms = _events_ms(lambda: launch(s))
    counts = (ctypes.c_longlong * 16)()
    lib.gbt_grow_profile(counts, 0)
    cycles = list(counts)
    searching, last = max(cycles[8], 1), max(cycles[9], 1)
    per_level = (1, searching + last, searching + last, searching,
                 searching, searching, searching, last)
    levels = fit_state(c, T, d, "cuda")
    return dict(name=name, ms=ms, levels=(cycles[8], cycles[9]),
                us={p: cycles[i] / per_level[i] / mhz
                    for i, p in enumerate(PARTS)},
                level_path_ms=_events_ms(lambda: gbt._grow_levels(
                    levels, T, d, nb, 1.0, 1.0, 0.1)))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k4_grow needs a CUDA card")
    lib = profiled_library()
    mhz = float(_smi("clocks.max.sm"))
    for name in MAIN_FITS:
        r = profile_fit(lib, name, mhz)
        L, n, f, nb, d, T, _ = MAIN_FITS[name]
        print(f"{name} (L {L}, n {n}, f {f}, {nb} bins, depth {d}, {T} "
              f"trees): gbt_grow {r['ms']:.3f} ms ({r['levels'][0]} "
              f"searching and {r['levels'][1]} last levels in block 0, "
              f"{mhz:.0f} MHz); us a level (set-up: a fit): "
              + ", ".join(f"{p} {u:.2f}" for p, u in r["us"].items())
              + f"; level by level {r['level_path_ms']:.3f} ms")
    print(_smi("name,power.limit"))


if __name__ == "__main__":
    main()
