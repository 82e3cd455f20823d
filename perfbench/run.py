"""Runs one cell of the port's benchmark once and prints its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``src/repro_torch``.  It refuses to
run without a CUDA card (exit 2).  Every build and kernel cache it or the
program writes lies inside the checkout: the program's kernels under
``build/repro_torch/``, the rest under ``perfbench/out/``.
"""
import os
import sys
import time
from pathlib import Path

T_IMPORT = time.time()
ROOT = Path(__file__).resolve().parent.parent
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton",
          "TORCHINDUCTOR_CACHE_DIR": "inductor",
          "CUDA_CACHE_PATH": "nv_compute_cache"}


def process_start() -> float:
    """The wall-clock time this process started, from /proc (the module's
    import time where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.time() - age
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def main() -> int:
    started = process_start()
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"perfbench: no src/repro_torch under {ROOT}", file=sys.stderr)
        return 2
    out = ROOT / "perfbench" / "out"
    for var, sub in CACHES.items():
        os.environ[var] = str(out / sub)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench import harness
    try:
        return harness.main(sys.argv[1:], ROOT, started)
    except harness.RunError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
