"""Readings that the limits are set from, on the card, in one process:

    python3 perfbench/control.py --workload <name> --seeds 11,12,... \\
        --control-seeds 11,12,13 [--seconds 0.1]

For each seed it makes a whole run of the cell (``harness.run_cell``) with
a short window at the cell's own load, which still finishes the mix's
longest request and compares as many as a benchmark run does, and prints
one JSON line: the program's numbers compared and, for the control seeds,
each control's (the reference in fp8 put in the program's place), and
whether the harness's own predicate judges each correct.  It exits 1 when
a control seed's control reads correct: the limits then fail to tell the
program from it.  The benchmark's own runs never read the controls.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(prog="perfbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=0.1)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from perfbench import harness
    if not torch.cuda.is_available():
        print("perfbench/control.py: no CUDA device", file=sys.stderr)
        return 2
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    passed = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        out = harness.run_cell(ROOT, args.workload, seed, args.seconds,
                               False, "cuda", t0, controls=seed in controls)
        ctl = out.get("controls_correct", {})
        passed += [(seed, name) for name, ok in ctl.items() if ok]
        print(json.dumps(dict(
            workload=args.workload, seed=seed, correct=out["correct"],
            requests=out["attempted"], controls_correct=ctl,
            compared={k: c["value"] for k, c in out["compared"].items()},
            seconds=time.time() - t0)), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    if passed:
        print(f"perfbench/control.py: controls judged correct: {passed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
