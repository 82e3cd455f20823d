"""The GBT fits of the main path, timed on one CUDA card for one checkout.

    python3 src/repro_torch/bench/gbt_fits.py SRC_DIR

Imports ``repro_torch`` from ``SRC_DIR`` (this checkout's ``src`` or an
older one's, unpacked beside it), so that two commits can be compared in
turns on the same card: parent, change, change, parent.  On ``inhouse``
70/30 (seed 0) it runs the ALA with the quickstart's settings (serial SA,
Alg 7, then 4 chains and Alg 7 again) and keeps ``ALA.timings``; then it
times, each with a synchronised host clock, 7 Alg 7 fits on the serial SA
log, 3 registry fits on ``suite`` and 5 fits and predictions of each
baseline GBT, and prints one JSON line with every time, the medians, the
held-out medAPE and the card's name and power limit.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main(src: str) -> None:
    sys.path.insert(0, str(Path(src).resolve()))
    import torch
    from repro_torch.bench.datasets import (load_or_make,
                                            make_inhouse_dataset,
                                            train_test_split)
    from repro_torch.core.ala import ALA
    from repro_torch.core.annealing import SAConfig
    from repro_torch.core.baselines import make_baselines
    from repro_torch.core.error_predictor import train_error_predictor
    from repro_torch.core.registry import ModelRegistry
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        raise SystemExit("gbt_fits needs a CUDA card")
    _build.build()
    train, test = (d.workload for d in
                   train_test_split(make_inhouse_dataset(), 0.3))

    def timed(fn, reps):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return dict(median=statistics.median(out), all=out)

    ala = ALA()
    ala.cfg.sa = SAConfig(n_iters=30, gbt_kw=dict(
        n_estimators=40, learning_rate=0.2, max_depth=4))
    ala.fit(*train)
    medape = ala.score(*test)
    log = ala.explore(test)
    ala.fit_error()
    times = dict(ala.timings)
    ala.explore(test, n_chains=4)
    ala.fit_error()
    times.update({f"{k}_chains": ala.timings[k]
                  for k in ("explore_s", "fit_error_s")})
    suite = load_or_make("suite")
    baselines = make_baselines()
    out = dict(src=src, ala=times, medape=medape,
               alg7_fit_s=timed(lambda: train_error_predictor(log), 7),
               registry_fit_s=timed(lambda: ModelRegistry().fit(suite), 3))
    for name in ("vanilla_xgboost", "gradient_boosting"):
        out[f"{name}_s"] = timed(
            lambda: baselines[name].fit(*train).predict(*test[:3]), 5)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1])
