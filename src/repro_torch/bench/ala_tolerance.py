"""How far a change of histogram arithmetic alone moves the ALA's numbers.

    PYTHONPATH=src python -m repro_torch.bench.ala_tolerance

The card builds GBT histograms in fp32 (K4) where the CPU path sums in
float64.  This runs the port on the CPU both ways on the same inputs —
``use_kernel=True`` (K4's plain version, the card's arithmetic) and
``use_kernel=False`` — with the quickstart settings on ``inhouse``: the
subsets of one serial SA run and of one 4-chain run evaluated again by
``_BatchedEvaluator.evaluate_batch``, and the Alg 7 error model trained on
each log.  It prints the differences; ``chip_smoke.py`` sets its
card-against-CPU tolerances from them.
"""
from __future__ import annotations

import numpy as np

from repro_torch.bench.datasets import make_inhouse_dataset, train_test_split
from repro_torch.core.ala import ALA
from repro_torch.core.annealing import SAConfig, _BatchedEvaluator
from repro_torch.core.error_predictor import (predict_error,
                                              train_error_predictor)

SA_GBT = dict(n_estimators=40, learning_rate=0.2, max_depth=4)


def main() -> None:
    train, test = train_test_split(make_inhouse_dataset(), 0.3)
    ala = ALA(device="cpu")
    ala.cfg.sa = SAConfig(n_iters=30, gbt_kw=dict(SA_GBT))
    ala.fit(*train.workload)
    sig = [ala._signature(test.workload)]
    for name, chains in (("serial", 1), ("4 chains", 4)):
        log = ala.explore(test.workload, n_chains=chains)
        errs = [_BatchedEvaluator(train.workload, test.workload,
                                  dict(SA_GBT, use_kernel=k),
                                  device="cpu").evaluate_batch(log.subsets)
                for k in (False, True)]
        d = np.abs(errs[0] - errs[1])
        alg7 = [predict_error(train_error_predictor(
            log, device="cpu", use_kernel=k), sig, log.universes)[0]
            for k in (False, True)]
        print(f"{name} SA log, {len(log.subsets)} subsets: evaluate_batch "
              f"|fp32 - float64| median {np.median(d)!r}, p90 "
              f"{np.quantile(d, 0.9)!r}, max {d.max()!r} points; Alg 7 "
              f"error {alg7[1]!r} against {alg7[0]!r} "
              f"(|diff| {abs(alg7[1] - alg7[0])!r})")


if __name__ == "__main__":
    main()
