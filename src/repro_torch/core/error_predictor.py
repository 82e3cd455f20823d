"""Error predictor over SA logs (paper Alg 7).

Each logged subset is encoded as a binary membership vector over the
universal value sets (unique_ii | unique_bb | unique_oo, in the paper's
order); an XGBoost-style GBT regresses the observed median-APE.

``predict_error(..., backend="torch")`` routes a whole batch of encoded
signatures through the ``PackedForest`` gather traversal on the device in
one call — the path ``ALA.estimate_batch`` uses; the default numpy
backend stays the serial reference (same trees, same leaves, identical
up to float summation order).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.core.annealing import SALog, Subset
from repro_torch.core.gbt import GBTRegressor


def encode_subset(subset: Subset, universes: Dict[str, np.ndarray]) -> np.ndarray:
    parts = []
    for dim in ("ii", "bb", "oo"):          # paper's Alg 7 ordering
        u = universes[dim]
        s = subset[dim]
        parts.append(np.isin(u, list(s)).astype(np.float64))
    return np.concatenate(parts)


def encode_subsets(subsets: List[Subset],
                   universes: Dict[str, np.ndarray]) -> np.ndarray:
    """(S, D) stacked membership matrix — the batched encoder."""
    return np.stack([encode_subset(s, universes) for s in subsets])


def train_error_predictor(log: SALog, device=None,
                          **gbt_kw) -> GBTRegressor:
    """Alg 7's GBT on the log's encoded subsets, on ``device`` (None: the
    GPU)."""
    X = encode_subsets(log.subsets, log.universes)
    y = np.asarray(log.errors, np.float64)
    kw = dict(n_estimators=200, learning_rate=0.05, max_depth=4, n_bins=4)
    kw.update(gbt_kw)
    model = GBTRegressor(device=device, **kw)
    model.fit(X, y)
    return model


def predict_error(model: GBTRegressor, subsets: List[Subset],
                  universes: Dict[str, np.ndarray],
                  backend: str = "numpy") -> np.ndarray:
    X = encode_subsets(subsets, universes)
    return model.predict(X, backend=backend)
