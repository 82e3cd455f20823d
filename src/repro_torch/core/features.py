"""Feature engineering for the parameter predictor (paper Alg 3)."""
from __future__ import annotations

import numpy as np

FEATURE_NAMES = ("ii", "oo", "log_ii", "log_oo", "log_bb",
                 "ii_oo_ratio", "ii_ii_ratio")


def engineer(ii: np.ndarray, oo: np.ndarray) -> np.ndarray:
    """(n,) x2 -> (n, 7) feature matrix, exactly the paper's transforms."""
    ii = np.asarray(ii, np.float64)
    oo = np.asarray(oo, np.float64)
    log_ii = np.log1p(ii)
    log_oo = np.log1p(oo)
    log_bb = np.log1p(ii / np.maximum(oo, 1e-12))
    ii_oo_ratio = ii / (oo + 1.0)
    ii_ii_ratio = ii / (ii + 1.0)
    return np.stack([ii, oo, log_ii, log_oo, log_bb,
                     ii_oo_ratio, ii_ii_ratio], axis=1)
