"""Parameter predictor (paper Alg 3) + throughput prediction (Alg 5)."""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.database import ExpDatabase
from repro_torch.core.expmodel import exp_model
from repro_torch.core.features import engineer
from repro_torch.core.gbt import MultiOutputGBT


_DEFAULT_KW = dict(n_estimators=150, learning_rate=0.08, max_depth=4,
                   n_bins=64)


def _xy(training: np.ndarray):
    """Alg 3's inputs of one training table: engineered (ii, oo)
    features and the (a, log b, c) targets."""
    X = engineer(training[:, 0], training[:, 1])
    Y = training[:, 2:5].copy()
    Y[:, 1] = np.log(np.maximum(Y[:, 1], 1e-10))
    return X, Y


def train_param_predictor(training: np.ndarray, device=None,
                          **gbt_kw) -> Optional[MultiOutputGBT]:
    """Alg 3: engineered (ii, oo) features -> (a, b, c) multi-output GBT,
    grown on ``device`` (None: the GPU).

    b is learned in log space (it spans decades and is positivity
    constrained) — a practical necessity the paper leaves implicit.
    """
    return train_param_predictors([training], device, **gbt_kw)[0]


def train_param_predictors(trainings: Sequence[Optional[np.ndarray]],
                           device=None,
                           **gbt_kw) -> List[Optional[MultiOutputGBT]]:
    """Alg 3 for many training tables (the registry's combinations), in
    one joint fit; a table without rows gets None.

    Every table's three output forests grow in one ``fit_packed_forest``
    call (on the GPU: one ``grow_forests``, one K4 ``gbt_grow`` launch for
    all of them).  Shorter tables are padded with rows of weight 0, which
    leave the quantile edges, every histogram sum and so the trees
    bit-equal to a fit of the table alone.  With row or column sampling
    ``MultiOutputGBT.fit_joint`` fits the tables one by one, as
    ``MultiOutputGBT.fit`` would."""
    kw = dict(_DEFAULT_KW, **gbt_kw)
    live = [i for i, t in enumerate(trainings)
            if t is not None and len(t)]
    out: List[Optional[MultiOutputGBT]] = [None] * len(trainings)
    models = [MultiOutputGBT(3, device=device, **kw) for _ in live]
    if not live:
        return out
    data = [_xy(trainings[i]) for i in live]
    n = max(len(X) for X, _ in data)
    X = np.zeros((len(live), n, data[0][0].shape[1]))
    Y = np.zeros((len(live), n, 3))
    W = np.zeros((len(live), n))
    for c, (x, y) in enumerate(data):
        X[c, :len(x)], Y[c, :len(x)], W[c, :len(x)] = x, y, 1.0
    for i, m in zip(live, models[0].fit_joint(X, Y, W, into=models)):
        out[i] = m
    return out


def predict_params(model: MultiOutputGBT, ii, oo) -> np.ndarray:
    ii = np.atleast_1d(np.asarray(ii, np.float64))
    oo = np.atleast_1d(np.asarray(oo, np.float64))
    Y = model.predict(engineer(ii, oo))
    Y = Y.copy()
    Y[:, 1] = np.exp(Y[:, 1])
    Y[:, 0] = np.maximum(Y[:, 0], 0.0)
    Y[:, 2] = np.maximum(Y[:, 2], 0.0)
    return Y


def predict_throughput(db: Optional[ExpDatabase],
                       model: Optional[MultiOutputGBT],
                       ii, oo, bb) -> np.ndarray:
    """Alg 5: DB hit -> analytical params; miss -> ML-predicted params."""
    ii = np.atleast_1d(np.asarray(ii, np.float64))
    oo = np.atleast_1d(np.asarray(oo, np.float64))
    bb = np.atleast_1d(np.asarray(bb, np.float64))
    out = np.empty(len(ii), np.float64)
    miss = np.ones(len(ii), bool)
    if db is not None:
        for i in range(len(ii)):
            th = db.lookup(ii[i], oo[i])
            if th is not None:
                out[i] = exp_model(bb[i], *th)
                miss[i] = False
    if miss.any():
        if model is None:
            # no ML model: fall back to nearest DB entry by (ii,oo) distance
            if db is None or not len(db.params):
                out[miss] = 0.0
            else:
                keys = np.asarray(list(db.params.keys()))
                vals = np.asarray(list(db.params.values()))
                for i in np.where(miss)[0]:
                    d = np.abs(np.log1p(keys[:, 0]) - np.log1p(ii[i])) \
                        + np.abs(np.log1p(keys[:, 1]) - np.log1p(oo[i]))
                    th = vals[d.argmin()]
                    out[i] = exp_model(bb[i], *th)
        else:
            th = predict_params(model, ii[miss], oo[miss])
            out[miss] = exp_model(bb[miss], th[:, 0], th[:, 1], th[:, 2])
    return out
