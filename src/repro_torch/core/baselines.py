"""Baselines from the paper's Fig 7: Linear Regression, Vanilla XGBoost
(our GBT with stock hyperparameters), Random Forest, Gradient Boosting.

All regress thpt directly from raw (ii, oo, bb) — no analytical model.
The tree models grow on ``device`` (None: the GPU): the two GBTs through
``grow_forests`` (two K4 launches a tree level), the random forest, which
samples columns, through the host loop over K4's histograms.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from repro_torch.core.gbt import (GBTRegressor, LinearRegression,
                                  RandomForestRegressor)
from repro_torch.device import resolve_device


def _stack(ii, oo, bb) -> np.ndarray:
    return np.stack([np.asarray(ii, np.float64),
                     np.asarray(oo, np.float64),
                     np.asarray(bb, np.float64)], axis=1)


class BaselineModel:
    def __init__(self, name: str, factory: Callable):
        self.name = name
        self.factory = factory
        self.model = None

    def fit(self, ii, oo, bb, thpt):
        self.model = self.factory()
        self.model.fit(_stack(ii, oo, bb), np.asarray(thpt, np.float64))
        return self

    def predict(self, ii, oo, bb) -> np.ndarray:
        return self.model.predict(_stack(ii, oo, bb))


def make_baselines(device=None) -> Dict[str, BaselineModel]:
    device = resolve_device(device)
    return {
        "linear_regression": BaselineModel(
            "linear_regression", LinearRegression),
        "vanilla_xgboost": BaselineModel(
            "vanilla_xgboost",
            lambda: GBTRegressor(n_estimators=100, learning_rate=0.3,
                                 max_depth=6, device=device)),
        "random_forest": BaselineModel(
            "random_forest",
            lambda: RandomForestRegressor(n_estimators=60, max_depth=8,
                                          device=device)),
        "gradient_boosting": BaselineModel(
            "gradient_boosting",
            lambda: GBTRegressor(n_estimators=100, learning_rate=0.1,
                                 max_depth=3, device=device)),
    }
