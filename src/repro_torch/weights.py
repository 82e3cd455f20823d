"""Conversion of the reference package's weights and fitted state into
the port's.

Model weights: the input is the JAX ``Model.init`` pytree with numpy
leaves (``jax.tree.map(np.asarray, params)``): nested dicts, with
``blocks`` a tuple over period positions whose leaves carry a leading
``n_periods`` axis.  The output names each tensor as ``Model.load``
expects, so both packages compute with the same weights.

Fitted ALA state has no device arrays in the reference: it is numpy
arrays, dicts and frozensets on plain objects.  The ``*_from_reference``
converters read those attributes (an ``ExpDatabase``, a ``GBTRegressor``
with its ``_Tree``s, a ``PackedForest``, an ``SALog``, a ``SubsetBank``)
and build the port's objects from copies, so both packages can be fed the
same state at each stage.  Nothing here imports JAX or the reference.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.annealing import SALog
from repro_torch.core.database import ExpDatabase
from repro_torch.core.gbt import GBTRegressor, PackedForest, _Tree
from repro_torch.core.uncertainty import SubsetBank
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import flatten_params


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)  # a writable copy: JAX hands out read-only buffers
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, unknown to torch
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree, cfg: ModelConfig, device) -> Dict[str, torch.Tensor]:
    """JAX param pytree (numpy leaves) -> ``{name: tensor}`` on ``device``."""
    extra = set(tree) - {"embed", "final_norm", "blocks"}
    if extra:
        raise NotImplementedError(f"parameters {sorted(extra)} belong to "
                                  f"paths the torch model does not run")
    if len(tree["blocks"]) != len(cfg.period):
        raise ValueError(f"{len(tree['blocks'])} period positions in the "
                         f"tree, {len(cfg.period)} in {cfg.name}")
    out = {name: _tensor(a, device) for name, a in flatten_params(
        "", {"embed": tree["embed"], "final_norm": tree["final_norm"]}).items()}
    for i, block in enumerate(tree["blocks"]):
        for name, a in flatten_params("", block).items():
            if a.shape[0] != cfg.n_periods:
                raise ValueError(f"blocks[{i}].{name}: leading axis "
                                 f"{a.shape[0]} != n_periods {cfg.n_periods}")
            for p in range(cfg.n_periods):
                out[f"blocks.{p}.{i}.{name}"] = _tensor(a[p], device)
    return out


def _copy(a) -> np.ndarray:
    return np.array(a, copy=True)


def exp_database_from_reference(db) -> ExpDatabase:
    """A reference ``ExpDatabase`` -> the port's (params and rows)."""
    return ExpDatabase(params={k: _copy(v) for k, v in db.params.items()},
                       training=_copy(db.training))


def tree_from_reference(tree) -> _Tree:
    return _Tree(**{k: _copy(getattr(tree, k)) for k in (
        "feature", "threshold", "left", "right", "value")})


def gbt_from_reference(model, device=None) -> GBTRegressor:
    """A fitted reference ``GBTRegressor`` -> the port's, on ``device``
    (None: the GPU); ``use_kernel`` keeps the port's default."""
    out = GBTRegressor(
        n_estimators=model.n_estimators, learning_rate=model.learning_rate,
        max_depth=model.max_depth, n_bins=model.n_bins,
        min_child_weight=model.min_child_weight,
        reg_lambda=model.reg_lambda, subsample=model.subsample,
        colsample=model.colsample, seed=model.seed, device=device)
    out.trees_ = [tree_from_reference(t) for t in model.trees_]
    out.base_ = float(model.base_)
    out.bin_edges_ = _copy(model.bin_edges_)
    out._packed = None
    return out


def packed_forest_from_reference(forest, device=None) -> PackedForest:
    """A reference ``PackedForest`` -> the port's, predicting on
    ``device`` (None: the GPU)."""
    arrays = {k: _copy(getattr(forest, k)) for k in (
        "feature", "threshold", "left", "right", "value", "base",
        "bin_edges", "n_nodes")}
    return PackedForest(**arrays, learning_rate=float(forest.learning_rate),
                        max_depth=int(forest.max_depth),
                        device=str(resolve_device(device)))


def sa_log_from_reference(log) -> SALog:
    """A reference ``SALog`` -> the port's (subsets are dicts of
    frozensets, copied as they are)."""
    return SALog(subsets=[dict(s) for s in log.subsets],
                 errors=[float(e) for e in log.errors],
                 universes={k: _copy(v) for k, v in log.universes.items()},
                 best_subset=dict(log.best_subset),
                 best_error=float(log.best_error))


def subset_bank_from_reference(bank) -> SubsetBank:
    """A reference ``SubsetBank`` -> the port's."""
    return SubsetBank(
        inner_edges=_copy(bank.inner_edges), hist=_copy(bank.hist),
        unit=_copy(bank.unit), valid=_copy(bank.valid),
        masks=_copy(bank.masks), subsets=[dict(s) for s in bank.subsets],
        universes={k: _copy(v) for k, v in bank.universes.items()},
        n_bins=int(bank.n_bins))
