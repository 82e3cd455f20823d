"""Conversion of the reference package's weights and fitted state into
the port's.

Model weights: the input is the JAX ``Model.init`` pytree with numpy
leaves (``jax.tree.map(np.asarray, params)``): nested dicts, with
``blocks`` a tuple over period positions whose leaves carry a leading
``n_periods`` axis (a MoE block's experts ``(n_periods, E, D, F)``, a
mixer's leaves under ``mamba``, ``mlstm`` or ``slstm``).  The output
names each tensor as ``Model.load`` expects, so both packages compute
with the same weights.

Fitted ALA state has no device arrays in the reference: it is numpy
arrays, dicts and frozensets on plain objects.  The ``*_from_reference``
converters read those attributes (an ``ExpDatabase``, a ``GBTRegressor``
with its ``_Tree``s, a ``PackedForest``, an ``SALog``, a ``SubsetBank``,
a fitted ``ModelRegistry`` with its combinations' ALAs, an ``OnlineALA``
between two ingests) and build the port's objects from copies, so both packages can be fed the same state at
each stage.  Nothing here imports JAX or the reference.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.core.ala import ALA, ALAConfig
from repro_torch.core.annealing import SAConfig, SALog
from repro_torch.core.database import ExpDatabase
from repro_torch.core.dataset import Dataset
from repro_torch.core.gbt import (GBTRegressor, MultiOutputGBT, PackedForest,
                                  _Tree)
from repro_torch.core.online import (OnlineALA, OnlineConfig,
                                     QuarantineRecord, _ComboState)
from repro_torch.core.registry import ComboModel, ModelRegistry
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
    """JAX param pytree (numpy leaves) -> ``{name: tensor}`` on ``device``:
    the decoder's blocks (leading axis ``n_periods``, a decoder block's
    ``cross_norm`` and ``cross_attn`` included), the encoder's
    ``enc_blocks`` (leading axis ``n_encoder_layers``) and ``enc_norm``,
    and ``vis_proj``."""
    extra = set(tree) - {"embed", "final_norm", "blocks", "enc_blocks",
                         "enc_norm", "vis_proj"}
    if extra:
        raise NotImplementedError(f"parameters {sorted(extra)} belong to "
                                  f"paths the torch model does not run")
    if len(tree["blocks"]) != len(cfg.period):
        raise ValueError(f"{len(tree['blocks'])} period positions in the "
                         f"tree, {len(cfg.period)} in {cfg.name}")
    out = {name: _tensor(a, device) for name, a in flatten_params(
        "", {k: tree[k] for k in ("embed", "final_norm", "enc_norm",
                                  "vis_proj") if k in tree}).items()}

    def unstack(where, block, n, axis, name_of):
        for name, a in flatten_params("", block).items():
            if a.shape[0] != n:
                raise ValueError(f"{where}.{name}: leading axis "
                                 f"{a.shape[0]} != {axis} {n}")
            for j in range(n):
                out[f"{name_of(j)}.{name}"] = _tensor(a[j], device)

    for i, block in enumerate(tree["blocks"]):
        unstack(f"blocks[{i}]", block, cfg.n_periods, "n_periods",
                lambda p, i=i: f"blocks.{p}.{i}")
    if "enc_blocks" in tree:
        unstack("enc_blocks", tree["enc_blocks"], cfg.n_encoder_layers,
                "n_encoder_layers", lambda n: f"enc_blocks.{n}")
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


def multi_output_gbt_from_reference(model, device=None) -> MultiOutputGBT:
    """A fitted reference ``MultiOutputGBT`` (Alg 3) -> the port's."""
    out = MultiOutputGBT(0)
    out.models = [gbt_from_reference(m, device) for m in model.models]
    return out


def _sa_config(sa) -> SAConfig:
    out = SAConfig(**{k: getattr(sa, k) for k in SAConfig.__dataclass_fields__})
    out.gbt_kw = dict(out.gbt_kw)
    return out


def ala_from_reference(ala, device=None) -> ALA:
    """A reference ``ALA`` after ``fit`` (and ``explore``, ``fit_error``,
    ``bank`` where they ran) -> the port's, holding copies of its rows,
    database, predictor, SA log, error model and bank."""
    out = ALA(ALAConfig(gbt_kw=dict(ala.cfg.gbt_kw),
                        sa=_sa_config(ala.cfg.sa)), device=device)
    out._train = tuple(_copy(v) for v in ala._train)
    if ala.db is not None:
        out.db = exp_database_from_reference(ala.db)
    if ala.predictor is not None:
        out.predictor = multi_output_gbt_from_reference(ala.predictor, device)
    if ala.sa_log is not None:
        out.sa_log = sa_log_from_reference(ala.sa_log)
    if ala.error_model is not None:
        out.error_model = gbt_from_reference(ala.error_model, device)
    if ala._bank is not None:
        out._bank = subset_bank_from_reference(ala._bank)
        out._bank_subsets = ala._bank_subsets
    return out


def registry_from_reference(reg, device=None, alas=None) -> ModelRegistry:
    """A fitted reference ``ModelRegistry`` (Alg 4) -> the port's, on
    ``device`` (None: the GPU): every combination's database and Alg 3
    predictor and, where ``fit_uncertainty`` gave it one, its ALA.
    ``alas`` maps ``id()`` of reference ALAs already converted to the
    port's, so that an ALA shared with an ``OnlineALA`` stays one object."""
    alas = {} if alas is None else alas
    out = ModelRegistry(keys=reg.keys, device=device)
    if hasattr(reg, "_active_keys"):
        out._active_keys = tuple(reg._active_keys)
    for combo, cm in reg.combos.items():
        if cm.ala is not None and id(cm.ala) not in alas:
            alas[id(cm.ala)] = ala_from_reference(cm.ala, device)
        out.combos[combo] = ComboModel(
            db=None if cm.db is None else exp_database_from_reference(cm.db),
            predictor=None if cm.predictor is None else
            multi_output_gbt_from_reference(cm.predictor, device),
            ala=None if cm.ala is None else alas[id(cm.ala)])
    return out


def online_from_reference(eng, device=None) -> OnlineALA:
    """A reference ``OnlineALA`` between two ingests -> the port's, on
    ``device`` (None: the GPU): its config, registry, epoch, quarantine and
    forced refits, and each combination's rows, eval membership, RNG,
    ALA, fitted-row count and generation.  The next ingest of the same
    delta then sees the same state on both sides."""
    cfg = OnlineConfig(**{f.name: copy.deepcopy(getattr(eng.cfg, f.name))
                          for f in dataclasses.fields(OnlineConfig)
                          if f.name != "sa"})
    cfg.sa = _sa_config(eng.cfg.sa)
    alas: Dict[int, ALA] = {}
    out = OnlineALA(cfg, registry_from_reference(eng.registry, device, alas))
    out.epoch = eng.epoch
    out.quarantine = [QuarantineRecord(q.epoch, q.combo, q.reason,
                                       dict(q.row)) for q in eng.quarantine]
    out._keys = eng._keys
    out._forced = set(eng._forced)
    out._seen = copy.deepcopy(eng._seen)
    for combo, st in eng._state.items():
        if st.ala is not None and id(st.ala) not in alas:
            alas[id(st.ala)] = ala_from_reference(st.ala, device)
        out._state[combo] = _ComboState(
            data=Dataset({k: _copy(v) for k, v in st.data.cols.items()}),
            test=_copy(st.test), rng=copy.deepcopy(st.rng),
            ala=None if st.ala is None else alas[id(st.ala)],
            fitted_rows=st.fitted_rows, generation=st.generation)
    return out
