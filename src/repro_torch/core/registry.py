"""Per hardware/software-combination model registry (paper Alg 4).

One (ExpDatabase, parameter-predictor) pair per unique configuration
combination — e.g. (acc, acc_count, back, model, prec, mode).  The key
columns are configurable; combinations are discovered from the data.

Combination fits are independent, and on one card many small fits would
only queue small launches on one stream; so ``fit`` and ``refit`` fit all
target combinations together on the registry's ``device`` (the GPU unless
the caller passes ``device="cpu"``):

  * Alg 2: every (ii, oo) group of every combination in one LM solve per
    padded row length (``database.build_exponential_databases``);
  * Alg 3: every combination's three output forests in one joint fit
    (``predictor.train_param_predictors``; on the GPU one
    ``grow_forests``, two K4 launches a tree level for all of them).

Each combination gets, bit for bit, the database and predictor a fit of
its rows alone would give, and combinations are inserted in sorted order,
so the registry does not depend on which combinations are fitted
together.

Fleet-scale uncertainty: ``fit_uncertainty`` runs the full Alg 6+7
pipeline per combination (its own train/eval split, SA log, error
predictor, ``SubsetBank``); ``estimate`` then answers Alg 8 for every
row of a dataset at once — rows group by combination and each group
dispatches as one batched query to its combination's bank.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.database import (ExpDatabase,
                                       build_exponential_databases,
                                       update_exponential_database)
from repro_torch.core.dataset import Dataset
from repro_torch.core.gbt import MultiOutputGBT
from repro_torch.core.predictor import (predict_throughput,
                                        train_param_predictor,
                                        train_param_predictors)
from repro_torch.device import resolve_device
from repro_torch.perfmodel.hardware import PROFILES, hardware_distance

DEFAULT_KEYS = ("model", "acc", "acc_count", "back", "prec", "mode")


@dataclasses.dataclass
class ComboModel:
    db: Optional[ExpDatabase]
    predictor: Optional[MultiOutputGBT]
    # repro_torch.core.ala.ALA after fit_uncertainty (imported lazily
    # there: plain Alg 4 use keeps the registry free of the SA and
    # uncertainty stack)
    ala: Optional[object] = None


class ModelRegistry:
    def __init__(self, keys: Sequence[str] = DEFAULT_KEYS, device=None):
        self.keys = tuple(keys)
        self.device = resolve_device(device)
        self.combos: Dict[Tuple, ComboModel] = {}

    def _fit_combos(self, data: Dataset, combos, keys, gbt_kw) -> None:
        workloads = []
        for combo in combos:
            sub = data
            for k, v in zip(keys, combo):
                sub = sub.mask(sub[k].astype(str) == v)
            if len(sub) == 0:
                raise ValueError(f"no rows for combination {combo!r} in "
                                 "the given dataset")
            workloads.append(sub.workload)
        dbs = build_exponential_databases(workloads, device=self.device)
        preds = train_param_predictors(
            [db.training if db is not None and len(db.training) >= 4
             else None for db in dbs], device=self.device, **gbt_kw)
        # insertion in sorted combo order keeps iteration deterministic
        for combo, db, pred in zip(combos, dbs, preds):
            self.combos[combo] = ComboModel(db=db, predictor=pred)

    def fit(self, data: Dataset, **gbt_kw) -> "ModelRegistry":
        """Full Alg 4 fit.  Always starts from a clean slate: any state
        from a previous ``fit`` — including combinations absent from the
        new data and their stale ``ala`` uncertainty fits — is dropped,
        so ``predict``/``estimate`` never silently serve models trained
        on data this registry no longer represents.  Use ``refit`` to
        update a subset of combinations in place."""
        self.combos = {}
        keys = [k for k in self.keys if k in data.cols]
        self._active_keys = tuple(keys)
        self._fit_combos(data, sorted(data.unique_combos(keys)), keys,
                         gbt_kw)
        return self

    def refit(self, data: Dataset, combos: Optional[Sequence[Tuple]] = None,
              **gbt_kw) -> "ModelRegistry":
        """Incremental Alg 4: (re)fit only the given combinations,
        leaving every other fitted combination untouched.

        ``data`` must contain the *full* accumulated rows for each
        target combination (an exponential fit is not additive, so a
        changed combination rebuilds from all of its rows — the
        incrementality is across combinations).  ``combos=None`` targets
        every combination present in ``data``.  A refitted combination's
        ``ala`` uncertainty fit is dropped — its data changed, so the
        old SA log / error model / bank no longer describe it; callers
        running the online pipeline re-attach a fresh one via
        ``attach_ala`` (see ``repro_torch.core.online.OnlineALA``).
        """
        keys = [k for k in self.keys if k in data.cols]
        if self.combos and tuple(keys) != self._active_keys:
            raise ValueError(f"refit key columns {tuple(keys)} != the "
                             f"fitted registry's {self._active_keys}")
        self._active_keys = tuple(keys)
        present = sorted(data.unique_combos(keys))
        if combos is None:
            targets = present
        else:
            targets = sorted(tuple(str(v) for v in c) for c in combos)
            present_set = set(present)
            unknown = [c for c in targets if c not in present_set]
            if unknown:
                raise ValueError(f"refit: no rows in data for "
                                 f"combinations {unknown}")
        self._fit_combos(data, targets, keys, gbt_kw)
        return self

    def update_combo(self, combo: Tuple, workload, n_delta: int,
                     **gbt_kw) -> None:
        """Append-only incremental update of one fitted combination.

        ``workload`` is the combination's *full* (ii, oo, bb, thpt) with
        its last ``n_delta`` rows newly appended.  Only the (ii, oo)
        groups the delta touches re-solve (``update_exponential_database``
        — untouched group params are reused verbatim); the Alg 3
        predictor retrains on the updated training table.  The stale
        ``ala`` is dropped, same contract as ``refit``."""
        combo = tuple(str(v) for v in combo)
        cm = self.combos.get(combo)
        if cm is None:
            raise KeyError(f"unknown combination {combo!r}; "
                           "fit()/refit() it first")
        db = update_exponential_database(cm.db, *workload, n_delta=n_delta,
                                         device=self.device)
        pred = (train_param_predictor(db.training, device=self.device,
                                      **gbt_kw)
                if db is not None and len(db.training) >= 4 else None)
        self.combos[combo] = ComboModel(db=db, predictor=pred)

    def attach_ala(self, combo: Tuple, ala) -> None:
        """Bind an uncertainty fit to an already-fitted combination so
        ``estimate`` serves it (the online engine's re-attachment hook)."""
        combo = tuple(str(v) for v in combo)
        cm = self.combos.get(combo)
        if cm is None:
            raise KeyError(f"unknown combination {combo!r}; "
                           "fit()/refit() it first")
        self.combos[combo] = dataclasses.replace(cm, ala=ala)

    def _combo_masks(self, data: Dataset):
        keys = self._active_keys
        arr = np.stack([data[k].astype(str) for k in keys], axis=1) \
            if keys else np.zeros((len(data), 0), str)
        for combo, cm in self.combos.items():
            mask = np.all(arr == np.asarray(combo), axis=1) if keys else \
                np.ones(len(data), bool)
            yield combo, cm, mask

    def predict(self, data: Dataset, transfer: bool = False,
                scale_fn=None) -> np.ndarray:
        """Throughput prediction for every row (Alg 5 per combination).

        ``transfer=True`` extends coverage to rows of *unfitted* hardware
        (paper RQ4): a row whose combination differs from a fitted one
        only in the hardware key borrows that donor's predictor.
        ``scale_fn(query_combo, donor_combo, ii, oo, bb)`` optionally
        rescales the donor prediction (an analytic roofline ratio is the
        intended scaler); without it the donor prediction is served
        raw."""
        out = np.zeros(len(data), np.float64)
        ii, oo, bb, _ = data.workload
        for combo, cm, mask in self._combo_masks(data):
            if not mask.any():
                continue
            out[mask] = predict_throughput(cm.db, cm.predictor,
                                           ii[mask], oo[mask], bb[mask])
        if transfer:
            for combo, donor, mask in self._transfer_groups(data):
                cm = self.combos[donor]
                pred = predict_throughput(cm.db, cm.predictor,
                                          ii[mask], oo[mask], bb[mask])
                if scale_fn is not None:
                    pred = pred * scale_fn(combo, donor,
                                           ii[mask], oo[mask], bb[mask])
                out[mask] = pred
        return out

    # -- cross-hardware transfer (paper RQ4) ---------------------------------
    def _hw_key_index(self, key: str = "acc") -> Optional[int]:
        keys = getattr(self, "_active_keys", ())
        return keys.index(key) if key in keys else None

    def donor_for(self, combo: Tuple, need_ala: bool = False,
                  hw_key: str = "acc") -> Optional[Tuple]:
        """The fitted combination this (unfitted) one can borrow from: a
        combination matching on every key column *except* the hardware
        key, nearest by descriptor distance when several qualify.
        Returns None when the registry has no hardware key column or no
        candidate."""
        hi = self._hw_key_index(hw_key)
        if hi is None:
            return None
        combo = tuple(str(v) for v in combo)
        rest = combo[:hi] + combo[hi + 1:]
        best, best_d = None, np.inf
        for cand, cm in self.combos.items():
            if cand[:hi] + cand[hi + 1:] != rest or cand[hi] == combo[hi]:
                continue
            if need_ala and getattr(cm, "ala", None) is None:
                continue
            d = _hardware_distance(combo[hi], cand[hi])
            if d < best_d:
                best, best_d = cand, d
        return best

    def _transfer_groups(self, data: Dataset, need_ala: bool = False):
        """(query_combo, donor_combo, row_mask) for every combination in
        ``data`` that is not fitted (or lacks an uncertainty fit, with
        ``need_ala``) but has a transfer donor."""
        keys = getattr(self, "_active_keys", ())
        if not keys:
            return
        arr = np.stack([data[k].astype(str) for k in keys], axis=1)
        for combo in sorted(map(tuple, np.unique(arr, axis=0))):
            cm = self.combos.get(combo)
            if cm is not None and not (need_ala
                                       and getattr(cm, "ala", None) is None):
                continue
            donor = self.donor_for(combo, need_ala=need_ala)
            if donor is None:
                continue
            yield combo, donor, np.all(arr == np.asarray(combo), axis=1)

    # -- Alg 6+7 per combination, Alg 8 over whole datasets ------------------
    def fit_uncertainty(self, data: Dataset, test_frac: float = 0.3,
                        seed: int = 0, sa_cfg=None,
                        **gbt_kw) -> "ModelRegistry":
        """Run the uncertainty pipeline for every fitted combination, each
        an ``ALA`` on the registry's device, one after another.

        Each combination's rows split deterministically into an SA
        train/eval pair; the resulting ALA carries the SA log, the Alg 7
        error model, and the Alg 8 ``SubsetBank``.  Must follow
        ``fit``; combinations with too few rows to split are skipped
        (their rows estimate to the degenerate sentinel).
        """
        from repro_torch.core.ala import ALA, ALAConfig

        assert self.combos, "fit() first"
        for ci, (combo, cm, mask) in enumerate(self._combo_masks(data)):
            sub = data.mask(mask)
            if len(sub) < 8:
                continue
            # combos iterate in sorted order, so index-seeded RNGs are
            # deterministic across processes (tuple hash is not)
            rng = np.random.default_rng(seed + 7919 * (ci + 1))
            te = rng.random(len(sub)) < test_frac
            if te.all() or (~te).sum() < 4 or te.sum() < 1:
                continue
            cfg = ALAConfig(gbt_kw=dict(gbt_kw) if gbt_kw else
                            ALAConfig().gbt_kw)
            if sa_cfg is not None:
                cfg.sa = sa_cfg
            ala = ALA(cfg, device=self.device).fit(*sub.mask(~te).workload)
            ala.explore(sub.mask(te).workload)
            ala.fit_error()
            ala.bank()
            self.combos[combo] = dataclasses.replace(cm, ala=ala)
        return self

    def estimate(self, data: Dataset, backend: str = "torch",
                 transfer: bool = False
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batched Alg 8 for every row: (err, d_min, confidence) arrays
        aligned to ``data``.

        Rows group by combination; each group is one query workload
        dispatched to that combination's ``SubsetBank`` through
        ``ALA.estimate_batch`` (``backend="torch"`` on the device,
        ``"numpy"`` the serial reference).  Rows of unknown combinations
        — or of combinations without an uncertainty fit — get the
        explicit degenerate sentinel (nan, inf, 0.0).

        ``transfer=True``: rows of unfitted hardware are answered by
        their transfer donor (``donor_for``) with the hardware-descriptor
        distance folded into the confidence — strictly below what the
        donor reports for the same workload on its own hardware, and
        the (inf, 0.0) sentinel when the hardware is unknown to
        ``repro_torch.perfmodel.hardware.PROFILES``.
        """
        n = len(data)
        err = np.full(n, np.nan)
        d_min = np.full(n, np.inf)
        conf = np.zeros(n)
        ii, oo, bb, thpt = data.workload
        for combo, cm, mask in self._combo_masks(data):
            if not mask.any() or getattr(cm, "ala", None) is None:
                continue
            q = (ii[mask], oo[mask], bb[mask], thpt[mask])
            e, d, c = cm.ala.estimate_batch([q], backend=backend)
            err[mask], d_min[mask], conf[mask] = e[0], d[0], c[0]
        if transfer:
            hi = self._hw_key_index()
            for combo, donor, mask in self._transfer_groups(data,
                                                            need_ala=True):
                hw_d = _hardware_distance(combo[hi], donor[hi])
                if not np.isfinite(hw_d):
                    continue        # unknown hardware keeps the sentinel
                q = (ii[mask], oo[mask], bb[mask], thpt[mask])
                ala = self.combos[donor].ala
                e, d, c = ala.estimate_batch([q], backend=backend,
                                             hw_dist=hw_d)
                err[mask], d_min[mask], conf[mask] = e[0], d[0], c[0]
        return err, d_min, conf


def _hardware_distance(a: str, b: str) -> float:
    """Descriptor distance between two hardware names; inf when either
    is not a registered profile (transfer to unknown hardware must read
    as zero-confidence, never as a silent same-hardware answer)."""
    if a not in PROFILES or b not in PROFILES:
        return float("inf")
    return hardware_distance(a, b)
