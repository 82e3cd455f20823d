"""ALA orchestrator: the paper's full pipeline as one object.

    fit          -> Alg 2 (exp database) + Alg 3 (param predictor)
    predict      -> Alg 5
    explore      -> Alg 6 (simulated annealing over training subsets)
    fit_error    -> Alg 7 (error predictor on SA logs)
    estimate     -> Alg 8 (predicted error + histogram-cosine confidence)
    estimate_batch -> Alg 7+8 over many query workloads in one shot
                      (PackedForest traversal + SubsetBank distances on
                      the device)

Every LM solve and GBT histogram build that an ``ALA`` starts runs on its
``device`` (the GPU unless the caller passes ``device="cpu"``), and so do
the forest traversals and bank distances of the SA evaluator and
``estimate_batch``; ``predict`` and ``estimate`` keep the reference's
serial host paths.  This class operates within one hardware/software
combination; Alg 4 over many (``core/registry.py::ModelRegistry``) fits
every combination's Alg 2 and Alg 3 in one batched pass and runs an
``ALA`` per combination for the uncertainty stages.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import annealing, uncertainty
from repro_torch.core.annealing import SAConfig, SALog, Subset, median_ape
from repro_torch.core.database import (ExpDatabase,
                                       build_exponential_database,
                                       update_exponential_database)
from repro_torch.core.error_predictor import (predict_error,
                                              train_error_predictor)
from repro_torch.core.gbt import GBTRegressor, MultiOutputGBT
from repro_torch.core.predictor import (predict_throughput,
                                        train_param_predictor)
from repro_torch.core.uncertainty import (SubsetBank, bank_confidence,
                                          build_subset_bank)
from repro_torch.device import resolve_device


@dataclasses.dataclass
class ALAConfig:
    gbt_kw: dict = dataclasses.field(default_factory=lambda: dict(
        n_estimators=150, learning_rate=0.08, max_depth=4))
    sa: SAConfig = dataclasses.field(default_factory=SAConfig)


class ALA:
    def __init__(self, cfg: Optional[ALAConfig] = None, device=None):
        self.cfg = cfg or ALAConfig()
        self.device = resolve_device(device)
        self.db: Optional[ExpDatabase] = None
        self.predictor: Optional[MultiOutputGBT] = None
        self.sa_log: Optional[SALog] = None
        self.error_model: Optional[GBTRegressor] = None
        self._train = None
        self._bank: Optional[SubsetBank] = None
        self._bank_subsets: Optional[int] = None
        self.timings: Dict[str, float] = {}

    # -- Alg 2 + Alg 3 -------------------------------------------------------
    def fit(self, ii, oo, bb, thpt) -> "ALA":
        t0 = time.perf_counter()
        self._train = (np.asarray(ii, np.float64), np.asarray(oo, np.float64),
                       np.asarray(bb, np.float64), np.asarray(thpt, np.float64))
        self._bank = None                      # new train -> stale bank
        self.db = build_exponential_database(*self._train,
                                             device=self.device)
        t1 = time.perf_counter()
        self.predictor = (train_param_predictor(self.db.training,
                                                device=self.device,
                                                **self.cfg.gbt_kw)
                          if self.db is not None and len(self.db.training) >= 4
                          else None)
        t2 = time.perf_counter()
        self.timings.update(fit_db_s=t1 - t0, fit_predictor_s=t2 - t1)
        return self

    # -- Alg 5 ----------------------------------------------------------------
    def predict(self, ii, oo, bb) -> np.ndarray:
        return predict_throughput(self.db, self.predictor, ii, oo, bb)

    def score(self, ii, oo, bb, thpt) -> float:
        return median_ape(np.asarray(thpt, np.float64),
                          self.predict(ii, oo, bb))

    # -- Alg 6 ----------------------------------------------------------------
    def explore(self, test, initial: Optional[Subset] = None,
                on_iter=None, n_chains: Optional[int] = None) -> SALog:
        """Alg 6.  ``n_chains > 1`` (argument or ``cfg.sa.n_chains``)
        routes through the batched K-chain engine with its shared
        evaluation cache; the default stays on the serial loop."""
        assert self._train is not None, "fit() first"
        t0 = time.perf_counter()
        k = self.cfg.sa.n_chains if n_chains is None else n_chains
        if k > 1:
            cfg = dataclasses.replace(self.cfg.sa, n_chains=k)
            self.sa_log = annealing.anneal_batched(
                self._train, test, cfg, initial=initial, on_iter=on_iter,
                device=self.device)
        else:
            self.sa_log = annealing.anneal(self._train, test, self.cfg.sa,
                                           initial=initial, on_iter=on_iter,
                                           device=self.device)
        self._bank = None                      # new log -> stale bank
        self.timings["explore_s"] = time.perf_counter() - t0
        return self.sa_log

    # -- Alg 7 ----------------------------------------------------------------
    def fit_error(self, max_subsets: Optional[int] = None,
                  **gbt_kw) -> GBTRegressor:
        """Train the Alg 7 error predictor on the SA log.

        ``max_subsets`` trains on only the trailing window of the log —
        the online refit path uses the bank's window so the per-epoch
        cost stays bounded as merged logs grow across epochs."""
        assert self.sa_log is not None, "explore() first"
        t0 = time.perf_counter()
        log = self.sa_log
        if max_subsets is not None and len(log.subsets) > max_subsets:
            log = dataclasses.replace(log,
                                      subsets=log.subsets[-max_subsets:],
                                      errors=log.errors[-max_subsets:])
        self.error_model = train_error_predictor(log, device=self.device,
                                                 **gbt_kw)
        self.timings["fit_error_s"] = time.perf_counter() - t0
        return self.error_model

    # -- Alg 8 ----------------------------------------------------------------
    def bank(self, max_subsets: Optional[int] = None) -> SubsetBank:
        """The SA log materialized for batched Alg 8 (built lazily after
        ``explore()``, cached until the log changes).

        ``max_subsets=None`` reuses whatever bank is cached (building
        one over the trailing ``DEFAULT_MAX_SUBSETS`` window — the same
        cap the serial ``confidence`` applies — if none is); an explicit
        value rebuilds when the cached bank used a different window."""
        assert self.sa_log is not None, "explore() first"
        if self._bank is None or (max_subsets is not None
                                  and self._bank_subsets != max_subsets):
            self._bank_subsets = (uncertainty.DEFAULT_MAX_SUBSETS
                                  if max_subsets is None else max_subsets)
            self._bank = build_subset_bank(self._train, self.sa_log,
                                           max_subsets=self._bank_subsets)
        return self._bank

    # -- online incremental refit --------------------------------------------
    def refit(self, train, test, n_iters: Optional[int] = None,
              n_chains: Optional[int] = None) -> SALog:
        """Incremental re-fit after the training data changed (typically
        rows appended by an online epoch of ``core/online.py``).

        When the new data is an append of the old (prefix-equal), every
        stage updates incrementally: the Alg 2 database re-solves only
        the delta-touched (ii, oo) groups
        (``update_exponential_database``), the SA chains warm start from
        the previous log's ``best_subset`` with a short budget
        (``n_iters``, default ``cfg.sa.n_iters``) and merge their
        proposals into the growing log, the Alg 7 error model retrains
        on the merged log, and the Alg 8 bank extends additively under
        the original fixed-bin contract (``uncertainty.extend_bank``).
        Non-appended data falls back to full rebuilds of the database
        and bank (the SA warm start still applies).
        """
        assert self.sa_log is not None, "fit() + explore() first"
        prev_train = self._train
        prev_log = self.sa_log
        prev_bank, prev_bank_subsets = self._bank, self._bank_subsets
        prev_best = prev_log.best_subset

        new_train = tuple(np.asarray(v, np.float64) for v in train)
        n_old = len(prev_train[0]) if prev_train is not None else -1
        appended = (prev_train is not None
                    and len(new_train[0]) >= n_old
                    and all(np.array_equal(p, c[:n_old])
                            for p, c in zip(prev_train, new_train)))
        if appended and self.db is not None:
            # Alg 2 incrementally: only delta-touched (ii, oo) groups
            # re-solve; untouched groups reuse their params verbatim
            t0 = time.perf_counter()
            self._train = new_train
            self._bank = None
            self.db = update_exponential_database(
                self.db, *new_train, n_delta=len(new_train[0]) - n_old,
                device=self.device)
            t1 = time.perf_counter()
            self.predictor = (train_param_predictor(self.db.training,
                                                    device=self.device,
                                                    **self.cfg.gbt_kw)
                              if self.db is not None
                              and len(self.db.training) >= 4 else None)
            self.timings.update(fit_db_s=t1 - t0,
                                fit_predictor_s=time.perf_counter() - t1)
        else:
            self.fit(*train)
        t0 = time.perf_counter()
        cfg = self.cfg.sa
        k = cfg.n_chains if n_chains is None else n_chains
        cfg = dataclasses.replace(
            cfg, n_iters=cfg.n_iters if n_iters is None else n_iters,
            n_chains=k)
        if k > 1:
            new_log = annealing.anneal_batched(self._train, test, cfg,
                                               initial=prev_best,
                                               device=self.device)
        else:
            new_log = annealing.anneal(self._train, test, cfg,
                                       initial=prev_best, device=self.device)
        self.sa_log = annealing.merge_logs(prev_log, new_log)
        self.timings["refit_explore_s"] = time.perf_counter() - t0
        # trailing window keeps the per-epoch Alg 7 cost bounded as the
        # merged log grows (same window the bank reduces over)
        self.fit_error(max_subsets=prev_bank_subsets
                       or uncertainty.DEFAULT_MAX_SUBSETS)

        if prev_bank is not None and appended:
            t0 = time.perf_counter()
            self._bank_subsets = (prev_bank_subsets
                                  or uncertainty.DEFAULT_MAX_SUBSETS)
            self._bank = uncertainty.extend_bank(
                prev_bank, self._train, len(self._train[0]) - n_old,
                new_log.subsets, self.sa_log.universes,
                max_subsets=self._bank_subsets)
            self.timings["refit_bank_s"] = time.perf_counter() - t0
        # else: self.fit already cleared the bank -> lazy full rebuild
        return self.sa_log

    def _fill_thpt(self, q) -> Tuple[np.ndarray, ...]:
        """Replace non-finite throughputs with ALA's own predictions —
        they only enter the confidence histogram when finite."""
        nii, noo, nbb, nthpt = (np.atleast_1d(np.asarray(v, np.float64))
                                for v in q)
        finite = np.isfinite(nthpt)
        if not finite.all():
            nthpt = nthpt.copy()
            nthpt[~finite] = self.predict(nii[~finite], noo[~finite],
                                          nbb[~finite])
        return nii, noo, nbb, nthpt

    def _signature(self, q) -> Subset:
        return {"ii": frozenset(np.unique(q[0]).tolist()),
                "oo": frozenset(np.unique(q[1]).tolist()),
                "bb": frozenset(np.unique(q[2]).tolist())}

    def estimate(self, new, hw_dist: float = 0.0) -> Tuple[float, float]:
        """(predicted error %, confidence) for a new workload dataset.

        ``new`` is an (ii, oo, bb, thpt) tuple (thpt may be NaNs when
        unknown).  Runs the batch-of-one serial reference path; the
        batched device engine (``estimate_batch``) matches it to <= 1e-6.
        """
        err, _, conf = self.estimate_batch([new], backend="numpy",
                                           hw_dist=hw_dist)
        return float(err[0]), float(conf[0])

    def estimate_batch(self, queries: Sequence, backend: str = "torch",
                       hw_dist=0.0
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batched Alg 7+8: (err, d_min, confidence) vectors, one entry
        per query workload.

        Each query is an (ii, oo, bb, thpt) tuple (ragged lengths fine;
        thpt may contain NaNs).  ``backend="torch"`` runs the whole batch
        on the device in two passes — encoded signatures through the
        ``PackedForest`` traversal and the distances over the
        ``SubsetBank``; ``backend="numpy"`` is the serial reference.
        Degenerate logs yield the (inf, 0.0) sentinel per query.

        ``hw_dist`` (scalar or per-query vector) is the descriptor
        distance of the hardware each query runs on from the hardware
        this fit was benchmarked on (the reference's
        ``perfmodel/hardware.py::hardware_distance``); it lowers the
        reported confidence for cross-hardware transfer while ``d_min``
        stays the pure workload distance."""
        assert self.error_model is not None and self.sa_log is not None
        t0 = time.perf_counter()
        queries = [tuple(np.atleast_1d(np.asarray(v, np.float64))
                         for v in q) for q in queries]
        sigs = [self._signature(q) for q in queries]
        err = predict_error(self.error_model, sigs, self.sa_log.universes,
                            backend=backend) if sigs else np.zeros(0)
        filled = [self._fill_thpt(q) for q in queries]
        d_min, conf = bank_confidence(self.bank(), filled, backend=backend,
                                      hw_dist=hw_dist, device=self.device)
        self.timings["estimate_batch_s"] = time.perf_counter() - t0
        return np.asarray(err, np.float64), d_min, conf
