"""Online incremental-refit engine: streaming ``Dataset`` deltas -> ALA.

The paper's framework assumes the benchmark database *grows*: parameters
are estimated for benchmarked workloads, then extended to unobserved
configurations.  On the card the deltas are the rows ``measure_arch``
measures, one sweep at a time (the reference also feeds it the serving
simulator's windows; ``serving/`` is not ported yet).  ``OnlineALA``
closes the loop:

    measured rows -> Dataset delta -> ingest() ->
        per-combination append -> drift check -> incremental refit

Incrementality, stage by stage:

  * **registry (Alg 4)** — only combinations whose data changed refit
    (``ModelRegistry.refit`` for new ones, ``update_combo`` for grown
    ones); untouched combinations keep their models.  Every refit runs on
    the registry's device and gives, bit for bit, what a from-scratch
    ``ModelRegistry.fit`` of ``full_data()`` gives.
  * **SA (Alg 6)** — chains warm start from the combination's previous
    ``best_subset`` and run a short budget (``warm_iters``); proposals
    merge into the growing log (``annealing.merge_logs``) instead of
    replacing it.
  * **error model (Alg 7)** — retrains on the merged log (cheap).
  * **bank (Alg 8)** — per-row train/eval membership is drawn once when
    a row arrives and never redrawn, so the SA training rows are
    append-only and ``uncertainty.extend_bank`` updates histograms
    additively under the original fixed-bin contract.

Drift: before a combination's data is appended, the incoming delta is
scored against the *current* fit — Alg 8 confidence (collapse means the
new rows look unlike anything the SA log covered, e.g. out-of-range mass
in the reserved boundary bins) and the residual of the Alg 4/5 predictor
against the predicted error (growth means the model is wrong about a
region it claims to know).  The resulting ``DriftSignal`` is returned in
the ``RefitReport``; ``request_refit`` forces a recalibration at the next
ingest.

Robust ingestion: every delta passes a gate *before* drift detection or
any fit.  Non-finite / non-positive throughput rows are always
quarantined; with ``OnlineConfig.gate`` on, exact duplicates (telemetry
replays) and MAD robust-z outliers against the current registry fit are
quarantined too — corrupted telemetry can neither poison a refit nor
fake a ``DriftSignal``.  Refusals are logged in
``OnlineALA.quarantine`` (``QuarantineRecord``) and counted in
``RefitReport.n_quarantined``.
"""
from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.ala import ALA, ALAConfig
from repro_torch.core.annealing import SAConfig, median_ape
from repro_torch.core.dataset import Dataset
from repro_torch.core.registry import DEFAULT_KEYS, ModelRegistry


@dataclasses.dataclass
class OnlineConfig:
    keys: Sequence[str] = DEFAULT_KEYS
    test_frac: float = 0.3            # per-row SA eval membership
    seed: int = 0
    min_rows: int = 8                 # below this: no uncertainty fit yet
    # SA budgets: full budget on a combination's first fit, short
    # warm-started budget on every incremental refit
    sa: SAConfig = dataclasses.field(default_factory=SAConfig)
    warm_iters: int = 20
    warm_chains: Optional[int] = None  # None -> sa.n_chains
    gbt_kw: dict = dataclasses.field(default_factory=dict)
    # refit policy: "changed" refits every combination whose data grew;
    # "drift" refits only drifted / forced / never-fitted ones
    refit: str = "changed"
    # robust-ingestion gate.  Non-finite / non-positive throughput rows
    # are ALWAYS quarantined (a single NaN silently poisons every
    # downstream fit); ``gate=True`` additionally rejects exact
    # duplicates (telemetry replays) and MAD robust-z outliers against
    # the combination's current registry fit — a row is an outlier only
    # if its log-residual z-score exceeds ``gate_z_max`` AND its
    # prediction ratio exceeds ``gate_min_ratio``, so a uniform drift
    # shift (small z) still passes and retrains the model
    gate: bool = False
    gate_z_max: float = 4.0
    gate_min_ratio: float = 5.0
    # drift thresholds (see DriftSignal)
    drift_conf_floor: float = 0.35
    drift_err_ratio: float = 3.0
    drift_min_ape: float = 10.0
    max_subsets: Optional[int] = None  # Alg 8 bank window (None -> default)


@dataclasses.dataclass
class DriftSignal:
    """How an incoming delta relates to the combination's current fit.

    ``confidence`` is the Alg 8 confidence of the delta as one query
    workload; ``pred_err`` the Alg 7 predicted error for it;
    ``resid_ape`` the realized median APE of the serving predictor
    (Alg 4/5) on the delta rows.  ``drifted`` is true on confidence
    collapse (< ``drift_conf_floor``) or residual growth
    (resid > ``drift_err_ratio`` x max(pred_err, ``drift_min_ape``)).
    New combinations report ``reason="new"`` and never count as drift.
    """
    combo: Tuple[str, ...]
    n_rows: int
    confidence: float = float("nan")
    pred_err: float = float("nan")
    resid_ape: float = float("nan")
    drifted: bool = False
    reason: str = ""


@dataclasses.dataclass
class QuarantineRecord:
    """One row the ingestion gate refused, and why."""
    epoch: int
    combo: Tuple[str, ...]
    reason: str                       # "nonfinite" | "duplicate" | "outlier"
    row: Dict


@dataclasses.dataclass
class RefitReport:
    epoch: int
    n_rows: int                                   # delta rows ingested
    changed: List[Tuple[str, ...]]                # combos with new data
    refit: List[Tuple[str, ...]]                  # combos actually refit
    skipped: List[Tuple[str, ...]]                # changed but not refit
    drift: Dict[Tuple[str, ...], DriftSignal]
    registry_s: float = 0.0
    uncertainty_s: float = 0.0
    wall_s: float = 0.0
    n_quarantined: int = 0                        # rows the gate refused


@dataclasses.dataclass
class _ComboState:
    data: Dataset
    test: np.ndarray                  # per-row eval membership, append-only
    rng: np.random.Generator          # draws membership for future appends
    ala: Optional[ALA] = None
    fitted_rows: int = 0              # rows covered by the registry model
    generation: int = 0               # bumps on every uncertainty refit


def _combo_seed(seed: int, combo: Tuple[str, ...]) -> int:
    # stable across processes (unlike hash()) and across the changing
    # set of live combinations (unlike enumeration order)
    return seed + zlib.crc32("\x1f".join(combo).encode())


class OnlineALA:
    """Streaming ALA over hardware/software combinations.

    ``ingest`` appends a ``Dataset`` delta per combination and refits
    incrementally; ``predict``/``estimate`` delegate to the underlying
    ``ModelRegistry`` exactly like the batch pipeline, so the engine is
    a drop-in for registry consumers that also want continuous
    recalibration.
    """

    def __init__(self, cfg: Optional[OnlineConfig] = None,
                 registry: Optional[ModelRegistry] = None, device=None):
        """``device`` (None: the GPU) is the new registry's; a given
        ``registry`` keeps its own, and every ALA runs on it."""
        self.cfg = cfg or OnlineConfig()
        self.registry = registry or ModelRegistry(keys=self.cfg.keys,
                                                  device=device)
        self.epoch = 0
        self.history: List[RefitReport] = []
        self.quarantine: List[QuarantineRecord] = []
        self._state: Dict[Tuple[str, ...], _ComboState] = {}
        self._keys: Optional[Tuple[str, ...]] = None
        self._forced: set = set()
        self._seen: Dict[Tuple[str, ...], set] = {}

    # -- delta plumbing ------------------------------------------------------
    def combo_of(self, row: Dict) -> Tuple[str, ...]:
        keys = self._keys or tuple(k for k in self.cfg.keys if k in row)
        return tuple(str(row[k]) for k in keys)

    def ala_for(self, combo: Sequence[str]) -> Optional[ALA]:
        st = self._state.get(tuple(str(v) for v in combo))
        return st.ala if st is not None else None

    def generation_of(self, combo: Sequence[str]) -> int:
        """Bumps on every uncertainty refit of the combination.  ALA
        objects refit *in place*, so identity checks can't detect a
        recalibration — consumers (the autoscaler) watch this counter to
        know when to reset evidence gathered against the old fit."""
        st = self._state.get(tuple(str(v) for v in combo))
        return st.generation if st is not None else 0

    def data_for(self, combo: Sequence[str]) -> Optional[Dataset]:
        st = self._state.get(tuple(str(v) for v in combo))
        return st.data if st is not None else None

    def request_refit(self, combo: Sequence[str]) -> None:
        """Force the combination to refit on the next ingest, regardless
        of the refit policy and of whether that ingest carries rows for
        it — the autoscaler's mid-run recalibration trigger."""
        self._forced.add(tuple(str(v) for v in combo))

    def _split_delta(self, delta: Dataset):
        keys = tuple(k for k in self.cfg.keys if k in delta.cols)
        if self._keys is None:
            self._keys = keys
        elif keys != self._keys:
            raise ValueError(f"delta key columns {keys} != the engine's "
                             f"{self._keys}")
        out = []
        for combo in sorted(delta.unique_combos(list(keys))):
            sub = delta
            for k, v in zip(keys, combo):
                sub = sub.mask(sub[k].astype(str) == v)
            out.append((tuple(str(v) for v in combo), sub))
        return out

    # -- robust-ingestion gate ----------------------------------------------
    def _gate(self, combo: Tuple[str, ...], sub: Dataset
              ) -> Tuple[Dataset, int]:
        """Filter a combination's delta before it can touch drift
        detection or any fit.  Always rejects non-finite / non-positive
        throughput and non-finite features; with ``cfg.gate`` also
        rejects exact duplicates and robust-z outliers (see
        ``OnlineConfig``).  Every rejected row lands in
        ``self.quarantine`` with its reason."""
        cfg = self.cfg
        ii, oo, bb, thpt = sub.workload
        n = len(sub)
        reason = [""] * n
        keep = (np.isfinite(ii) & np.isfinite(oo) & np.isfinite(bb)
                & np.isfinite(thpt) & (thpt > 0))
        for i in np.nonzero(~keep)[0]:
            reason[i] = "nonfinite"
        if cfg.gate:
            seen = self._seen.setdefault(combo, set())
            for i in range(n):
                if not keep[i]:
                    continue
                key = (float(ii[i]), float(oo[i]), float(bb[i]),
                       float(thpt[i]))
                if key in seen:
                    keep[i] = False
                    reason[i] = "duplicate"
                else:
                    seen.add(key)
            if keep.any() and combo in self.registry.combos:
                live = np.nonzero(keep)[0]
                with np.errstate(all="ignore"):
                    pred = np.asarray(
                        self.registry.predict(sub.mask(keep)), np.float64)
                    ok = np.isfinite(pred) & (pred > 0)
                    r = np.where(ok, np.log(thpt[live])
                                 - np.log(np.where(ok, pred, 1.0)), np.nan)
                    if ok.any():
                        med = float(np.median(r[ok]))
                        mad = float(np.median(np.abs(r[ok] - med)))
                        scale = max(1.4826 * mad, 1e-3)
                        z = np.abs(r - med) / scale
                        ratio = np.maximum(
                            thpt[live] / np.where(ok, pred, 1.0),
                            np.where(ok, pred, 1.0) / thpt[live])
                        bad = ok & (z > cfg.gate_z_max) \
                            & (ratio > cfg.gate_min_ratio)
                        for j in np.nonzero(bad)[0]:
                            i = int(live[j])
                            keep[i] = False
                            reason[i] = "outlier"
        dropped = np.nonzero(~keep)[0]
        for i in dropped:
            row = {k: (v[i].item() if isinstance(v[i], np.generic)
                       else v[i]) for k, v in sub.cols.items()}
            self.quarantine.append(QuarantineRecord(
                epoch=self.epoch, combo=combo, reason=reason[i], row=row))
        if len(dropped) == 0:
            return sub, 0
        return sub.mask(keep), int(len(dropped))

    # -- drift ---------------------------------------------------------------
    def _drift(self, combo: Tuple[str, ...], sub: Dataset) -> DriftSignal:
        st = self._state.get(combo)
        if st is None or st.ala is None:
            return DriftSignal(combo=combo, n_rows=len(sub), reason="new")
        cfg = self.cfg
        w = sub.workload
        err, _, conf = st.ala.estimate_batch([w], backend="numpy")
        pred_err, confidence = float(err[0]), float(conf[0])
        resid = float("nan")
        if combo in self.registry.combos:
            resid = median_ape(w[3], self.registry.predict(sub))
        collapse = confidence < cfg.drift_conf_floor
        growth = (np.isfinite(resid)
                  and resid > cfg.drift_err_ratio
                  * max(pred_err, cfg.drift_min_ape))
        reason = ("confidence_collapse" if collapse else
                  "residual_growth" if growth else "")
        return DriftSignal(combo=combo, n_rows=len(sub),
                           confidence=confidence, pred_err=pred_err,
                           resid_ape=resid, drifted=collapse or growth,
                           reason=reason)

    # -- the refit stages ----------------------------------------------------
    def _append(self, combo: Tuple[str, ...], sub: Dataset) -> None:
        st = self._state.get(combo)
        if st is None:
            rng = np.random.default_rng(_combo_seed(self.cfg.seed, combo))
            st = _ComboState(data=sub, test=np.zeros(0, bool), rng=rng)
            self._state[combo] = st
        else:
            st.data = st.data.concat(sub)
        # eval membership is drawn once per row, so the SA training rows
        # are append-only and the bank update stays additive
        st.test = np.concatenate(
            [st.test, st.rng.random(len(sub)) < self.cfg.test_frac])

    def _refit_uncertainty(self, combo: Tuple[str, ...]) -> bool:
        cfg = self.cfg
        st = self._state[combo]
        if len(st.data) < cfg.min_rows:
            return False
        te = st.test
        if (~te).sum() < 4 or te.sum() < 1:
            return False
        train = st.data.mask(~te).workload
        test = st.data.mask(te).workload
        if st.ala is None or st.ala.sa_log is None:
            ala_cfg = ALAConfig(sa=cfg.sa)
            if cfg.gbt_kw:
                ala_cfg.gbt_kw = dict(cfg.gbt_kw)
            ala = ALA(ala_cfg, device=self.registry.device)
            ala.fit(*train)
            ala.explore(test)
            ala.fit_error()
            ala.bank(cfg.max_subsets)
            st.ala = ala
        else:
            st.ala.refit(train, test, n_iters=cfg.warm_iters,
                         n_chains=cfg.warm_chains)
        st.generation += 1
        self.registry.attach_ala(combo, st.ala)
        return True

    def ingest(self, delta: Dataset, **gbt_kw) -> RefitReport:
        """One online epoch: append the delta per combination, refit what
        changed (or drifted, under ``cfg.refit == "drift"``), return the
        report with per-combination drift signals."""
        t_all = time.perf_counter()
        self.epoch += 1
        parts = self._split_delta(delta)
        drift: Dict[Tuple[str, ...], DriftSignal] = {}
        changed: List[Tuple[str, ...]] = []
        n_quarantined = 0
        for combo, sub in parts:
            # gate FIRST: quarantined rows must not fake a DriftSignal
            # or reach any fit
            sub, n_q = self._gate(combo, sub)
            n_quarantined += n_q
            if len(sub) == 0:
                continue
            drift[combo] = self._drift(combo, sub)     # vs. the OLD fit
            self._append(combo, sub)
            changed.append(combo)

        if self.cfg.refit == "drift":
            to_refit = [c for c in changed
                        if drift[c].drifted or drift[c].reason == "new"
                        or c in self._forced]
        else:
            to_refit = list(changed)
        # a forced combination refits even with no delta this epoch —
        # skipped epochs may have accumulated rows it was never fit on,
        # and the request promised recalibration at the next ingest
        to_refit += sorted(c for c in self._forced
                           if c in self._state and c not in to_refit)
        self._forced -= set(to_refit)

        # Alg 4: serving predictors, changed combinations only.  Known
        # combinations update group-incrementally (only delta-touched
        # (ii, oo) groups re-solve); brand-new ones take the full fit.
        # n_delta counts every row since the registry model was last
        # fit — under refit="drift", skipped epochs accumulate rows the
        # next refit must treat as delta, not as already-fitted prefix.
        t0 = time.perf_counter()
        fresh = [c for c in to_refit if c not in self.registry.combos]
        for combo in to_refit:
            if combo in fresh:
                continue
            st = self._state[combo]
            self.registry.update_combo(combo, st.data.workload,
                                       len(st.data) - st.fitted_rows,
                                       **gbt_kw)
            st.fitted_rows = len(st.data)
        if fresh:
            full = None
            for combo in fresh:
                d = self._state[combo].data
                full = d if full is None else full.concat(d)
            self.registry.refit(full, combos=fresh, **gbt_kw)
            for combo in fresh:
                st = self._state[combo]
                st.fitted_rows = len(st.data)
        registry_s = time.perf_counter() - t0

        # Alg 6-8: warm-started uncertainty refits
        t0 = time.perf_counter()
        refit = [c for c in to_refit if self._refit_uncertainty(c)]
        uncertainty_s = time.perf_counter() - t0

        report = RefitReport(
            epoch=self.epoch, n_rows=len(delta), changed=changed,
            refit=refit, skipped=[c for c in changed if c not in refit],
            drift=drift, registry_s=registry_s,
            uncertainty_s=uncertainty_s,
            wall_s=time.perf_counter() - t_all,
            n_quarantined=n_quarantined)
        self.history.append(report)
        return report

    # -- serving-side reads --------------------------------------------------
    def predict(self, data: Dataset) -> np.ndarray:
        return self.registry.predict(data)

    def estimate(self, data: Dataset, backend: str = "torch"):
        return self.registry.estimate(data, backend=backend)

    @property
    def combos(self):
        return sorted(self._state)

    def full_data(self) -> Dataset:
        """Every ingested row, concatenated in combination order — what a
        from-scratch ``ModelRegistry.fit`` would see (the parity probe
        the benchmark uses)."""
        out = None
        for combo in self.combos:
            d = self._state[combo].data
            out = d if out is None else out.concat(d)
        if out is None:
            raise ValueError("no data ingested yet")
        return out
