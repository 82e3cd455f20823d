"""ALA calibration audit: does predicted trust track realized error?

The audit is a typed event stream fed from two places — every
``ALAAutoscaler`` control tick (predicted vs realized throughput, the
Alg 7 predicted error, the Alg 8 confidence) and every ``OnlineALA``
ingest (refit / drift / quarantine outcomes) — plus the autoscaler's
degradation and recalibration decisions, unified into one log.  From
the tick stream it derives the two headline calibration artifacts:

* predicted-vs-realized APE (is Alg 7's error estimate honest?), and
* a confidence **reliability curve** — binned Alg 8 confidence against
  the empirical accuracy rate (APE <= ``ape_ok_pct``) in each bin,
  optionally monotonized with pool-adjacent-violators so the curve is
  non-decreasing in confidence, as a well-calibrated score must be.

Events live in a ``RingLog`` when ``ObsConfig.max_cal_events`` is set;
``counts`` stays lossless per kind either way.

A copy of the reference package's ``obs/calibration.py``; ``pav`` merges
blocks in the reference's order, so the curve's floats are its bit for
bit (``tests/test_torch_obs_calibration.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

import numpy as np

from repro_torch.obs.metrics import RingLog

__all__ = ["CalEvent", "CalibrationAudit", "reliability_curve", "pav"]

EVENT_KINDS = ("tick", "drift", "quarantine", "refit", "recalibration",
               "degradation", "decision")


@dataclasses.dataclass
class CalEvent:
    """One audit event.  ``t`` is sim-time seconds for autoscaler-fed
    events and the (float) online epoch for ingest-fed ones — the
    ``clock`` field says which."""
    t: float
    kind: str                         # one of EVENT_KINDS
    clock: str = "sim"                # "sim" | "epoch"
    data: Dict[str, object] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, object]:
        return {"t": self.t, "kind": self.kind, "clock": self.clock,
                **self.data}


class CalibrationAudit:
    """Unified predict→observe→trust event log (see module docstring)."""

    def __init__(self, cfg=None):
        cap = getattr(cfg, "max_cal_events", None) if cfg else None
        self.events: Union[List[CalEvent], RingLog] = \
            RingLog(cap) if cap else []
        self.counts: Dict[str, int] = {}
        self.ape_ok_pct = float(getattr(cfg, "ape_ok_pct", 25.0)
                                if cfg else 25.0)
        self.reliability_bins = int(getattr(cfg, "reliability_bins", 10)
                                    if cfg else 10)

    def event(self, t: float, kind: str, clock: str = "sim",
              **data) -> CalEvent:
        ev = CalEvent(t=float(t), kind=kind, clock=clock, data=data)
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.events.append(ev)
        return ev

    # -- autoscaler feed -----------------------------------------------------
    def tick(self, t: float, predicted: float, measured: float,
             confidence: float, ape: Optional[float] = None,
             pred_err: float = float("nan")) -> CalEvent:
        """One control-tick observation: Alg 4 predicted throughput vs
        the realized window measurement, with the Alg 7 predicted error
        and Alg 8 confidence attached."""
        if ape is None:
            ape = (abs(predicted - measured) / measured * 100.0
                   if measured > 0 and np.isfinite(predicted)
                   else float("inf"))
        return self.event(t, "tick", predicted=float(predicted),
                          measured=float(measured),
                          confidence=float(confidence), ape=float(ape),
                          pred_err=float(pred_err))

    # -- online-loop feed ----------------------------------------------------
    def ingest_report(self, report) -> None:
        """Fold one ``RefitReport`` into the log (epoch clock)."""
        t = float(report.epoch)
        for combo, sig in report.drift.items():
            if sig.drifted:
                self.event(t, "drift", clock="epoch",
                           combo="/".join(combo), reason=sig.reason,
                           confidence=float(sig.confidence),
                           pred_err=float(sig.pred_err),
                           resid_ape=float(sig.resid_ape))
        if report.n_quarantined:
            self.event(t, "quarantine", clock="epoch",
                       n_rows=int(report.n_quarantined))
        self.event(t, "refit", clock="epoch",
                   n_changed=len(report.changed),
                   n_refit=len(report.refit),
                   n_skipped=len(report.skipped),
                   wall_s=float(report.wall_s))

    # -- views ---------------------------------------------------------------
    def ticks(self) -> Dict[str, np.ndarray]:
        """Column view of the retained tick events."""
        evs = [e for e in self.events if e.kind == "tick"]
        return {k: np.array([e.data[k] for e in evs], np.float64)
                for k in ("predicted", "measured", "confidence", "ape",
                          "pred_err")} | \
            {"t": np.array([e.t for e in evs], np.float64)}

    def reliability(self, n_bins: Optional[int] = None,
                    monotone: bool = True) -> Dict[str, List[float]]:
        tk = self.ticks()
        ok = (tk["ape"] <= self.ape_ok_pct).astype(np.float64)
        return reliability_curve(tk["confidence"], ok,
                                 n_bins or self.reliability_bins,
                                 monotone=monotone)

    def summary(self) -> Dict[str, object]:
        tk = self.ticks()
        ape = tk["ape"]
        fin = ape[np.isfinite(ape)]
        pe = tk["pred_err"]
        pe_fin = pe[np.isfinite(pe)]
        out: Dict[str, object] = {
            "n_events": dict(sorted(self.counts.items())),
            "n_events_retained": len(self.events),
            "ape_ok_pct": self.ape_ok_pct,
            "n_ticks": int(len(ape)),
            "median_ape": float(np.median(fin)) if len(fin) else
            float("inf"),
            "median_confidence": (float(np.median(tk["confidence"]))
                                  if len(ape) else float("nan")),
            "accuracy_rate": (float(np.mean(ape <= self.ape_ok_pct))
                              if len(ape) else float("nan")),
            "median_pred_err": (float(np.median(pe_fin))
                                if len(pe_fin) else float("nan")),
            "reliability": self.reliability(),
        }
        # honesty ratio: realized over predicted error (~1 == honest,
        # >>1 == overconfident)
        if len(fin) and len(pe_fin) and np.median(pe_fin) > 0:
            out["ape_over_pred_err"] = float(np.median(fin)
                                             / np.median(pe_fin))
        return out


def pav(y: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Pool-adjacent-violators: the weighted least-squares
    non-decreasing fit to ``y`` (isotonic regression)."""
    y = np.asarray(y, np.float64).copy()
    w = np.asarray(w, np.float64).copy()
    # blocks as (mean, weight, length) merged right-to-left on violation
    means: List[float] = []
    wts: List[float] = []
    lens: List[int] = []
    for yi, wi in zip(y, w):
        means.append(float(yi))
        wts.append(float(wi))
        lens.append(1)
        while len(means) > 1 and means[-2] > means[-1]:
            m2, w2, l2 = means.pop(), wts.pop(), lens.pop()
            m1, w1, l1 = means.pop(), wts.pop(), lens.pop()
            wt = w1 + w2
            means.append((m1 * w1 + m2 * w2) / wt if wt > 0
                         else (m1 * l1 + m2 * l2) / (l1 + l2))
            wts.append(wt)
            lens.append(l1 + l2)
    return np.concatenate([np.full(l, m) for m, l in zip(means, lens)])


def reliability_curve(conf: np.ndarray, ok: np.ndarray,
                      n_bins: int = 10, monotone: bool = True
                      ) -> Dict[str, List[float]]:
    """Binned confidence vs empirical accuracy.

    ``conf`` in [0, 1] is binned on a uniform grid; empty bins are
    dropped.  With ``monotone=True`` the per-bin accuracies are
    replaced by their PAV fit (weighted by bin count), making the
    returned ``bin_acc`` non-decreasing in confidence — the gate shape
    the obs benchmark asserts.  ``raw_acc`` keeps the pre-PAV values so
    plots can show both."""
    conf = np.asarray(conf, np.float64)
    ok = np.asarray(ok, np.float64)
    keep = np.isfinite(conf)
    conf, ok = conf[keep], ok[keep]
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    idx = np.clip(np.digitize(conf, edges[1:-1]), 0, n_bins - 1)
    bc, ba, bn = [], [], []
    for b in range(n_bins):
        m = idx == b
        if not m.any():
            continue
        bc.append(float(conf[m].mean()))
        ba.append(float(ok[m].mean()))
        bn.append(int(m.sum()))
    raw = list(ba)
    if monotone and len(ba) > 1:
        ba = pav(np.array(ba), np.array(bn, np.float64)).tolist()
    return {"bin_conf": bc, "bin_acc": ba, "raw_acc": raw, "bin_n": bn,
            "monotone": bool(monotone)}
