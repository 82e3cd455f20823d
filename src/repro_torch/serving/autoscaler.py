"""Control policies for the serving fleet: static baseline + ALA-in-the-loop.

``ALAAutoscaler`` generalizes ``inference.scheduler.plan_batch_size`` to
the dynamic setting.  At every control tick it:

  1. observes the window's arrival rate and mean request shape;
  2. asks ALA for per-replica throughput at each candidate batch cap and
     for the (predicted error, confidence) of that workload region
     (Alg 5 + Alg 8);
  3. derates low-confidence predictions through the shared
    ``derate_confidence`` safety factor — the degenerate sentinel
    (``confidence == 0.0``) never divides by zero, it *falls back to the
    measured rate* from the last window instead (and to the maximally
    derated prediction when the fleet was idle);
  4. sizes the fleet: ``replicas = ceil(demand / (util_target * supply))``
    where demand is the window's output-token arrival rate, plus a queue
    drain term so backlogs clear within roughly one control interval.

Streaming mode: attach a ``repro_torch.core.online.OnlineALA`` (``online`` +
``combo``) and the autoscaler (a) rebinds to the engine's freshest fit
for its combination at every tick — a mid-run refit takes effect on the
next control decision — and (b) accumulates tick-level drift evidence
(median APE of measured vs predicted throughput at the current batch
cap, and Alg 8 confidence) over a rolling window; when the evidence
crosses the thresholds it calls ``online.request_refit`` so the next
epoch ingest recalibrates even under the ``refit="drift"`` policy.
Recalibration requests are logged in ``recalibrations``.

Graceful degradation under faults: predictions are sanity-checked (a
non-finite or non-positive supply falls back to the measured rate, or
holds the fleet when there is nothing measured); sustained
degenerate/low-confidence ticks trigger an exponential backoff during
which the controller stops trusting the model entirely and sizes from
measured throughput only; and scale-*down* requires
``scale_down_patience`` consecutive ticks of evidence, so a
crash-restart flap (capacity dips, the controller scales up, the
replica restores, capacity jumps) does not thrash the replica count.
The controller always plans against *healthy* capacity: crashed
replicas are excluded from ``Observation.n_active_replicas`` by the
simulator, so the absolute target it returns is a healthy-replica
target and the fleet provisions replacements for the dead.

Heterogeneous placement: give the controller a ``hardware_pool`` of
profile names and it additionally decides *which hardware* scale-up
replicas should run on.  Each candidate's throughput is the fitted
prediction times an optional analytic ``hardware_scale`` ratio (the
roofline transfer scaler of ``repro_torch.core.registry``), and its
confidence is the Alg 8 region confidence *re-squashed with the
hardware-descriptor distance* from the fitted hardware
(``repro_torch.core.uncertainty.confidence_from_dmin``) — so a faraway
accelerator must promise proportionally more derated throughput to win
the placement.  The winner rides out on ``Action.hardware``;
``placement="roundrobin"`` is the hardware-blind baseline that cycles
the pool without consulting predictions.

``StaticPolicy`` is the static-bb baseline the benchmark compares
against: fixed replica count, fixed admission cap, no feedback.

A copy of the reference package's ``serving/autoscaler.py`` over the
port's ``ALA`` and ``OnlineALA``: given the same fits it takes the
reference's action at every tick (``tests/test_torch_autoscaler.py``),
and with ``obs`` or ``audit`` set it logs the reference's tick,
recalibration and degradation events
(``tests/test_torch_obs_calibration.py``).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.ala import ALA
from repro_torch.core.uncertainty import confidence_from_dmin
from repro_torch.inference.scheduler import derate_confidence
from repro_torch.obs.calibration import CalibrationAudit
from repro_torch.obs.metrics import RingLog
from repro_torch.perfmodel.hardware import PROFILES, hardware_distance
from repro_torch.serving.simulator import Action, Observation


@dataclasses.dataclass
class StaticPolicy:
    """No-op controller: whatever it was told at construction, forever."""
    n_replicas: int = 1
    batch_cap: int = 64

    def control(self, obs: Observation) -> Action:
        return Action(n_replicas=self.n_replicas, batch_cap=self.batch_cap)


@dataclasses.dataclass
class ALAAutoscaler:
    ala: ALA
    candidate_bb: Tuple[int, ...] = (8, 16, 32, 64, 128)
    confidence_floor: float = 0.7
    min_derate: float = 0.25
    util_target: float = 0.75         # provision 1/util_target headroom
    min_replicas: int = 1
    max_replicas: int = 8
    # diagnostics: (confidence, derate, used_fallback) per control tick
    log: list = dataclasses.field(default_factory=list)
    # streaming mode: online engine + this fleet's combination key
    online: Optional[object] = None       # repro_torch.core.online.OnlineALA
    combo: Optional[Tuple[str, ...]] = None
    drift_window: int = 6                 # ticks of evidence before acting
    drift_ape_threshold: float = 50.0     # median window APE (%) trigger
    drift_conf_floor: float = 0.05        # median window confidence trigger
    # (t, median_ape, median_conf) per requested recalibration
    recalibrations: list = dataclasses.field(default_factory=list)
    # graceful degradation: backoff after sustained unreliable ticks,
    # hysteresis against crash-restart flapping
    backoff_after: int = 3            # consecutive unreliable ticks to arm
    backoff_base: int = 2             # ticks held on first backoff
    backoff_cap: int = 16             # doubling stops here
    backoff_conf_floor: float = 0.05  # conf below this counts as unreliable
    scale_down_patience: int = 2      # consecutive shrink-wanting ticks
    # coarse time-bucketed stepping can deliver a control tick whose
    # window collapsed to (near) zero width; rates computed over it are
    # meaningless, so the controller holds the fleet instead
    min_window_s: float = 1e-6
    # (t, kind) per degradation action: "backoff" | "hold_down" |
    # "zero_window"
    degradations: list = dataclasses.field(default_factory=list)
    # heterogeneous placement: candidate hardware (profile names) for
    # replicas this controller *creates*.  Empty -> hardware-agnostic
    # (Action.hardware stays None, slot defaults apply).
    hardware_pool: Tuple[str, ...] = ()
    # hardware the ALA database was fitted on; cross-hardware candidates
    # are derated by descriptor distance from it.  None -> distance 0.
    fitted_hardware: Optional[str] = None
    # optional analytic scalers: profile name -> f(ii, oo, bb) ->
    # throughput multiplier vs the fitted hardware (see
    # repro_torch.core.registry roofline transfer)
    hardware_scale: Optional[dict] = None
    placement: str = "aware"          # "aware" | "roundrobin" (blind)
    # (t, hardware, derated score) per placement decision
    placements: list = dataclasses.field(default_factory=list)
    # observability (repro_torch.obs): an ObsConfig and/or a
    # CalibrationAudit.  Passing `obs` with no audit builds one; every
    # control tick then lands in the audit as a typed "tick" event
    # (predicted vs measured throughput, Alg 7 predicted error, Alg 8
    # confidence) alongside the degradation / recalibration decision
    # events.
    obs: Optional[object] = None          # repro_torch.obs.ObsConfig
    audit: Optional[object] = None        # repro_torch.obs.CalibrationAudit
    # ring-cap for log/recalibrations/degradations/placements; None ->
    # unbounded (falls back to obs.max_log_entries when obs is set)
    max_log_entries: Optional[int] = None
    _rr_idx: int = dataclasses.field(default=0, repr=False)
    _last_pred_err: float = dataclasses.field(default=float("nan"),
                                              repr=False)
    _resid: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=64), repr=False)
    _generation: int = dataclasses.field(default=0, repr=False)
    _unreliable_streak: int = dataclasses.field(default=0, repr=False)
    _backoff_left: int = dataclasses.field(default=0, repr=False)
    _backoff_len: int = dataclasses.field(default=0, repr=False)
    _down_streak: int = dataclasses.field(default=0, repr=False)

    def __post_init__(self) -> None:
        if self.audit is None and self.obs is not None \
                and getattr(self.obs, "enabled", True):
            self.audit = CalibrationAudit(cfg=self.obs)
        cap = self.max_log_entries or getattr(self.obs, "max_log_entries",
                                              None)
        if cap:
            self.log = RingLog(cap, self.log)
            self.recalibrations = RingLog(cap, self.recalibrations)
            self.degradations = RingLog(cap, self.degradations)
            self.placements = RingLog(cap, self.placements)

    def _degrade(self, t: float, kind: str) -> None:
        self.degradations.append((t, kind))
        if self.audit is not None:
            self.audit.event(t, "degradation", reason=kind)

    def _refresh_online(self) -> None:
        """Rebind to the engine's freshest fit for our combination —
        how a mid-run recalibration reaches the control loop.  The
        engine refits ALA objects *in place*, so recalibrations are
        detected through its generation counter, not object identity."""
        if self.online is None or self.combo is None:
            return
        gen = self.online.generation_of(self.combo)
        if gen != self._generation:
            self._generation = gen
            fresh = self.online.ala_for(self.combo)
            if fresh is not None:
                self.ala = fresh
            self._resid.clear()       # evidence against the old fit

    def _note_drift(self, obs: Observation, conf: float) -> None:
        """Tick-level drift evidence: measured vs predicted throughput at
        the batch size the fleet is *actually running* (the admission
        cap would overstate throughput on a lightly loaded fleet and
        read as permanent drift), plus the Alg 8 confidence."""
        if obs.measured_tok_s <= 0.0 or obs.n_running <= 0:
            return
        bb_now = min(max(obs.n_running
                         / max(obs.n_active_replicas, 1), 1.0),
                     float(obs.batch_cap))
        pred = float(self.ala.predict([obs.mean_ii], [obs.mean_oo],
                                      [bb_now])[0])
        # a poisoned fit predicting NaN/inf is maximal drift evidence,
        # not a reason to go quiet — count it as an unbounded residual
        ape = (abs(obs.measured_tok_s - pred) / max(abs(pred), 1e-9)
               * 100.0 if np.isfinite(pred) else float("inf"))
        self._resid.append((ape, conf))
        if self.audit is not None:
            # the predict->observe->trust audit record: Alg 4 prediction
            # vs the realized window, with Alg 7's own error estimate
            # (captured by the last _predict_per_replica) riding along
            self.audit.tick(obs.now, predicted=pred,
                            measured=obs.measured_tok_s, confidence=conf,
                            ape=ape, pred_err=self._last_pred_err)
        if self.online is None or self.combo is None:
            return
        if len(self._resid) < self.drift_window:
            return
        recent = list(self._resid)[-self.drift_window:]
        med_ape = float(np.median([a for a, _ in recent]))
        med_conf = float(np.median([c for _, c in recent]))
        if med_ape > self.drift_ape_threshold \
                or med_conf < self.drift_conf_floor:
            self.online.request_refit(self.combo)
            self.recalibrations.append((obs.now, med_ape, med_conf))
            if self.audit is not None:
                self.audit.event(obs.now, "recalibration",
                                 median_ape=med_ape,
                                 median_confidence=med_conf)
            self._resid.clear()

    def _predict_per_replica(self, ii: float, oo: float
                             ) -> Tuple[int, float, float]:
        """(best bb, predicted tok/s at it, confidence of the region)."""
        bbs = np.asarray(self.candidate_bb, np.float64)
        thpt = np.asarray(self.ala.predict(np.full(len(bbs), ii),
                                           np.full(len(bbs), oo), bbs),
                          np.float64)
        conf = 1.0
        self._last_pred_err = float("nan")
        if self.ala.error_model is not None and self.ala.sa_log is not None:
            q = (np.full(len(bbs), ii), np.full(len(bbs), oo), bbs,
                 np.full(len(bbs), np.nan))
            pred_err, conf = self.ala.estimate(q)
            self._last_pred_err = float(pred_err)   # Alg 7 predicted APE
        # a corrupted fit can emit NaN/inf/negative throughput; never let
        # argmax pick it — if nothing valid remains, report the
        # degenerate sentinel so the caller falls back to measured rates
        thpt = np.where(np.isfinite(thpt), thpt, -np.inf)
        if not (thpt > 0.0).any():
            return int(bbs[-1]), float("nan"), 0.0
        i = int(np.argmax(thpt))
        return int(bbs[i]), float(thpt[i]), float(conf)

    def _choose_hardware(self, obs: Observation, bb: int, pred: float,
                         conf: float) -> Tuple[str, float, float]:
        """Pick the hardware for scale-up replicas.

        Returns ``(profile name, predicted tok/s on it, transferred
        confidence)``.  The score is the transfer-scaled prediction
        derated by the *cross-hardware* confidence: the fitted-hardware
        region distance re-squashed with the descriptor distance
        (identical hardware keeps ``conf`` exactly)."""
        pool = self.hardware_pool
        if self.placement == "roundrobin":
            # hardware-blind baseline: cycle the pool, never consult
            # predictions or descriptor distances
            name = pool[self._rr_idx % len(pool)]
            self._rr_idx += 1
            self.placements.append((obs.now, name, float("nan")))
            return name, pred, conf
        # invert the Alg 8 squash to recover the region's workload
        # distance, then re-squash per candidate with its hw distance
        d_min = (1.0 / conf - 1.0) if np.isfinite(conf) and conf > 0.0 \
            else float("inf")
        best = None
        for name in pool:
            if self.fitted_hardware is None or name == self.fitted_hardware:
                d_hw = 0.0
            elif self.fitted_hardware in PROFILES and name in PROFILES:
                d_hw = hardware_distance(PROFILES[self.fitted_hardware],
                                         PROFILES[name])
            else:
                d_hw = float("inf")   # unknown descriptor: no trust
            conf_hw = confidence_from_dmin(d_min, hw_dist=d_hw)
            scale = 1.0
            if self.hardware_scale and name in self.hardware_scale:
                scale = float(self.hardware_scale[name](
                    obs.mean_ii, obs.mean_oo, float(bb)))
            pred_hw = pred * scale
            score = pred_hw * derate_confidence(
                conf_hw, self.confidence_floor, self.min_derate)
            if best is None or score > best[0]:
                best = (score, name, pred_hw, conf_hw)
        score, name, pred_hw, conf_hw = best
        self.placements.append((obs.now, name, float(score)))
        return name, pred_hw, conf_hw

    def control(self, obs: Observation) -> Action:
        self._refresh_online()
        if obs.window_s < self.min_window_s:
            # degenerate zero-width window (coarse bucketed stepping):
            # arrival_rate/backlog terms would divide by ~0 — hold
            self._degrade(obs.now, "zero_window")
            return Action(n_replicas=max(obs.n_active_replicas,
                                         self.min_replicas),
                          batch_cap=obs.batch_cap)
        if obs.n_arrivals == 0:
            # idle window: hold the fleet, nothing to infer demand from
            return Action(n_replicas=obs.n_active_replicas,
                          batch_cap=obs.batch_cap)
        bb, pred, conf = self._predict_per_replica(obs.mean_ii, obs.mean_oo)
        self._note_drift(obs, conf)
        hw_choice = None
        if self.hardware_pool:
            hw_choice, pred_hw, conf_hw = self._choose_hardware(
                obs, bb, pred, conf)
            if self.placement == "aware" and np.isfinite(pred_hw) \
                    and pred_hw > 0.0:
                # size the fleet against the hardware we will actually
                # provision, at its transferred confidence
                pred, conf = pred_hw, conf_hw
        # --- backoff bookkeeping: sustained unreliable ticks arm an
        # exponential hold during which the model is not consulted ------
        unreliable = (not np.isfinite(pred)) or pred <= 0.0 \
            or (not np.isfinite(conf)) or conf <= self.backoff_conf_floor
        if unreliable:
            self._unreliable_streak += 1
        else:
            self._unreliable_streak = 0
            self._backoff_len = 0
        in_backoff = False
        if self._backoff_left > 0:
            self._backoff_left -= 1
            in_backoff = True
        elif self._unreliable_streak >= self.backoff_after:
            self._backoff_len = int(min(
                max(2 * self._backoff_len, self.backoff_base),
                self.backoff_cap))
            self._backoff_left = self._backoff_len - 1
            self._unreliable_streak = 0
            in_backoff = True
            self._degrade(obs.now, "backoff")
        derate = derate_confidence(conf, self.confidence_floor,
                                   self.min_derate)
        fallback = obs.measured_tok_s > 0.0 and (
            conf <= 0.0 or in_backoff
            or not np.isfinite(pred) or pred <= 0.0)
        if fallback:
            # degenerate sentinel / backoff: trust what the fleet served
            supply = obs.measured_tok_s
            if in_backoff:
                bb = obs.batch_cap    # don't re-plan the cap off the model
        else:
            supply = pred * derate
        if not np.isfinite(supply) or supply <= 0.0:
            # poisoned prediction and nothing measured: hold the fleet
            self.log.append((float(conf), float(derate), True))
            return Action(n_replicas=max(obs.n_active_replicas,
                                         self.min_replicas),
                          batch_cap=obs.batch_cap)
        self.log.append((float(conf), float(derate), bool(fallback)))
        # demand: fresh output tokens/s plus draining the standing queue
        demand = obs.arrival_rate * obs.mean_oo
        backlog = (obs.queue_len * obs.mean_oo) / max(obs.window_s, 1e-9)
        need = (demand + backlog) / max(self.util_target * supply, 1e-9)
        n = int(np.clip(int(np.ceil(need)), self.min_replicas,
                        self.max_replicas))
        # --- scale-down hysteresis: a crash-restart flap reads as a
        # capacity dip then a jump; require sustained evidence to shrink
        cur = max(obs.n_active_replicas, self.min_replicas)
        if n < cur:
            self._down_streak += 1
            if self._down_streak < self.scale_down_patience:
                self._degrade(obs.now, "hold_down")
                n = cur
        else:
            self._down_streak = 0
        return Action(n_replicas=n, batch_cap=bb, hardware=hw_choice)
