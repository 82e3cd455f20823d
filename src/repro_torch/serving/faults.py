"""Seed-deterministic fault injection for the serving fleet.

Real fleets lose replicas, straggle, and emit garbage telemetry; the
paper's promise of *robust* statistical prediction is only credible if
the serving loop survives all three.  This module builds replayable
fault timelines the same way ``serving.traces`` builds request
timelines: one ``np.random.default_rng(seed)`` drives every draw, so a
``FaultPlan`` is a pure function of its config and two builds at the
same seed are bit-identical.  A copy of the reference package's
``serving/faults.py``, draw for draw: a seed gives the reference's plan,
fingerprint and corrupted rows (``tests/test_torch_traces.py``).

Three fault classes:

  * **crash/restart cycles** — per-replica exponential MTTF/MTTR draws
    produce ``CrashWindow(replica, t_down, t_up)`` outages.  The
    simulator loses the replica's KV state at ``t_down`` (in-flight
    sequences requeue under a bounded retry budget + deadline shedding)
    and pays ``restart_warmup_s`` after ``t_up`` before the replica
    serves again.
  * **straggler windows** — per-replica Poisson-arriving
    ``StragglerWindow(replica, t0, t1, slow)`` spans during which every
    step on that replica runs ``slow``× longer (thermal throttling,
    noisy neighbours, collective stragglers).
  * **telemetry corruption** — ``corrupt_rows`` mangles the adapter's
    window rows on their way to the online engine: rows are dropped,
    duplicated, NaN/inf-poisoned, or scale-poisoned (finite but wildly
    wrong throughput — the dangerous direction for an autoscaler is
    *optimistic* corruption, so scale poison is biased upward).  The
    returned ``CorruptionReport`` marks exactly which rows a perfect
    filter would have removed, which is what the quarantine parity
    tests compare the robust-ingestion gate against.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    seed: int = 0
    horizon_s: float = 60.0
    n_replicas: int = 8               # plan covers replica ids [0, n)
    # crash/restart: exponential MTTF / MTTR per replica
    mttf_s: float = float("inf")      # inf -> no crashes
    mttr_s: float = 5.0
    restart_warmup_s: float = 1.0     # paid after t_up, before serving
    # transient stragglers: Poisson windows per replica
    straggler_rate_hz: float = 0.0    # windows / second / replica
    straggler_dur_s: float = 5.0      # mean (exponential) window length
    straggler_slow: float = 3.0       # step-time multiplier inside a window
    # telemetry corruption: per-row probabilities on the adapter stream
    drop_p: float = 0.0
    dup_p: float = 0.0
    poison_nan_p: float = 0.0
    poison_scale_p: float = 0.0
    poison_scale: float = 50.0        # magnitude of finite scale poison


@dataclasses.dataclass(frozen=True)
class CrashWindow:
    replica: int
    t_down: float
    t_up: float


@dataclasses.dataclass(frozen=True)
class StragglerWindow:
    replica: int
    t0: float
    t1: float
    slow: float


@dataclasses.dataclass
class FaultEvent:
    """One entry of ``SimResult.fault_log`` — what actually fired."""
    t: float
    kind: str                         # "crash" | "restore" | "warm"
    replica: int
    n_displaced: int = 0


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    cfg: FaultConfig
    crashes: Tuple[CrashWindow, ...]
    stragglers: Tuple[StragglerWindow, ...]

    @classmethod
    def build(cls, cfg: FaultConfig) -> "FaultPlan":
        """Deterministic timeline from config + seed.  Replicas are drawn
        in id order from one RNG, so the plan replays exactly."""
        rng = np.random.default_rng(cfg.seed)
        crashes: List[CrashWindow] = []
        if np.isfinite(cfg.mttf_s) and cfg.mttf_s > 0:
            for r in range(cfg.n_replicas):
                t = float(rng.exponential(cfg.mttf_s))
                while t < cfg.horizon_s:
                    down = float(rng.exponential(cfg.mttr_s))
                    crashes.append(CrashWindow(replica=r, t_down=t,
                                               t_up=t + down))
                    t += down + float(rng.exponential(cfg.mttf_s))
        stragglers: List[StragglerWindow] = []
        if cfg.straggler_rate_hz > 0:
            for r in range(cfg.n_replicas):
                t = float(rng.exponential(1.0 / cfg.straggler_rate_hz))
                while t < cfg.horizon_s:
                    dur = float(rng.exponential(cfg.straggler_dur_s))
                    stragglers.append(StragglerWindow(
                        replica=r, t0=t, t1=t + dur,
                        slow=float(cfg.straggler_slow)))
                    t += dur + float(
                        rng.exponential(1.0 / cfg.straggler_rate_hz))
        return cls(cfg=cfg, crashes=tuple(crashes),
                   stragglers=tuple(stragglers))

    def fingerprint(self) -> str:
        """Stable digest of the timeline — reruns at a fixed seed must
        reproduce it bit-identically."""
        h = hashlib.sha256()
        for c in self.crashes:
            h.update(f"c{c.replica}:{c.t_down!r}:{c.t_up!r};".encode())
        for s in self.stragglers:
            h.update(f"s{s.replica}:{s.t0!r}:{s.t1!r}:{s.slow!r};".encode())
        return h.hexdigest()[:16]


@dataclasses.dataclass
class CorruptionReport:
    """What ``corrupt_rows`` did — and what a perfect filter would keep.

    ``clean_rows`` is the corrupted stream minus poisoned rows and minus
    duplicate copies (dropped rows are simply gone; no filter can
    recover them).  The robust-ingestion gate is graded against it."""
    n_in: int = 0
    n_dropped: int = 0
    n_duplicated: int = 0
    n_poisoned: int = 0
    clean_rows: List[Dict] = dataclasses.field(default_factory=list)


class FaultInjector:
    """Runtime face of a ``FaultPlan``.

    The crash/straggler timeline is the immutable plan; telemetry
    corruption consumes a dedicated RNG stream (derived from the plan
    seed), so two injectors built from the same plan corrupt identical
    row streams identically — per-policy benchmark runs see the same
    corruption sequence."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.cfg = plan.cfg
        self._windows: Dict[int, List[StragglerWindow]] = {}
        for w in plan.stragglers:
            self._windows.setdefault(w.replica, []).append(w)
        for ws in self._windows.values():
            ws.sort(key=lambda w: w.t0)
        self._telemetry_rng = np.random.default_rng(
            [self.cfg.seed, 0x7E1E])

    # -- crash / straggler queries ------------------------------------------
    def crash_windows(self) -> Tuple[CrashWindow, ...]:
        return self.plan.crashes

    def slow_factor(self, replica: int, t: float) -> float:
        for w in self._windows.get(replica, ()):  # few windows per replica
            if w.t0 <= t < w.t1:
                return w.slow
            if w.t0 > t:
                break
        return 1.0

    def straggler_boundaries(self, replica: int) -> np.ndarray:
        """Sorted times at which ``slow_factor`` changes for a replica.

        The vectorized fleet engine segments its batched decode runs at
        these boundaries so every step still picks up the slow factor in
        force at its *start* time — the event-heap semantics."""
        out: List[float] = []
        for w in self._windows.get(replica, ()):
            out.append(w.t0)
            out.append(w.t1)
        return np.array(sorted(out), np.float64)

    # -- telemetry corruption -----------------------------------------------
    def corrupt_rows(self, rows: List[Dict]
                     ) -> Tuple[List[Dict], CorruptionReport]:
        """Mangle adapter window rows on the way to the online engine.

        Per row, mutually exclusive draws: drop it, duplicate it (the
        copy is the corruption artifact), poison ``thpt`` with NaN/inf,
        or scale-poison ``thpt`` by ``poison_scale`` (biased upward —
        optimistic corruption under-provisions a trusting autoscaler).
        """
        cfg, rng = self.cfg, self._telemetry_rng
        rep = CorruptionReport(n_in=len(rows))
        out: List[Dict] = []
        for row in rows:
            u = float(rng.random())
            if u < cfg.drop_p:
                rep.n_dropped += 1
                continue
            u -= cfg.drop_p
            if u < cfg.dup_p:
                rep.n_duplicated += 1
                out.append(dict(row))
                out.append(dict(row))        # exact duplicate copy
                rep.clean_rows.append(dict(row))
                continue
            u -= cfg.dup_p
            if u < cfg.poison_nan_p:
                bad = dict(row)
                bad["thpt"] = float("nan") if rng.random() < 0.5 \
                    else float("inf")
                rep.n_poisoned += 1
                out.append(bad)
                continue
            u -= cfg.poison_nan_p
            if u < cfg.poison_scale_p:
                bad = dict(row)
                # 3:1 biased toward inflation — the dangerous direction
                scale = (cfg.poison_scale if rng.random() < 0.75
                         else 1.0 / cfg.poison_scale)
                bad["thpt"] = float(bad["thpt"]) * scale
                rep.n_poisoned += 1
                out.append(bad)
                continue
            out.append(dict(row))
            rep.clean_rows.append(dict(row))
        return out, rep


def injector(cfg: FaultConfig) -> FaultInjector:
    """One-call convenience: ``FaultInjector(FaultPlan.build(cfg))``."""
    return FaultInjector(FaultPlan.build(cfg))
