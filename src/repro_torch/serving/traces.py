"""Workload trace generators for the serving simulator.

A trace is a time-ordered list of requests, each with an arrival time and
a request shape ``(ii, oo)``.  Three arrival processes cover the paper's
"dynamic workload variation" axis:

  * ``poisson`` — memoryless arrivals at a constant rate (the classic
    open-loop load model).
  * ``gamma``   — i.i.d. Gamma inter-arrival gaps with a configurable
    coefficient of variation; cv > 1 is burstier than Poisson, cv < 1
    smoother.
  * ``mmpp``    — 2-state Markov-modulated Poisson process: the rate
    switches between a quiet and a bursty regime with exponentially
    distributed dwell times.  This is the stress case for autoscaling.

Request shapes are drawn from a mixture of lognormal profiles
(chat / summarize / generate presets), clipped to sane token ranges.
Everything is driven by one ``np.random.default_rng(seed)``, so a trace
is exactly replayable from its config + seed.  A copy of the reference
package's ``serving/traces.py``, draw for draw: a seed gives the
reference's trace bit for bit (``tests/test_torch_traces.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    rid: int
    arrival_s: float
    ii: int
    oo: int
    tenant: str = ""              # "" = single-tenant trace


@dataclasses.dataclass(frozen=True)
class ShapeProfile:
    """Lognormal (ii, oo) sampler: ``exp(N(log_mean, sigma))``, clipped."""
    name: str
    ii_log_mean: float
    ii_sigma: float
    oo_log_mean: float
    oo_sigma: float
    ii_range: Tuple[int, int] = (8, 16384)
    oo_range: Tuple[int, int] = (4, 4096)

    def sample(self, n: int, rng: np.random.Generator
               ) -> Tuple[np.ndarray, np.ndarray]:
        ii = np.exp(rng.normal(self.ii_log_mean, self.ii_sigma, n))
        oo = np.exp(rng.normal(self.oo_log_mean, self.oo_sigma, n))
        ii = np.clip(np.round(ii), *self.ii_range).astype(np.int64)
        oo = np.clip(np.round(oo), *self.oo_range).astype(np.int64)
        return ii, oo


# short prompts, medium replies / long prompts, short replies / short
# prompts, long generations — the three canonical serving shapes
CHAT = ShapeProfile("chat", np.log(256.0), 0.6, np.log(160.0), 0.5)
SUMMARIZE = ShapeProfile("summarize", np.log(2048.0), 0.5, np.log(96.0), 0.4)
GENERATE = ShapeProfile("generate", np.log(128.0), 0.5, np.log(512.0), 0.5)
PROFILES: Dict[str, ShapeProfile] = {p.name: p for p in
                                     (CHAT, SUMMARIZE, GENERATE)}


@dataclasses.dataclass(frozen=True)
class ShapeMix:
    """Weighted mixture of profiles; each request draws one component."""
    components: Tuple[ShapeProfile, ...]
    weights: Tuple[float, ...]

    def sample(self, n: int, rng: np.random.Generator
               ) -> Tuple[np.ndarray, np.ndarray]:
        w = np.asarray(self.weights, np.float64)
        w = w / w.sum()
        choice = rng.choice(len(self.components), size=n, p=w)
        ii = np.zeros(n, np.int64)
        oo = np.zeros(n, np.int64)
        for c, prof in enumerate(self.components):
            m = choice == c
            if m.any():
                ii[m], oo[m] = prof.sample(int(m.sum()), rng)
        return ii, oo


def mix(*names_weights: Tuple[str, float]) -> ShapeMix:
    names, weights = zip(*names_weights)
    return ShapeMix(tuple(PROFILES[n] for n in names), tuple(weights))


# -- arrival processes -------------------------------------------------------
def poisson_arrivals(rate: float, horizon_s: float,
                     rng: np.random.Generator) -> np.ndarray:
    n = max(int(rate * horizon_s * 2) + 16, 16)
    gaps = rng.exponential(1.0 / rate, n)
    t = np.cumsum(gaps)
    while t[-1] < horizon_s:          # tail top-up for heavy draws
        more = np.cumsum(rng.exponential(1.0 / rate, n)) + t[-1]
        t = np.concatenate([t, more])
    return t[t < horizon_s]


def gamma_arrivals(rate: float, horizon_s: float, rng: np.random.Generator,
                   cv: float = 2.0) -> np.ndarray:
    """Gamma-renewal arrivals: mean gap 1/rate, coefficient of variation cv."""
    shape = 1.0 / (cv * cv)
    scale = 1.0 / (rate * shape)
    n = max(int(rate * horizon_s * 2) + 16, 16)
    t = np.cumsum(rng.gamma(shape, scale, n))
    while t[-1] < horizon_s:
        t = np.concatenate([t, np.cumsum(rng.gamma(shape, scale, n))
                            + t[-1]])
    return t[t < horizon_s]


def mmpp_arrivals(rate_lo: float, rate_hi: float, horizon_s: float,
                  rng: np.random.Generator, dwell_lo_s: float = 8.0,
                  dwell_hi_s: float = 4.0) -> np.ndarray:
    """2-state MMPP: Poisson at rate_lo / rate_hi with exp. dwell times."""
    out: List[np.ndarray] = []
    t, state = 0.0, 0
    while t < horizon_s:
        dwell = rng.exponential(dwell_lo_s if state == 0 else dwell_hi_s)
        end = min(t + dwell, horizon_s)
        rate = rate_lo if state == 0 else rate_hi
        if rate > 0 and end > t:
            seg = poisson_arrivals(rate, end - t, rng) + t
            out.append(seg)
        t, state = end, 1 - state
    return (np.sort(np.concatenate(out)) if out
            else np.zeros(0, np.float64))


ARRIVALS = {"poisson": poisson_arrivals, "gamma": gamma_arrivals,
            "mmpp": mmpp_arrivals}


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    arrival: str = "poisson"          # poisson | gamma | mmpp
    rate: float = 4.0                 # req/s (mmpp: quiet-state rate)
    horizon_s: float = 60.0
    shape_mix: ShapeMix = dataclasses.field(
        default_factory=lambda: mix(("chat", 1.0)))
    seed: int = 0
    # process-specific knobs
    cv: float = 2.0                   # gamma burstiness
    burst_rate: Optional[float] = None  # mmpp hi-state rate (default 4x)
    dwell_lo_s: float = 8.0
    dwell_hi_s: float = 4.0


@dataclasses.dataclass(frozen=True)
class Trace:
    requests: Tuple[TraceRequest, ...]
    horizon_s: float
    config: Optional[TraceConfig] = None
    fleet_config: Optional["FleetTraceConfig"] = None

    def __len__(self) -> int:
        return len(self.requests)

    @property
    def arrivals(self) -> np.ndarray:
        return np.array([r.arrival_s for r in self.requests])

    def to_arrays(self) -> Dict[str, np.ndarray]:
        return {"arrival_s": self.arrivals,
                "ii": np.array([r.ii for r in self.requests], np.int64),
                "oo": np.array([r.oo for r in self.requests], np.int64),
                "tenant": np.array([r.tenant for r in self.requests],
                                   dtype=object)}

    def slice(self, t0: float, t1: float) -> "Trace":
        """Requests with ``t0 <= arrival < t1``, absolute times and rids
        preserved — one epoch of this trace for the streaming loop
        (pair with ``SimConfig.t_start=t0``)."""
        reqs = tuple(r for r in self.requests if t0 <= r.arrival_s < t1)
        return dataclasses.replace(self, requests=reqs,
                                   horizon_s=float(t1))

    @classmethod
    def from_arrays(cls, arrival_s, ii, oo, tenant=None,
                    horizon_s: Optional[float] = None) -> "Trace":
        order = np.argsort(np.asarray(arrival_s, np.float64),
                           kind="stable")
        ten = (lambda j: str(tenant[j])) if tenant is not None \
            else (lambda j: "")
        reqs = tuple(TraceRequest(rid=int(k), arrival_s=float(arrival_s[j]),
                                  ii=int(ii[j]), oo=int(oo[j]),
                                  tenant=ten(j))
                     for k, j in enumerate(order))
        h = float(horizon_s if horizon_s is not None
                  else (arrival_s[order[-1]] + 1.0 if len(order) else 0.0))
        return cls(requests=reqs, horizon_s=h)

    @property
    def tenants(self) -> Tuple[str, ...]:
        """Distinct tenant names, in first-appearance order."""
        seen: Dict[str, None] = {}
        for r in self.requests:
            seen.setdefault(r.tenant, None)
        return tuple(seen)


def _gen_arrivals(cfg: TraceConfig, rate: float, horizon_s: float,
                  rng: np.random.Generator) -> np.ndarray:
    """Arrival times for ``cfg``'s process at an overridable rate."""
    if cfg.arrival == "poisson":
        return poisson_arrivals(rate, horizon_s, rng)
    if cfg.arrival == "gamma":
        return gamma_arrivals(rate, horizon_s, rng, cv=cfg.cv)
    if cfg.arrival == "mmpp":
        hi = (cfg.burst_rate if cfg.burst_rate is not None
              else 4.0 * cfg.rate)
        # scale both regimes by the same factor so burstiness survives
        hi = hi * (rate / cfg.rate) if cfg.rate > 0 else hi
        return mmpp_arrivals(rate, hi, horizon_s, rng,
                             dwell_lo_s=cfg.dwell_lo_s,
                             dwell_hi_s=cfg.dwell_hi_s)
    raise KeyError(f"unknown arrival process {cfg.arrival!r}; "
                   f"known: {sorted(ARRIVALS)}")


def make_trace(cfg: TraceConfig) -> Trace:
    """Deterministic trace from config + seed (one RNG drives everything)."""
    rng = np.random.default_rng(cfg.seed)
    t = _gen_arrivals(cfg, cfg.rate, cfg.horizon_s, rng)
    ii, oo = cfg.shape_mix.sample(len(t), rng)
    reqs = tuple(TraceRequest(rid=i, arrival_s=float(t[i]),
                              ii=int(ii[i]), oo=int(oo[i]))
                 for i in range(len(t)))
    return Trace(requests=reqs, horizon_s=cfg.horizon_s, config=cfg)


# -- multi-tenant fleet traces ----------------------------------------------
@dataclasses.dataclass(frozen=True)
class TenantConfig:
    """One tenant's workload: a base arrival process modulated in time.

    The tenant's instantaneous rate is
    ``trace.rate * rate_scale * m(t)`` where the envelope
    ``m(t) = diurnal(t) * flash(t)`` combines a sinusoidal diurnal cycle
    (``1 + diurnal_amp * sin(...)``, clipped at 0) with rectangular
    flash-crowd spikes (``flash_mult`` for ``flash_dur_s`` seconds at
    seed-deterministic start times).  Arrivals are generated at the
    envelope's peak rate and thinned by ``m(t)/m_max`` — for Poisson this
    is the exact inhomogeneous-process construction; for Gamma/MMPP it
    modulates the renewal process while preserving its burstiness.
    ``ttft_slo_s`` is the tenant's SLO tier, consumed by
    ``SimResult.per_tenant``.
    """
    name: str
    trace: TraceConfig
    ttft_slo_s: float = 2.0
    rate_scale: float = 1.0
    diurnal_amp: float = 0.0          # 0..1; 0 disables the cycle
    diurnal_period_s: float = 600.0
    diurnal_phase: float = 0.0
    flash_crowds: int = 0             # number of spikes over the horizon
    flash_mult: float = 4.0
    flash_dur_s: float = 20.0

    def envelope(self, t: np.ndarray,
                 crowd_starts: np.ndarray) -> np.ndarray:
        t = np.asarray(t, np.float64)
        m = 1.0 + self.diurnal_amp * np.sin(
            2.0 * np.pi * t / self.diurnal_period_s + self.diurnal_phase)
        m = np.maximum(m, 0.0)
        if len(crowd_starts):
            hit = np.zeros(t.shape, bool)
            for c in crowd_starts:
                hit |= (t >= c) & (t < c + self.flash_dur_s)
            m = m * np.where(hit, self.flash_mult, 1.0)
        return m

    @property
    def envelope_max(self) -> float:
        m = 1.0 + self.diurnal_amp
        return m * self.flash_mult if self.flash_crowds else m


@dataclasses.dataclass(frozen=True)
class FleetTraceConfig:
    """Multi-tenant fleet workload: the union of per-tenant traces."""
    tenants: Tuple[TenantConfig, ...]
    horizon_s: float = 600.0
    seed: int = 0

    @property
    def slo_map(self) -> Dict[str, float]:
        return {tc.name: tc.ttft_slo_s for tc in self.tenants}


def make_fleet_trace(cfg: FleetTraceConfig) -> Trace:
    """Deterministic multi-tenant trace (one sub-stream per tenant).

    Each tenant draws from ``default_rng([seed, tenant_index])`` in a
    fixed order (crowd times, base arrivals, thinning uniforms, shapes),
    so adding a tenant never perturbs the others.  The merged trace is
    time-sorted with renumbered rids; per-request tenancy rides on
    ``TraceRequest.tenant``.
    """
    if not cfg.tenants:
        raise ValueError("FleetTraceConfig needs at least one tenant")
    names = [tc.name for tc in cfg.tenants]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate tenant names: {names}")
    ts, iis, oos, tens = [], [], [], []
    for idx, tc in enumerate(cfg.tenants):
        rng = np.random.default_rng([cfg.seed, idx])
        crowd = (np.sort(rng.uniform(0.0, cfg.horizon_s, tc.flash_crowds))
                 if tc.flash_crowds else np.zeros(0, np.float64))
        m_max = tc.envelope_max
        peak_rate = tc.trace.rate * tc.rate_scale * m_max
        t = _gen_arrivals(tc.trace, peak_rate, cfg.horizon_s, rng)
        keep = rng.random(len(t)) < tc.envelope(t, crowd) / m_max
        t = t[keep]
        ii, oo = tc.trace.shape_mix.sample(len(t), rng)
        ts.append(t)
        iis.append(ii)
        oos.append(oo)
        tens.append(np.array([tc.name] * len(t), dtype=object))
    tr = Trace.from_arrays(np.concatenate(ts), np.concatenate(iis),
                           np.concatenate(oos),
                           tenant=np.concatenate(tens),
                           horizon_s=cfg.horizon_s)
    return dataclasses.replace(tr, fleet_config=cfg)
