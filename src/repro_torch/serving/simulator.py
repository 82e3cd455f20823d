"""Discrete-event continuous-batching serving simulator.

Each replica is a continuous-batching engine over the roofline step-time
primitives of ``repro_torch.perfmodel.simulator``: an iteration is either a
*prefill step* (admits up to ``max_prefill_requests`` waiting requests,
costed by ``prefill_step_time`` over their heterogeneous prompt lengths)
or a *decode step* (every running sequence emits one token, costed by
``decode_step_time_group`` over their current contexts).  Prefill is
prioritized — the vLLM-style default.  KV memory is accounted per
``HardwareProfile``: a request reserves ``ii + oo`` tokens of KV at
admission (no mid-flight eviction), bounded by ``kv_capacity_tokens``.

The fleet layer routes arrivals to the least-loaded active replica and
fires a control event every ``control_interval_s``; a policy object
(see ``repro_torch.serving.autoscaler``) observes the last window and sets the
replica count and the per-replica admission batch cap.  New replicas
come up after ``provision_delay_s``; scale-down drains (stops routing,
finishes in-flight work).  Every event pops through one seeded,
counter-tiebroken heap, so a run is exactly reproducible.

Fault injection (``SimConfig.faults`` = a ``serving.faults``
``FaultInjector``): replica crash/restart windows enter the same event
heap.  A crash loses the replica's KV state — in-flight sequences are
requeued to surviving replicas under a bounded retry budget
(``max_retries``) with deadline-based shedding (``shed_after_s``);
restarts pay ``restart_warmup_s`` through the provisioning path before
serving again.  Straggler windows multiply that replica's step times.
Every admitted request ends as exactly one of completed / shed
(``SimResult.check_conservation`` enforces it), and shed requests count
as SLO misses in *both* ``slo_attainment`` and ``ttft_percentile``.

Metrics: per-request TTFT / TPOT / E2E (+ retry/shed accounting), fleet
goodput, TTFT-SLO attainment (shed and unfinished requests count as
misses), replica-seconds (cost), availability under faults, and the raw
step log consumed by ``repro_torch.serving.adapter``.

A copy of the reference package's ``serving/simulator.py``: a seeded
trace gives the reference's records, steps and metrics bit for bit
(``tests/test_torch_serving.py``).  With ``SimConfig.obs`` set it
also caps the step and fault logs and derives the reference's span
table (``tests/test_torch_obs_tracing.py``).
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs.metrics import (RingLog,  # noqa: F401
                                     percentile_with_inf, tenant_rollup)
from repro_torch.perfmodel.simulator import (ServingSetup,
                                             decode_step_time_group,
                                             kv_capacity_tokens,
                                             prefill_step_time)
from repro_torch.serving.faults import FaultEvent
from repro_torch.serving.traces import Trace, TraceRequest

# percentile_with_inf lives in repro_torch.obs.metrics; re-exported here
# as the reference does.

_ARRIVAL, _STEP_DONE, _CONTROL, _PROVISION, _CRASH, _RESTORE = range(6)


@dataclasses.dataclass
class SimConfig:
    setup: ServingSetup
    batch_cap: int = 64
    max_prefill_requests: int = 8
    n_replicas: int = 1
    max_replicas: int = 8
    # heterogeneous fleets: per-slot hardware.  Replica rid takes
    # ``replica_setups[rid % len(replica_setups)]`` (cycling keeps
    # autoscaler-created replicas deterministic); None -> every replica
    # runs ``setup``.  A policy Action naming a hardware profile
    # overrides the slot default for replicas it creates.
    replica_setups: Optional[Tuple[ServingSetup, ...]] = None
    control_interval_s: float = 2.0
    provision_delay_s: float = 1.0
    drain_s: float = 120.0            # grace period past the horizon
    kv_capacity_override: Optional[float] = None  # tokens; None -> profile
    # epochal streaming: start the clock (and the first control tick)
    # at an offset so a Trace.slice with absolute arrival times replays
    # as one epoch of a longer run instead of idling from t = 0
    t_start: float = 0.0
    # fault injection (see repro_torch.serving.faults)
    faults: Optional[object] = None   # FaultInjector; None -> fault-free
    max_retries: int = 2              # crash requeues per request
    shed_after_s: Optional[float] = None  # age limit at requeue; None -> off
    # vectorized fleet engine (see repro_torch.serving.fleet): admissions are
    # quantized to bucket boundaries — the documented parity tolerance
    bucket_s: float = 0.25
    traj_backend: str = "numpy"       # "numpy" | "torch" decode-run math
    # where traj_backend="torch" computes: None -> the GPU (raises
    # without CUDA), "cpu" for the tests
    device: Optional[object] = None

    # observability hook (repro_torch.obs.tracing.ObsConfig); None -> no
    # span capture, unbounded telemetry buffers (typed loosely like
    # `faults` to keep this module import-light)
    obs: Optional[object] = None

    def setup_for(self, rid: int, hardware: Optional[str] = None
                  ) -> ServingSetup:
        """Resolve the ServingSetup for replica ``rid``.

        ``hardware`` (a ``repro_torch.perfmodel.hardware`` profile name, e.g.
        from ``Action.hardware``) overrides the slot default's
        accelerator while keeping the model/parallelism unchanged."""
        base = (self.replica_setups[rid % len(self.replica_setups)]
                if self.replica_setups else self.setup)
        if hardware is not None and hardware != base.hw.name:
            from repro_torch.perfmodel.hardware import profile
            base = dataclasses.replace(base, hw=profile(hardware))
        return base

    def kv_cap_for(self, setup: ServingSetup) -> float:
        # kv_capacity_override is uniform across hardware — it models a
        # software cap (e.g. a scheduler limit), not HBM size
        return (self.kv_capacity_override
                if self.kv_capacity_override is not None
                else kv_capacity_tokens(setup))

    def slot_setups(self) -> Tuple[ServingSetup, ...]:
        return tuple(self.replica_setups) if self.replica_setups \
            else (self.setup,)


@dataclasses.dataclass
class RequestRecord:
    rid: int
    ii: int
    oo: int
    arrival_s: float
    tenant: str = ""
    replica: int = -1
    first_token_s: Optional[float] = None
    done_s: Optional[float] = None
    retries: int = 0                  # crash-driven requeues
    shed: bool = False                # dropped: never completed
    shed_s: Optional[float] = None
    shed_reason: str = ""             # oversized|retry_budget|deadline|unserved

    @property
    def completed(self) -> bool:
        return self.done_s is not None

    @property
    def ttft_s(self) -> float:
        return (self.first_token_s - self.arrival_s
                if self.first_token_s is not None else float("inf"))

    @property
    def e2e_s(self) -> float:
        return (self.done_s - self.arrival_s if self.done_s is not None
                else float("inf"))

    @property
    def tpot_s(self) -> float:
        if self.done_s is None or self.first_token_s is None:
            return float("inf")
        return (self.done_s - self.first_token_s) / max(self.oo - 1, 1)


@dataclasses.dataclass
class StepRecord:
    t_end: float
    replica: int
    kind: str                          # "prefill" | "decode"
    bb: int
    duration_s: float
    tokens_out: int


class _Seq:
    __slots__ = ("rec", "generated")

    def __init__(self, rec: RequestRecord):
        self.rec = rec
        self.generated = 0

    @property
    def context(self) -> int:
        return self.rec.ii + self.generated


class Replica:
    def __init__(self, rid: int, setup: ServingSetup, batch_cap: int,
                 max_prefill: int, kv_capacity: float):
        self.rid = rid
        self.setup = setup
        self.batch_cap = batch_cap
        self.max_prefill = max_prefill
        self.kv_capacity = kv_capacity
        self.waiting: Deque[_Seq] = collections.deque()
        self.running: List[_Seq] = []
        self.prefilling: List[_Seq] = []
        self.kv_reserved = 0.0
        self.busy = False
        self.draining = False
        self.active = True            # provisioned and routable
        self.provisioning = False     # _PROVISION event in flight
        self.failed = False           # crashed: down until its restore
        self.restore_to_active = True  # what the restore should bring back
        self.incarnation = 0          # bumps on crash; stale steps ignored

    @property
    def load(self) -> int:
        return len(self.waiting) + len(self.running) + len(self.prefilling)

    def _kv_need(self, s: _Seq) -> float:
        return float(s.rec.ii + s.rec.oo)

    def fail(self) -> Tuple[List["_Seq"], List["_Seq"]]:
        """Crash: lose all KV state.  Returns (in-flight, queued) — the
        in-flight sequences lost computed KV (a retry), the queued ones
        merely need rerouting.  Any step completion already in the heap
        belongs to the old incarnation and is ignored when it pops."""
        self.restore_to_active = (self.active or self.provisioning) \
            and not self.draining
        inflight = list(self.prefilling) + list(self.running)
        queued = list(self.waiting)
        self.prefilling, self.running = [], []
        self.waiting.clear()
        self.kv_reserved = 0.0
        self.busy = False
        self.active = False
        self.provisioning = False
        self.draining = False
        self.failed = True
        self.incarnation += 1
        return inflight, queued

    def begin_step(self) -> Optional[Tuple[float, str]]:
        """Pick the next iteration; returns (duration, kind) or None."""
        admit: List[_Seq] = []
        while (self.waiting and len(admit) < self.max_prefill
               and len(self.running) + len(admit) < self.batch_cap
               and self.kv_reserved + self._kv_need(self.waiting[0])
               <= self.kv_capacity):
            s = self.waiting.popleft()
            self.kv_reserved += self._kv_need(s)
            admit.append(s)
        if admit:
            self.prefilling = admit
            dur = prefill_step_time(self.setup,
                                    [s.rec.ii for s in admit])
            return dur, "prefill"
        if self.running:
            dur = decode_step_time_group(self.setup,
                                         [s.context for s in self.running])
            return dur, "decode"
        return None

    def finish_step(self, kind: str, t_end: float) -> List[RequestRecord]:
        """Apply a completed iteration; returns finished request records."""
        done: List[RequestRecord] = []
        if kind == "prefill":
            for s in self.prefilling:
                s.generated = 1
                s.rec.first_token_s = t_end
                if s.generated >= s.rec.oo:
                    s.rec.done_s = t_end
                    self.kv_reserved -= self._kv_need(s)
                    done.append(s.rec)
                else:
                    self.running.append(s)
            self.prefilling = []
        else:
            still: List[_Seq] = []
            for s in self.running:
                s.generated += 1
                if s.generated >= s.rec.oo:
                    s.rec.done_s = t_end
                    self.kv_reserved -= self._kv_need(s)
                    done.append(s.rec)
                else:
                    still.append(s)
            self.running = still
        return done


@dataclasses.dataclass
class Observation:
    """What a control policy sees at each control tick."""
    now: float
    window_s: float
    n_arrivals: int
    mean_ii: float                    # over window arrivals (0 if none)
    mean_oo: float
    arrival_rate: float               # req/s over the window
    queue_len: int                    # fleet-wide waiting requests
    n_running: int
    n_active_replicas: int
    batch_cap: int
    decode_tokens: int                # emitted in window, fleet-wide
    busy_s: float                     # summed step time in window
    measured_tok_s: float             # decode_tokens / busy_s (0 if idle)
    n_failed_replicas: int = 0        # crashed replicas currently down


@dataclasses.dataclass
class Action:
    n_replicas: int
    batch_cap: int
    # hardware profile name for replicas this action *creates* (scale-up
    # beyond warm/decommissioned capacity).  None -> the slot default
    # from SimConfig.setup_for.  Existing replicas never migrate.
    hardware: Optional[str] = None


@dataclasses.dataclass
class SimResult:
    records: List[RequestRecord]
    steps: List[StepRecord]
    sim_end_s: float
    n_events: int
    replica_seconds: float
    controls: List[Tuple[float, Action]]
    t_start: float = 0.0              # epochal replay offset (absolute)
    availability: float = 1.0         # healthy / (healthy + crashed) rs
    fault_log: List[FaultEvent] = dataclasses.field(default_factory=list)
    # rid -> hardware profile name; heterogeneous fleets use this to
    # attribute steps/requests to the hardware that served them
    replica_hw: Dict[int, str] = dataclasses.field(default_factory=dict)
    # observability (cfg.obs): span table, ring-buffer drop accounting,
    # and lossless step aggregates that survive any sample dropping
    spans: Optional[object] = None    # repro_torch.obs.tracing.SpanTable
    steps_dropped: int = 0            # step records evicted by the ring cap
    faults_dropped: int = 0           # fault events evicted by the ring cap
    step_totals: Optional[Dict[str, float]] = None  # n/busy_s/tokens_out

    @property
    def hardware_names(self) -> Tuple[str, ...]:
        return tuple(sorted(set(self.replica_hw.values())))

    @property
    def completed(self) -> List[RequestRecord]:
        return [r for r in self.records if r.completed]

    @property
    def shed(self) -> List[RequestRecord]:
        return [r for r in self.records if r.shed]

    @property
    def n_retries(self) -> int:
        return sum(r.retries for r in self.records)

    def accounting(self) -> Dict[str, int]:
        return {"admitted": len(self.records),
                "completed": len(self.completed),
                "shed": len(self.shed)}

    def check_conservation(self) -> None:
        """Every admitted request must end as exactly one of completed /
        shed — none lost, none double-counted.  Raises on violation;
        the fault_engine smoke run turns this into a CI gate."""
        acc = self.accounting()
        both = sum(1 for r in self.records if r.completed and r.shed)
        if both or acc["completed"] + acc["shed"] != acc["admitted"]:
            raise RuntimeError(
                f"request conservation violated: {acc}, "
                f"completed&shed overlap={both}")

    def slo_attainment(self, ttft_slo_s: float) -> float:
        """Fraction of admitted requests whose first token arrived in
        time.  Shed and never-completed requests are explicit misses —
        the same convention ``ttft_percentile`` uses, so the two metrics
        always agree about failed requests."""
        if not self.records:
            return 1.0
        ok = sum(1 for r in self.records
                 if not r.shed and r.first_token_s is not None
                 and r.ttft_s <= ttft_slo_s)
        return ok / len(self.records)

    @property
    def goodput_tok_s(self) -> float:
        toks = sum(r.oo for r in self.completed)
        # elapsed span, not absolute clock: an epochal replay starting
        # at t_start must not count the pre-epoch offset as serving time
        return toks / max(self.sim_end_s - self.t_start, 1e-9)

    def ttft_percentile(self, q: float, on_missing: str = "inf") -> float:
        """TTFT percentile over admitted requests.

        Shed / never-first-token requests contribute ``inf`` by default
        — consistent with ``slo_attainment`` counting them as misses.
        ``on_missing="drop"`` restores the completed-only view (useful
        for plotting finite tails), but the default never lets a run
        that shed half its traffic report a rosy p95."""
        if on_missing not in ("inf", "drop"):
            raise ValueError(f"on_missing {on_missing!r}: 'inf' or 'drop'")
        vals = self._ttft_values()
        if on_missing == "drop":
            vals = vals[np.isfinite(vals)]
        return percentile_with_inf(vals, q)

    # -- fleet-level meta-metrics -------------------------------------------
    def _ttft_values(self) -> np.ndarray:
        """Per-admitted-request TTFT with inf for shed / no-first-token —
        the miss convention shared by slo_attainment and percentiles."""
        return np.array([float("inf") if (r.shed or r.first_token_s is None)
                         else r.ttft_s for r in self.records], np.float64)

    def _tenant_arrays(self):
        """(tenant, oo, completed, shed, retries) columns feeding the
        shared rollup; the fleet result overrides this with its raw
        arrays instead of materializing records."""
        recs = self.records
        return (np.array([r.tenant for r in recs], object),
                np.array([r.oo for r in recs], np.int64),
                np.array([r.completed for r in recs], bool),
                np.array([r.shed for r in recs], bool),
                np.array([r.retries for r in recs], np.int64))

    def per_tenant(self, slo_map: Optional[Dict[str, float]] = None
                   ) -> Dict[str, Dict[str, float]]:
        """Per-tenant request accounting, TTFT tail and SLO attainment.

        ``slo_map`` maps tenant name -> TTFT SLO seconds (e.g.
        ``FleetTraceConfig.slo_map``); tenants absent from the map get
        ``attainment = nan``.  Shed requests count as misses and as inf
        TTFT, exactly like the fleet-wide metrics.  ``goodput_share`` is
        the tenant's fraction of completed output tokens.  One shared
        rollup (``repro_torch.obs.metrics.tenant_rollup``) serves both
        engines."""
        tenant, oo, completed, shed, retries = self._tenant_arrays()
        return tenant_rollup(tenant, self._ttft_values(), oo, completed,
                             shed, retries, slo_map)

    def meta_metrics(self, slo_map: Optional[Dict[str, float]] = None
                     ) -> Dict[str, object]:
        """Fleet-level scorecard (after "Meta-Metrics and Best Practices
        for System-Level Inference Performance Benchmarking"): request
        accounting, goodput, availability, shed/retry rates, per-tenant
        breakdown, Jain fairness across per-tenant attainment, and the
        fleet attainment where each request is scored against its own
        tenant's SLO tier."""
        pt = self.per_tenant(slo_map)
        acc = self.accounting()
        n = max(acc["admitted"], 1)
        att = [v["attainment"] for v in pt.values()
               if np.isfinite(v["attainment"])]
        if att and sum(a * a for a in att) > 0:
            jain = (sum(att) ** 2) / (len(att) * sum(a * a for a in att))
        else:
            jain = 1.0
        if slo_map:
            fleet_att = sum(v["attainment"] * v["n_requests"]
                            for v in pt.values()
                            if np.isfinite(v["attainment"])) / n
        else:
            fleet_att = float("nan")
        return {
            "n_requests": acc["admitted"],
            "n_completed": acc["completed"],
            "n_shed": acc["shed"],
            "shed_rate": acc["shed"] / n,
            "retry_rate": self.n_retries / n,
            "goodput_tok_s": self.goodput_tok_s,
            "availability": self.availability,
            "replica_seconds": self.replica_seconds,
            "fleet_attainment": fleet_att,
            "jain_fairness": float(jain),
            "per_tenant": pt,
        }


class FleetSimulator:
    def __init__(self, trace: Trace, cfg: SimConfig, policy=None):
        self.trace = trace
        self.cfg = cfg
        self.policy = policy
        # admission bound: a request that cannot fit the *largest* slot's
        # KV can never be served anywhere; per-replica fit is re-checked
        # at dispatch (heterogeneous fleets have smaller replicas too)
        self.kv_cap = max(cfg.kv_cap_for(s) for s in cfg.slot_setups())

    def _new_replica(self, rid: int, active: bool = True,
                     hardware: Optional[str] = None) -> Replica:
        setup = self.cfg.setup_for(rid, hardware)
        r = Replica(rid, setup, self.cfg.batch_cap,
                    self.cfg.max_prefill_requests,
                    self.cfg.kv_cap_for(setup))
        r.active = active
        return r

    def run(self) -> SimResult:
        cfg = self.cfg
        replicas = [self._new_replica(i)
                    for i in range(max(cfg.n_replicas, 1))]
        records: Dict[int, RequestRecord] = {}
        obs_cfg = cfg.obs if (cfg.obs is not None
                              and getattr(cfg.obs, "enabled", True)) \
            else None
        step_cap = getattr(obs_cfg, "max_steps", None)
        fault_cap = getattr(obs_cfg, "max_fault_events", None)
        steps: List[StepRecord] = RingLog(step_cap) if step_cap else []
        controls: List[Tuple[float, Action]] = []
        fault_log: List[FaultEvent] = RingLog(fault_cap) if fault_cap \
            else []
        # lossless step aggregates (survive ring-cap drops)
        tot_steps, tot_busy, tot_tokens = 0, 0.0, 0
        heap: List[Tuple[float, int, int, object]] = []
        tick = 0

        steps_in_flight = 0

        def push(t: float, kind: int, payload=None):
            nonlocal tick, steps_in_flight
            heapq.heappush(heap, (t, kind, tick, payload))
            tick += 1
            if kind == _STEP_DONE:
                steps_in_flight += 1

        for req in self.trace.requests:
            push(req.arrival_s, _ARRIVAL, req)
        n_pending = len(self.trace.requests)
        if self.policy is not None and cfg.control_interval_s > 0:
            push(cfg.t_start + cfg.control_interval_s, _CONTROL, None)

        inj = cfg.faults
        warmup_s = float(inj.cfg.restart_warmup_s) if inj is not None \
            else 0.0
        if inj is not None:
            # crash windows enter the same heap as everything else; a
            # window straddling t_start starts the replica down.  Ids
            # beyond the live fleet are ignored at pop time (the plan
            # covers max_replicas, the fleet may be smaller).
            for w in inj.crash_windows():
                if w.replica >= cfg.max_replicas or w.t_up <= cfg.t_start:
                    continue
                push(max(w.t_down, cfg.t_start), _CRASH, w.replica)
                push(w.t_up, _RESTORE, w.replica)

        # per-window accumulators for Observation
        win = dict(arrivals=0, ii=0, oo=0, tokens=0, busy=0.0,
                   last=cfg.t_start)
        n_events = 0
        now, replica_seconds, last_t = cfg.t_start, 0.0, cfg.t_start
        failed_seconds = 0.0
        deadline = self.trace.horizon_s + cfg.drain_s

        def maybe_start(r: Replica):
            if r.busy:
                return
            got = r.begin_step()
            if got is not None:
                dur, kind = got
                if inj is not None:
                    dur *= inj.slow_factor(r.rid, now)
                r.busy = True
                push(now + dur, _STEP_DONE, (r, kind, dur, r.incarnation))

        def shed(rec: RequestRecord, t: float, reason: str):
            nonlocal n_pending
            rec.shed = True
            rec.shed_s = t
            rec.shed_reason = reason
            n_pending -= 1

        def dispatch(rec: RequestRecord):
            # crashed replicas take no new work; fall back progressively.
            # Heterogeneous fleets: a candidate must have enough KV for
            # the whole sequence — if no live replica fits it (e.g. the
            # only large-memory replica crashed), shed as oversized.
            need = float(rec.ii + rec.oo)
            cands = None
            for pool in (
                    [r for r in replicas
                     if r.active and not r.draining and not r.failed],
                    [r for r in replicas if r.active and not r.failed],
                    [r for r in replicas if not r.failed],
                    replicas):
                fit = [r for r in pool if need <= r.kv_capacity]
                if fit:
                    cands = fit
                    break
            if cands is None:
                shed(rec, now, "oversized")
                return
            tgt = min(cands, key=lambda r: (r.load, r.rid))
            rec.replica = tgt.rid
            tgt.waiting.append(_Seq(rec))
            maybe_start(tgt)

        def route(req: TraceRequest):
            rec = RequestRecord(rid=req.rid, ii=req.ii, oo=req.oo,
                                arrival_s=req.arrival_s, tenant=req.tenant)
            records[req.rid] = rec
            if req.ii + req.oo > self.kv_cap:
                # can never fit any replica's KV: shed at admission
                # (SLO miss) instead of head-of-line blocking
                shed(rec, now, "oversized")
                return
            dispatch(rec)

        def requeue_or_shed(s: _Seq, t: float):
            """A crash displaced this sequence: retry on a healthy
            replica within budget + deadline, else shed."""
            rec = s.rec
            if rec.retries > cfg.max_retries:
                shed(rec, t, "retry_budget")
                return
            if cfg.shed_after_s is not None \
                    and t - rec.arrival_s > cfg.shed_after_s:
                shed(rec, t, "deadline")
                return
            # KV (and any generated tokens) died with the replica: the
            # retry restarts generation, so TTFT restarts too (no
            # streaming resume across replicas)
            rec.first_token_s = None
            dispatch(rec)

        def apply_action(act: Action):
            act = Action(n_replicas=int(np.clip(act.n_replicas, 1,
                                                cfg.max_replicas)),
                         batch_cap=max(int(act.batch_cap), 1),
                         hardware=act.hardware)
            n_active = sum(1 for r in replicas
                           if r.active and not r.draining)
            if act.n_replicas > n_active:
                need = act.n_replicas - n_active
                # un-drain warm replicas first, then re-provision
                # decommissioned ones, then create fresh
                for r in replicas:
                    if need and r.active and r.draining:
                        r.draining = False
                        need -= 1
                for r in replicas:
                    if need and not r.active and not r.provisioning \
                            and not r.failed:
                        r.draining = False
                        r.provisioning = True
                        push(now + cfg.provision_delay_s, _PROVISION, r)
                        need -= 1
                for _ in range(need):
                    nr = self._new_replica(len(replicas), active=False,
                                           hardware=act.hardware)
                    nr.provisioning = True
                    replicas.append(nr)
                    push(now + cfg.provision_delay_s, _PROVISION, nr)
            elif act.n_replicas < n_active:
                # drain the highest-index active replicas
                for r in sorted(replicas, key=lambda r: -r.rid):
                    if n_active <= act.n_replicas:
                        break
                    if r.active and not r.draining:
                        r.draining = True
                        if not r.busy and r.load == 0:
                            r.active = False      # nothing to drain
                        n_active -= 1
            for r in replicas:    # after scale-up, so new replicas get it
                r.batch_cap = act.batch_cap
            return act

        while heap:
            t, kind, _, payload = heapq.heappop(heap)
            if t > deadline:
                break
            n_active = sum(1 for r in replicas if r.active)
            n_failed = sum(1 for r in replicas if r.failed)
            replica_seconds += n_active * (t - last_t)
            failed_seconds += n_failed * (t - last_t)
            last_t = now = t
            n_events += 1
            if kind == _ARRIVAL:
                req = payload
                win["arrivals"] += 1
                win["ii"] += req.ii
                win["oo"] += req.oo
                route(req)
            elif kind == _STEP_DONE:
                steps_in_flight -= 1
                r, skind, dur, inc = payload
                if inc != r.incarnation:
                    continue          # step of a crashed incarnation
                r.busy = False
                n_pre = len(r.prefilling)
                finished = r.finish_step(skind, t)
                n_pending -= len(finished)
                # every participant of the step emitted exactly one token
                toks = (len(r.running) + len(finished)
                        if skind == "decode" else n_pre)
                steps.append(StepRecord(t_end=t, replica=r.rid, kind=skind,
                                        bb=toks, duration_s=dur,
                                        tokens_out=toks))
                tot_steps += 1
                tot_busy += dur
                tot_tokens += toks
                win["tokens"] += toks
                win["busy"] += dur
                maybe_start(r)
                if r.draining and not r.busy and r.load == 0:
                    r.active = False              # drained dry: decommission
            elif kind == _CRASH:
                if payload >= len(replicas):
                    continue          # plan covers more replicas than live
                r = replicas[payload]
                if r.failed:
                    continue          # overlapping windows: already down
                inflight, queued = r.fail()
                fault_log.append(FaultEvent(t=t, kind="crash",
                                            replica=r.rid,
                                            n_displaced=len(inflight)
                                            + len(queued)))
                for s in inflight:
                    s.rec.retries += 1            # computed KV was lost
                    requeue_or_shed(s, t)
                for s in queued:
                    requeue_or_shed(s, t)         # rerouted, not a retry
            elif kind == _RESTORE:
                if payload >= len(replicas):
                    continue
                r = replicas[payload]
                if not r.failed:
                    continue
                r.failed = False
                fault_log.append(FaultEvent(t=t, kind="restore",
                                            replica=r.rid))
                if r.restore_to_active:
                    # restart pays a warm-up through the provisioning path
                    if warmup_s > 0:
                        r.provisioning = True
                        push(t + warmup_s, _PROVISION, r)
                    else:
                        r.active = True
                        maybe_start(r)
            elif kind == _PROVISION:
                if payload.failed:
                    # crashed while provisioning/warming: stay down — the
                    # restore (or the autoscaler) re-arms it later
                    payload.provisioning = False
                    continue
                payload.provisioning = False
                if not payload.draining:   # drained meanwhile: stay down
                    payload.active = True
                    maybe_start(payload)
            elif kind == _CONTROL:
                w = max(t - win["last"], 1e-9)
                n_arr = win["arrivals"]
                obs = Observation(
                    now=t, window_s=w, n_arrivals=n_arr,
                    mean_ii=win["ii"] / n_arr if n_arr else 0.0,
                    mean_oo=win["oo"] / n_arr if n_arr else 0.0,
                    arrival_rate=n_arr / w,
                    queue_len=sum(len(r.waiting) for r in replicas),
                    n_running=sum(len(r.running) + len(r.prefilling)
                                  for r in replicas),
                    n_active_replicas=sum(1 for r in replicas
                                          if r.active and not r.draining),
                    batch_cap=replicas[0].batch_cap,
                    decode_tokens=win["tokens"], busy_s=win["busy"],
                    measured_tok_s=(win["tokens"] / win["busy"]
                                    if win["busy"] > 0 else 0.0),
                    n_failed_replicas=sum(1 for r in replicas if r.failed))
                act = apply_action(self.policy.control(obs))
                controls.append((t, act))
                win = dict(arrivals=0, ii=0, oo=0, tokens=0, busy=0.0,
                           last=t)
                if t + cfg.control_interval_s < self.trace.horizon_s:
                    push(t + cfg.control_interval_s, _CONTROL, None)
            if n_pending <= 0 and steps_in_flight == 0:
                break

        ordered = [records[r.rid] for r in self.trace.requests]
        # whatever is still in flight when the horizon + drain expires
        # was never served: shed it explicitly so admitted == completed
        # + shed holds unconditionally (request conservation)
        for rec in ordered:
            if not rec.completed and not rec.shed:
                shed(rec, now, "unserved")
        denom = replica_seconds + failed_seconds
        res = SimResult(records=ordered, steps=steps, sim_end_s=now,
                        n_events=n_events, replica_seconds=replica_seconds,
                        controls=controls, t_start=cfg.t_start,
                        availability=(replica_seconds / denom
                                      if denom > 0 else 1.0),
                        fault_log=fault_log,
                        replica_hw={r.rid: r.setup.hw.name
                                    for r in replicas})
        res.steps_dropped = getattr(steps, "n_dropped", 0)
        res.faults_dropped = getattr(fault_log, "n_dropped", 0)
        res.step_totals = {"n": tot_steps, "busy_s": tot_busy,
                           "tokens_out": tot_tokens}
        if obs_cfg is not None:
            from repro_torch.obs.tracing import record_spans
            res.spans = record_spans(res, obs_cfg)
        return res


def simulate(trace: Trace, cfg: SimConfig, policy=None,
             engine: str = "heap") -> SimResult:
    """Run a trace through one of the two engines.

    ``engine="heap"`` is the event-heap reference above; ``"fleet"`` is
    the vectorized time-bucketed engine (``repro_torch.serving.fleet``) — same
    semantics, admissions quantized to ``cfg.bucket_s`` boundaries, and
    orders of magnitude faster on large traces."""
    if engine == "heap":
        return FleetSimulator(trace, cfg, policy).run()
    if engine == "fleet":
        from repro_torch.serving.fleet import VectorFleetSimulator
        return VectorFleetSimulator(trace, cfg, policy).run()
    raise KeyError(f"unknown engine {engine!r}; known: heap, fleet")
