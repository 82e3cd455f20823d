"""Vectorized time-bucketed fleet serving engine.

The event-heap reference (``repro_torch.serving.simulator``) pays Python-level
heap traffic for every arrival and every step of every replica, capping
it at a few thousand simulated events per second.  This engine keeps the
*semantics* of that reference — prefill-prioritized continuous batching,
``ii + oo`` KV reservation at admission, crash/straggler fault
injection, drain/provision autoscaling — but advances per-replica state
as batched array operations:

  * **bucketed admissions** — arrivals are quantized to ``cfg.bucket_s``
    boundaries and routed in batches.  This is the engine's *only*
    semantic divergence from the heap reference, and it bounds the
    per-request parity error: a request is admitted at most one bucket
    later than the reference, so TTFT/E2E agree within roughly
    ``bucket_s`` plus one step time.
  * **vectorized decode runs** — between buckets, a replica's decode
    progress is computed in closed form: sort the running batch by
    remaining tokens, derive the whole batch-size / context-sum
    trajectory with ``searchsorted`` + suffix sums, evaluate every step
    duration in one call to the ``decode_time_fn`` cost closure (which
    matches ``decode_step_time_group`` to ~1 ulp), and ``cumsum`` the
    durations into completion times.  Hundreds of steps apply per numpy
    call instead of one per heap event.
  * **one-step in-flight buffer** — a step straddling a bucket boundary
    becomes the replica's single *pending* step (its duration fixed at
    start time, like the heap engine's in-flight event) and is applied
    or — on a crash — discarded later, mirroring the reference's
    incarnation-counter semantics.
  * **exact fault/control timing** — crash, restore, provision and
    control-tick events keep their exact times in a small event heap
    (a few thousand entries instead of one per request/step); straggler
    windows segment decode runs so each step still sees the slow factor
    in force at its start.

Results come back as a ``FleetSimResult``: an array-backed
``SimResult`` subclass whose records/steps materialize lazily and whose
metrics (attainment, percentiles, per-tenant meta-metrics) are
vectorized.

A copy of the reference package's ``serving/fleet.py``: a seeded trace
gives the reference's arrays bit for bit on the numpy backend.  Where
the reference offers a jitted ``jax.numpy`` trajectory (float32, padded
to powers of two to reuse compiles), ``cfg.traj_backend="torch"``
evaluates ``decode_time_fn(setup, xp=torch)`` in float64 on
``cfg.device`` (the GPU unless the caller asks for the CPU), unpadded:
eager torch compiles nothing.  On dense configs its durations are
numpy's bit for bit; on MoE configs the expert-hit term's ``pow`` may
move them by a few ulps.  Each call copies a run's (bb, ctx_sum) to the
device and its durations back.  With ``cfg.obs`` set the step log is
capped (``_maybe_compact``) and the span table derived, as the
reference's are, on either backend.
"""
from __future__ import annotations

import collections
import heapq
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.obs.metrics import RingLog
from repro_torch.perfmodel.simulator import decode_time_fn, prefill_time_fn
from repro_torch.serving.faults import FaultEvent
from repro_torch.serving.simulator import (Action, Observation,
                                           RequestRecord, SimConfig,
                                           SimResult, StepRecord)
from repro_torch.serving.traces import Trace

# event kinds, matching the heap engine's same-time ordering
# (arrival < control < provision < crash < restore); _FLUSH drains
# trailing in-flight work at the deadline
_BUCKET, _CONTROL, _PROVISION, _CRASH, _RESTORE, _FLUSH = 0, 2, 3, 4, 5, 6

_SHED_NAMES = ("", "oversized", "retry_budget", "deadline", "unserved")
_SHED_CODE = {n: i for i, n in enumerate(_SHED_NAMES)}


class _TorchTraj:
    """Decode-trajectory durations from the ``decode_time_fn`` closure
    over float64 tensors on ``device``: one copy of the run's (bb,
    ctx_sum) there, a handful of elementwise kernels, one copy back."""

    def __init__(self, setup, device):
        self.device = resolve_device(device)
        self._f = decode_time_fn(setup, xp=torch)

    def __call__(self, bb: np.ndarray, ctx_sum: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.stack([np.asarray(bb, np.float64),
                                       np.asarray(ctx_sum, np.float64)]))
        x = x.to(self.device)
        return self._f(x[0], x[1]).cpu().numpy()


class _VecReplica:
    """Array/queue state of one replica inside the vectorized engine."""
    __slots__ = ("rid", "batch_cap", "max_prefill", "kv_capacity", "clock",
                 "waiting", "run_rem", "run_ctx", "run_gdx", "kv_reserved",
                 "pend_end", "pend_kind", "pend_admit", "pend_dur",
                 "pend_bb", "draining", "active", "provisioning", "failed",
                 "restore_to_active", "load", "k_hint",
                 "prefill_f", "traj", "hw_name")

    def __init__(self, rid: int, batch_cap: int, max_prefill: int,
                 kv_capacity: float, clock: float, active: bool = True,
                 prefill_f=None, traj=None, hw_name: str = ""):
        self.rid = rid
        self.batch_cap = batch_cap
        self.max_prefill = max_prefill
        self.kv_capacity = kv_capacity
        # per-replica cost closures: heterogeneous fleets give each
        # replica its own hardware's roofline
        self.prefill_f = prefill_f
        self.traj = traj
        self.hw_name = hw_name
        self.clock = clock                # applied-state time
        self.waiting: Deque[int] = collections.deque()   # global req idx
        self.run_rem = np.zeros(0, np.int64)   # tokens left per seq
        self.run_ctx = np.zeros(0, np.int64)   # current context per seq
        self.run_gdx = np.zeros(0, np.int64)   # global req idx per seq
        self.kv_reserved = 0.0
        self.k_hint = 64                  # decode-run length estimate
        self.pend_end: Optional[float] = None   # in-flight step end time
        self.pend_kind = ""
        self.pend_admit: Tuple[int, ...] = ()   # prefill participants
        self.pend_dur = 0.0
        self.pend_bb = 0
        self.draining = False
        self.active = active
        self.provisioning = False
        self.failed = False
        self.restore_to_active = True
        self.load = 0                     # waiting + running + prefilling

    @property
    def busy(self) -> bool:
        return self.pend_end is not None


class _LazySeq(Sequence):
    """List-like view materializing elements on demand (and caching)."""

    def __init__(self, n: int, make):
        self._n = n
        self._make = make
        self._cache: Dict[int, object] = {}

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(self._n))]
        if i < 0:
            i += self._n
        if not 0 <= i < self._n:
            raise IndexError(i)
        r = self._cache.get(i)
        if r is None:
            r = self._make(i)
            self._cache[i] = r
        return r


class FleetSimResult(SimResult):
    """Array-backed ``SimResult``.

    ``req`` / ``step_arrays`` hold the raw per-request / per-step columns
    (the adapter's vectorized fast path reads them directly);
    ``records`` / ``steps`` materialize ``RequestRecord`` /
    ``StepRecord`` objects lazily for code written against the heap
    engine's interface.  All headline metrics are overridden with
    vectorized equivalents."""

    def __init__(self, req: Dict[str, np.ndarray],
                 step_arrays: Dict[str, np.ndarray], **kw):
        self.req = req
        self.step_arrays = step_arrays
        super().__init__(records=_LazySeq(len(req["rid"]),
                                          self._make_record),
                         steps=_LazySeq(len(step_arrays["t_end"]),
                                        self._make_step), **kw)

    def _make_record(self, i: int) -> RequestRecord:
        q = self.req

        def opt(a):
            return float(a[i]) if np.isfinite(a[i]) else None

        return RequestRecord(
            rid=int(q["rid"][i]), ii=int(q["ii"][i]), oo=int(q["oo"][i]),
            arrival_s=float(q["arrival_s"][i]), tenant=str(q["tenant"][i]),
            replica=int(q["replica"][i]),
            first_token_s=opt(q["first_token_s"]), done_s=opt(q["done_s"]),
            retries=int(q["retries"][i]), shed=bool(q["shed"][i]),
            shed_s=opt(q["shed_s"]),
            shed_reason=_SHED_NAMES[int(q["shed_reason"][i])])

    def _make_step(self, i: int) -> StepRecord:
        a = self.step_arrays
        return StepRecord(t_end=float(a["t_end"][i]),
                          replica=int(a["replica"][i]),
                          kind="prefill" if a["kind"][i] == 0 else "decode",
                          bb=int(a["bb"][i]),
                          duration_s=float(a["duration_s"][i]),
                          tokens_out=int(a["tokens_out"][i]))

    # -- vectorized metric overrides ----------------------------------------
    @property
    def completed(self) -> List[RequestRecord]:
        return [self.records[i] for i in
                np.flatnonzero(np.isfinite(self.req["done_s"]))]

    @property
    def shed(self) -> List[RequestRecord]:
        return [self.records[i] for i in np.flatnonzero(self.req["shed"])]

    @property
    def n_retries(self) -> int:
        return int(self.req["retries"].sum())

    def accounting(self) -> Dict[str, int]:
        comp = np.isfinite(self.req["done_s"])
        return {"admitted": int(len(self.req["rid"])),
                "completed": int(comp.sum()),
                "shed": int(self.req["shed"].sum())}

    def check_conservation(self) -> None:
        comp = np.isfinite(self.req["done_s"])
        both = int((comp & self.req["shed"]).sum())
        acc = self.accounting()
        if both or acc["completed"] + acc["shed"] != acc["admitted"]:
            raise RuntimeError(
                f"request conservation violated: {acc}, "
                f"completed&shed overlap={both}")

    def _ttft_values(self) -> np.ndarray:
        q = self.req
        ttft = q["first_token_s"] - q["arrival_s"]
        miss = q["shed"] | ~np.isfinite(q["first_token_s"])
        return np.where(miss, np.inf, ttft)

    def slo_attainment(self, ttft_slo_s: float) -> float:
        if not len(self.req["rid"]):
            return 1.0
        return float(np.mean(self._ttft_values() <= ttft_slo_s))

    @property
    def goodput_tok_s(self) -> float:
        comp = np.isfinite(self.req["done_s"])
        toks = int(self.req["oo"][comp].sum())
        return toks / max(self.sim_end_s - self.t_start, 1e-9)

    def _tenant_arrays(self):
        # raw columns straight into the shared tenant_rollup — the
        # rollup itself lives in repro_torch.obs.metrics, one copy for both
        # engines
        q = self.req
        return (q["tenant"], q["oo"], np.isfinite(q["done_s"]),
                np.asarray(q["shed"], bool), q["retries"])


class VectorFleetSimulator:
    """Drop-in engine for ``simulate(..., engine="fleet")``."""

    def __init__(self, trace: Trace, cfg: SimConfig, policy=None):
        if cfg.bucket_s <= 0:
            raise ValueError("cfg.bucket_s must be positive")
        self.trace = trace
        self.cfg = cfg
        self.policy = policy
        if cfg.traj_backend not in ("numpy", "torch"):
            raise KeyError(f"unknown traj_backend {cfg.traj_backend!r}; "
                           f"known: numpy, torch")
        # per-setup cost-closure cache (ServingSetup is frozen/hashable):
        # heterogeneous fleets mix hardware, each distinct setup compiles
        # its closures once and every replica on it shares them
        self._closure_cache: Dict[object, Tuple[float, object, object]] = {}
        # admission bound mirrors the heap engine: shed only what the
        # *largest* slot cannot hold; per-replica fit re-checked at route
        self.kv_cap = max(self._closures(s)[0] for s in cfg.slot_setups())
        # decode-trajectory calls and the steps they evaluate, either
        # backend
        self.traj_calls = 0
        self.traj_steps = 0
        inj = cfg.faults
        self._sb: Dict[int, np.ndarray] = {}
        self._sf: Dict[int, np.ndarray] = {}
        if inj is not None:
            ids = {w.replica for w in inj.plan.stragglers}
            for rid in ids:
                self._sb[rid] = inj.straggler_boundaries(rid)
                self._sf[rid] = np.array(
                    [w.slow for w in sorted(
                        (w for w in inj.plan.stragglers
                         if w.replica == rid), key=lambda w: w.t0)],
                    np.float64)

    # -- fault helpers ------------------------------------------------------
    def _slow(self, rid: int, t: float) -> float:
        b = self._sb.get(rid)
        if b is None or not len(b):
            return 1.0
        i = int(np.searchsorted(b, t, side="right"))
        if i % 2 == 1:                    # inside window (i-1)//2
            return float(self._sf[rid][(i - 1) // 2])
        return 1.0

    def _next_boundary(self, rid: int, t: float) -> float:
        b = self._sb.get(rid)
        if b is None or not len(b):
            return float("inf")
        i = int(np.searchsorted(b, t, side="right"))
        return float(b[i]) if i < len(b) else float("inf")

    # -- engine -------------------------------------------------------------
    def run(self) -> FleetSimResult:
        cfg, trace = self.cfg, self.trace
        N = len(trace.requests)
        arr = trace.to_arrays() if N else {
            "arrival_s": np.zeros(0), "ii": np.zeros(0, np.int64),
            "oo": np.zeros(0, np.int64),
            "tenant": np.zeros(0, dtype=object)}
        self.arrival_a = np.asarray(arr["arrival_s"], np.float64)
        self.ii_a = np.asarray(arr["ii"], np.int64)
        self.oo_a = np.asarray(arr["oo"], np.int64)
        self.tenant_a = np.asarray(arr["tenant"], dtype=object)
        self.rid_a = np.array([r.rid for r in trace.requests], np.int64)
        self.kvneed_a = (self.ii_a + self.oo_a).astype(np.float64)
        self.first_a = np.full(N, np.nan)
        self.done_a = np.full(N, np.nan)
        self.shed_a = np.zeros(N, bool)
        self.sheds_a = np.full(N, np.nan)
        self.shedr_a = np.zeros(N, np.uint8)
        self.retries_a = np.zeros(N, np.int32)
        self.replica_a = np.full(N, -1, np.int32)
        # step buffers: scalar lists (prefill / pending applies) + decode
        # run chunks
        self.ps_t: List[float] = []
        self.ps_dur: List[float] = []
        self.ps_bb: List[int] = []
        self.ps_kind: List[int] = []
        self.ps_rep: List[int] = []
        self.ch_t: List[np.ndarray] = []
        self.ch_dur: List[np.ndarray] = []
        self.ch_bb: List[np.ndarray] = []
        self.ch_rep: List[Tuple[int, int]] = []
        # observability: optional step ring cap (periodic compaction
        # bounds peak memory at ~2x cap) + lossless step aggregates
        obs_cfg = cfg.obs if (cfg.obs is not None
                              and getattr(cfg.obs, "enabled", True)) \
            else None
        self._step_cap = getattr(obs_cfg, "max_steps", None)
        self._comp_steps: Optional[Dict[str, np.ndarray]] = None
        self._retained = 0
        self._steps_dropped = 0
        self._tot_steps = 0
        self._tot_busy = 0.0
        self._tot_tokens = 0
        self.win = dict(arrivals=0, ii=0, oo=0, tokens=0, busy=0.0,
                        last=cfg.t_start)
        self.n_events = 0
        self.n_resolved = 0
        self.last_event_t = cfg.t_start
        # piecewise-constant active/failed-count timeline for the
        # replica-seconds and availability integrals (exact change times)
        self.state_changes: List[Tuple[float, int, int]] = []
        fault_cap = getattr(obs_cfg, "max_fault_events", None)
        fault_log: List[FaultEvent] = RingLog(fault_cap) if fault_cap \
            else []
        controls: List[Tuple[float, Action]] = []

        replicas = [self._new_replica(i, cfg.t_start)
                    for i in range(max(cfg.n_replicas, 1))]
        self._n_active0 = len(replicas)

        heap: List[Tuple[float, int, int, object]] = []
        tick = 0

        def push(t: float, kind: int, payload=None):
            nonlocal tick
            heapq.heappush(heap, (t, kind, tick, payload))
            tick += 1

        # arrivals, quantized to bucket boundaries
        if N:
            bidx = np.ceil((self.arrival_a - cfg.t_start)
                           / cfg.bucket_s).astype(np.int64)
            bidx = np.maximum(bidx, 0)
            bt = cfg.t_start + bidx * cfg.bucket_s
            cut = np.flatnonzero(np.diff(bt) != 0) + 1
            starts = np.concatenate([[0], cut])
            ends = np.concatenate([cut, [N]])
            for lo, hi in zip(starts, ends):
                push(float(bt[lo]), _BUCKET, (int(lo), int(hi)))
        if self.policy is not None and cfg.control_interval_s > 0:
            push(cfg.t_start + cfg.control_interval_s, _CONTROL, None)
        inj = cfg.faults
        warmup_s = float(inj.cfg.restart_warmup_s) if inj is not None \
            else 0.0
        if inj is not None:
            for w in inj.crash_windows():
                if w.replica >= cfg.max_replicas or w.t_up <= cfg.t_start:
                    continue
                push(max(w.t_down, cfg.t_start), _CRASH, w.replica)
                push(w.t_up, _RESTORE, w.replica)
        deadline = trace.horizon_s + cfg.drain_s
        push(deadline, _FLUSH, None)

        while heap:
            t, kind, _, payload = heapq.heappop(heap)
            if t > deadline:
                break
            for r in replicas:
                self._advance(r, t)
            if kind == _BUCKET:
                lo, hi = payload
                self._route_bucket(replicas, t, lo, hi)
            elif kind == _CONTROL:
                self._control(replicas, t, controls, push)
            elif kind == _PROVISION:
                r = payload
                if r.failed:
                    r.provisioning = False
                else:
                    r.provisioning = False
                    if not r.draining:
                        self._set_state(r, t, active=True)
                self.n_events += 1
                self.last_event_t = max(self.last_event_t, t)
            elif kind == _CRASH:
                if payload < len(replicas) \
                        and not replicas[payload].failed:
                    self._crash(replicas, replicas[payload], t, fault_log)
                    self.n_events += 1
                    self.last_event_t = max(self.last_event_t, t)
            elif kind == _RESTORE:
                if payload < len(replicas) and replicas[payload].failed:
                    r = replicas[payload]
                    self._set_state(r, t, failed=False)
                    fault_log.append(FaultEvent(t=t, kind="restore",
                                                replica=r.rid))
                    if r.restore_to_active:
                        if warmup_s > 0:
                            r.provisioning = True
                            push(t + warmup_s, _PROVISION, r)
                        else:
                            self._set_state(r, t, active=True)
                    self.n_events += 1
                    self.last_event_t = max(self.last_event_t, t)
            # _FLUSH: the advance above already drained applied work
            if self.n_resolved >= N \
                    and not any(r.pend_end is not None for r in replicas):
                break

        # unresolved requests were never served within horizon + drain
        now = self.last_event_t
        open_m = ~(np.isfinite(self.done_a) | self.shed_a)
        if open_m.any():
            self.shed_a[open_m] = True
            self.sheds_a[open_m] = now
            self.shedr_a[open_m] = _SHED_CODE["unserved"]
            self.n_resolved += int(open_m.sum())

        active_s, failed_s = self._integrate_states(cfg.t_start, now)
        denom = active_s + failed_s
        step_arrays = self._collect_steps()
        req = {"rid": self.rid_a, "ii": self.ii_a, "oo": self.oo_a,
               "arrival_s": self.arrival_a, "tenant": self.tenant_a,
               "replica": self.replica_a, "first_token_s": self.first_a,
               "done_s": self.done_a, "retries": self.retries_a,
               "shed": self.shed_a, "shed_s": self.sheds_a,
               "shed_reason": self.shedr_a}
        res = FleetSimResult(
            req=req, step_arrays=step_arrays, sim_end_s=now,
            n_events=self.n_events, replica_seconds=active_s,
            controls=controls, t_start=cfg.t_start,
            availability=(active_s / denom if denom > 0 else 1.0),
            fault_log=fault_log,
            replica_hw={r.rid: r.hw_name for r in replicas})
        res.steps_dropped = self._steps_dropped
        res.faults_dropped = getattr(fault_log, "n_dropped", 0)
        res.step_totals = {"n": self._tot_steps, "busy_s": self._tot_busy,
                           "tokens_out": self._tot_tokens}
        if obs_cfg is not None:
            from repro_torch.obs.tracing import record_spans
            res.spans = record_spans(res, obs_cfg)
        return res

    # -- replica lifecycle --------------------------------------------------
    def _closures(self, setup) -> Tuple[float, object, object]:
        """(kv_capacity, prefill_time_fn, decode trajectory fn) for a
        setup, cached so replicas sharing hardware share closures."""
        got = self._closure_cache.get(setup)
        if got is None:
            traj = (_TorchTraj(setup, self.cfg.device)
                    if self.cfg.traj_backend == "torch"
                    else decode_time_fn(setup))
            got = (self.cfg.kv_cap_for(setup), prefill_time_fn(setup), traj)
            self._closure_cache[setup] = got
        return got

    def _new_replica(self, rid: int, clock: float, active: bool = True,
                     hardware: Optional[str] = None) -> _VecReplica:
        setup = self.cfg.setup_for(rid, hardware)
        kv, pre, traj = self._closures(setup)
        return _VecReplica(rid, self.cfg.batch_cap,
                           self.cfg.max_prefill_requests, kv,
                           clock, active=active, prefill_f=pre, traj=traj,
                           hw_name=setup.hw.name)

    def _set_state(self, r: _VecReplica, t: float,
                   active: Optional[bool] = None,
                   failed: Optional[bool] = None) -> None:
        da = df = 0
        if active is not None and active != r.active:
            da = 1 if active else -1
            r.active = active
        if failed is not None and failed != r.failed:
            df = 1 if failed else -1
            r.failed = failed
        if da or df:
            self.state_changes.append((t, da, df))

    def _integrate_states(self, t0: float, t1: float
                          ) -> Tuple[float, float]:
        """∫ n_active dt and ∫ n_failed dt over [t0, t1] from the exact
        change timeline (matches the heap engine's per-pop integrals)."""
        events = sorted(self.state_changes)
        na, nf = self._n_active0, 0
        active_s = failed_s = 0.0
        last = t0
        for t, da, df in events:
            tc = min(max(t, t0), t1)
            active_s += na * (tc - last)
            failed_s += nf * (tc - last)
            last = tc
            na += da
            nf += df
        active_s += na * max(t1 - last, 0.0)
        failed_s += nf * max(t1 - last, 0.0)
        return active_s, failed_s

    # -- routing ------------------------------------------------------------
    def _cands(self, replicas: List[_VecReplica]) -> List[_VecReplica]:
        return ([r for r in replicas
                 if r.active and not r.draining and not r.failed]
                or [r for r in replicas if r.active and not r.failed]
                or [r for r in replicas if not r.failed]
                or replicas)

    def _dispatch(self, g: int, t: float,
                  replicas: List[_VecReplica]) -> None:
        # mirror the heap engine's requeue dispatch: progressively wider
        # pools, each filtered to replicas whose KV fits the sequence;
        # shed as oversized if no live replica can hold it
        need = self.kvneed_a[g]
        tgt = None
        for pool in (
                [r for r in replicas
                 if r.active and not r.draining and not r.failed],
                [r for r in replicas if r.active and not r.failed],
                [r for r in replicas if not r.failed],
                replicas):
            fit = [r for r in pool if need <= r.kv_capacity]
            if fit:
                tgt = min(fit, key=lambda r: (r.load, r.rid))
                break
        if tgt is None:
            self._shed(g, t, "oversized")
            return
        self.replica_a[g] = tgt.rid
        tgt.waiting.append(g)
        tgt.load += 1
        if tgt.pend_end is None:
            tgt.clock = max(tgt.clock, t)

    def _shed(self, g: int, t: float, reason: str) -> None:
        self.shed_a[g] = True
        self.sheds_a[g] = t
        self.shedr_a[g] = _SHED_CODE[reason]
        self.n_resolved += 1

    def _route_bucket(self, replicas: List[_VecReplica], t: float,
                      lo: int, hi: int) -> None:
        win = self.win
        win["arrivals"] += hi - lo
        win["ii"] += int(self.ii_a[lo:hi].sum())
        win["oo"] += int(self.oo_a[lo:hi].sum())
        self.n_events += hi - lo
        self.last_event_t = max(self.last_event_t, t)
        cands = self._cands(replicas)
        kv_cap = self.kv_cap
        kvn = self.kvneed_a
        # least-loaded greedy over (load, rid) via a small heap — the
        # same assignment the per-request min() would produce, without
        # scanning every candidate per request.  Heterogeneous fleets
        # take the fit-aware path: pop until a replica's KV fits,
        # matching the heap engine's per-request candidate filter.
        hetero = len({r.kv_capacity for r in cands}) > 1
        cand_max_kv = max(r.kv_capacity for r in cands)
        hp = [(r.load, r.rid, r) for r in cands]
        heapq.heapify(hp)
        for g in range(lo, hi):
            if kvn[g] > kv_cap:
                self._shed(g, t, "oversized")
                continue
            if kvn[g] > cand_max_kv:
                # fits the fleet's largest slot but no preferred
                # candidate: fall through to the wide-pool dispatch
                self._dispatch(g, t, replicas)
                continue
            if not hetero:
                load, rid, tgt = heapq.heappop(hp)
            else:
                skipped = []
                while True:
                    load, rid, tgt = heapq.heappop(hp)
                    if kvn[g] <= tgt.kv_capacity:
                        break
                    skipped.append((load, rid, tgt))
                for it in skipped:
                    heapq.heappush(hp, it)
            self.replica_a[g] = rid
            tgt.waiting.append(g)
            tgt.load = load + 1
            if tgt.pend_end is None and tgt.clock < t:
                tgt.clock = t
            heapq.heappush(hp, (load + 1, rid, tgt))

    def _requeue_or_shed(self, g: int, t: float,
                         replicas: List[_VecReplica]) -> None:
        cfg = self.cfg
        if self.retries_a[g] > cfg.max_retries:
            self._shed(g, t, "retry_budget")
            return
        if cfg.shed_after_s is not None \
                and t - self.arrival_a[g] > cfg.shed_after_s:
            self._shed(g, t, "deadline")
            return
        # KV and generated tokens died with the replica: generation (and
        # TTFT) restarts on the retry, matching the heap engine
        self.first_a[g] = np.nan
        self._dispatch(g, t, replicas)

    def _crash(self, replicas: List[_VecReplica], r: _VecReplica, t: float,
               fault_log: List[FaultEvent]) -> None:
        inflight = (list(r.pend_admit)
                    if r.pend_end is not None and r.pend_kind == "prefill"
                    else [])
        inflight += r.run_gdx.tolist()
        queued = list(r.waiting)
        r.restore_to_active = (r.active or r.provisioning) \
            and not r.draining
        r.pend_end = None                 # in-flight step of a dead
        r.pend_admit = ()                 # incarnation: discard
        r.run_rem = np.zeros(0, np.int64)
        r.run_ctx = np.zeros(0, np.int64)
        r.run_gdx = np.zeros(0, np.int64)
        r.waiting.clear()
        r.kv_reserved = 0.0
        r.load = 0
        r.provisioning = False
        r.draining = False
        self._set_state(r, t, active=False, failed=True)
        fault_log.append(FaultEvent(t=t, kind="crash", replica=r.rid,
                                    n_displaced=len(inflight)
                                    + len(queued)))
        for g in inflight:
            self.retries_a[g] += 1        # computed KV was lost
            self._requeue_or_shed(g, t, replicas)
        for g in queued:                  # rerouted, not a retry
            self._requeue_or_shed(g, t, replicas)

    # -- control ------------------------------------------------------------
    def _control(self, replicas: List[_VecReplica], t: float,
                 controls: List[Tuple[float, Action]], push) -> None:
        cfg, win = self.cfg, self.win
        w = max(t - win["last"], 1e-9)
        n_arr = win["arrivals"]
        obs = Observation(
            now=t, window_s=w, n_arrivals=n_arr,
            mean_ii=win["ii"] / n_arr if n_arr else 0.0,
            mean_oo=win["oo"] / n_arr if n_arr else 0.0,
            arrival_rate=n_arr / w,
            queue_len=sum(len(r.waiting) for r in replicas),
            n_running=sum(len(r.run_rem)
                          + (len(r.pend_admit)
                             if r.pend_end is not None
                             and r.pend_kind == "prefill" else 0)
                          for r in replicas),
            n_active_replicas=sum(1 for r in replicas
                                  if r.active and not r.draining),
            batch_cap=replicas[0].batch_cap,
            decode_tokens=win["tokens"], busy_s=win["busy"],
            measured_tok_s=(win["tokens"] / win["busy"]
                            if win["busy"] > 0 else 0.0),
            n_failed_replicas=sum(1 for r in replicas if r.failed))
        act = self._apply_action(replicas, t,
                                 self.policy.control(obs), push)
        controls.append((t, act))
        self.win = dict(arrivals=0, ii=0, oo=0, tokens=0, busy=0.0,
                        last=t)
        self.n_events += 1
        self.last_event_t = max(self.last_event_t, t)
        if t + cfg.control_interval_s < self.trace.horizon_s:
            push(t + cfg.control_interval_s, _CONTROL, None)

    def _apply_action(self, replicas: List[_VecReplica], now: float,
                      act: Action, push) -> Action:
        cfg = self.cfg
        act = Action(n_replicas=int(np.clip(act.n_replicas, 1,
                                            cfg.max_replicas)),
                     batch_cap=max(int(act.batch_cap), 1),
                     hardware=act.hardware)
        n_active = sum(1 for r in replicas if r.active and not r.draining)
        if act.n_replicas > n_active:
            need = act.n_replicas - n_active
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
                nr = self._new_replica(len(replicas), now, active=False,
                                       hardware=act.hardware)
                nr.provisioning = True
                replicas.append(nr)
                push(now + cfg.provision_delay_s, _PROVISION, nr)
        elif act.n_replicas < n_active:
            for r in sorted(replicas, key=lambda r: -r.rid):
                if n_active <= act.n_replicas:
                    break
                if r.active and not r.draining:
                    r.draining = True
                    if r.pend_end is None and r.load == 0:
                        self._set_state(r, now, active=False)
                    n_active -= 1
        for r in replicas:
            r.batch_cap = act.batch_cap
        return act

    # -- per-replica advancement --------------------------------------------
    def _try_admit(self, r: _VecReplica) -> List[int]:
        admit: List[int] = []
        kvn = self.kvneed_a
        while (r.waiting and len(admit) < r.max_prefill
               and len(r.run_rem) + len(admit) < r.batch_cap
               and r.kv_reserved + kvn[r.waiting[0]] <= r.kv_capacity):
            g = r.waiting.popleft()
            r.kv_reserved += kvn[g]
            admit.append(g)
        return admit

    def _advance(self, r: _VecReplica, t_limit: float) -> None:
        while True:
            if r.pend_end is not None:
                if r.pend_end > t_limit:
                    return
                self._apply_pending(r)
                continue
            if r.clock >= t_limit:
                return
            if r.waiting:
                admit = self._try_admit(r)
                if admit:
                    f = self._slow(r.rid, r.clock)
                    iis = self.ii_a[admit]
                    dur = float(r.prefill_f(
                        float(iis.sum()),
                        float((iis * iis).sum()))) * f
                    r.pend_kind = "prefill"
                    r.pend_admit = tuple(admit)
                    r.pend_dur = dur
                    r.pend_bb = len(admit)
                    r.pend_end = r.clock + dur
                    continue
            if r.run_rem.size:
                self._decode_advance(r, t_limit)
                continue
            return

    def _apply_pending(self, r: _VecReplica) -> None:
        t = r.pend_end
        if r.pend_kind == "prefill":
            started = []
            for g in r.pend_admit:
                self.first_a[g] = t
                if self.oo_a[g] <= 1:
                    self.done_a[g] = t
                    r.kv_reserved -= self.kvneed_a[g]
                    r.load -= 1
                    self.n_resolved += 1
                else:
                    started.append(g)
            if started:
                sg = np.asarray(started, np.int64)
                r.run_rem = np.concatenate([r.run_rem, self.oo_a[sg] - 1])
                r.run_ctx = np.concatenate([r.run_ctx, self.ii_a[sg] + 1])
                r.run_gdx = np.concatenate([r.run_gdx, sg])
            bbn = len(r.pend_admit)
            self.ps_kind.append(0)
        else:
            rem = r.run_rem
            done_m = rem <= 1
            nc = int(done_m.sum())
            if nc:
                dg = r.run_gdx[done_m]
                self.done_a[dg] = t
                r.kv_reserved -= float(self.kvneed_a[dg].sum())
                r.load -= nc
                self.n_resolved += nc
                keep = ~done_m
                r.run_rem = rem[keep] - 1
                r.run_ctx = r.run_ctx[keep] + 1
                r.run_gdx = r.run_gdx[keep]
            else:
                r.run_rem = rem - 1
                r.run_ctx = r.run_ctx + 1
            bbn = r.pend_bb
            self.ps_kind.append(1)
        self.ps_t.append(t)
        self.ps_dur.append(r.pend_dur)
        self.ps_bb.append(bbn)
        self.ps_rep.append(r.rid)
        self._retained += 1
        self._tot_steps += 1
        self._tot_busy += r.pend_dur
        self._tot_tokens += bbn
        self._maybe_compact()
        self.win["tokens"] += bbn
        self.win["busy"] += r.pend_dur
        self.n_events += 1
        r.clock = t
        self.last_event_t = max(self.last_event_t, t)
        r.pend_end = None
        r.pend_admit = ()
        if r.draining and r.load == 0:
            self._set_state(r, t, active=False)   # drained dry

    def _decode_advance(self, r: _VecReplica, t_limit: float) -> None:
        clock = r.clock
        seg_limit = min(t_limit, self._next_boundary(r.rid, clock))
        f = self._slow(r.rid, clock)
        rem0 = r.run_rem
        n = rem0.size
        order = np.argsort(rem0, kind="stable")
        rs = rem0[order]
        ctx_s = r.run_ctx[order].astype(np.float64)
        gdx = r.run_gdx
        kvn_s = self.kvneed_a[gdx[order]]
        sufctx = np.concatenate([np.cumsum(ctx_s[::-1])[::-1], [0.0]])
        prefkv = np.concatenate([[0.0], np.cumsum(kvn_s)])
        K_full = int(rs[-1])
        need0 = self.kvneed_a[r.waiting[0]] if r.waiting else None
        cap, kv_cap, kv_res = r.batch_cap, r.kv_capacity, r.kv_reserved
        K_try = min(K_full, max(r.k_hint, 16))
        while True:
            s = np.arange(K_try + 1)
            cnt = np.searchsorted(rs, s, side="right")   # rem <= s
            bb = n - cnt                  # alive before step s / after s
            bb_step = bb[:K_try]
            ctxsum = sufctx[cnt[:K_try]] + s[:K_try] * bb_step
            d = r.traj(bb_step, ctxsum) * f
            self.traj_calls += 1
            self.traj_steps += K_try
            cum = clock + np.cumsum(d)
            K_adm = None
            if need0 is not None:
                ok = ((bb[1:] < cap)
                      & (kv_res - prefkv[cnt[1:]] + need0 <= kv_cap))
                j = int(np.argmax(ok)) if ok.any() else -1
                if j >= 0:
                    K_adm = j + 1
            K_stop = K_full if K_adm is None else min(K_adm, K_full)
            S_time = int(np.searchsorted(cum, seg_limit, side="right"))
            if S_time >= K_try and K_try < K_stop:
                K_try = min(K_try * 4, K_full)
                continue
            break
        S_apply = min(S_time, K_stop)
        r.k_hint = max(2 * S_apply, 16)   # seed the next run's chunk size
        if S_apply > 0:
            ncomp = int(np.searchsorted(rs, S_apply, side="right"))
            if ncomp:
                dg = gdx[order[:ncomp]]
                self.done_a[dg] = cum[rs[:ncomp] - 1]
                r.kv_reserved -= float(prefkv[ncomp])
                r.load -= ncomp
                self.n_resolved += ncomp
                keep = rem0 > S_apply     # original batch order preserved
                r.run_rem = rem0[keep] - S_apply
                r.run_ctx = r.run_ctx[keep] + S_apply
                r.run_gdx = gdx[keep]
            else:
                r.run_rem = rem0 - S_apply
                r.run_ctx = r.run_ctx + S_apply
            self.ch_t.append(cum[:S_apply])
            self.ch_dur.append(d[:S_apply])
            self.ch_bb.append(bb_step[:S_apply])
            self.ch_rep.append((r.rid, S_apply))
            self._retained += S_apply
            self._tot_steps += S_apply
            self._tot_busy += float(d[:S_apply].sum())
            self._tot_tokens += int(bb_step[:S_apply].sum())
            self._maybe_compact()
            self.win["tokens"] += int(bb_step[:S_apply].sum())
            self.win["busy"] += float(d[:S_apply].sum())
            self.n_events += S_apply
            r.clock = float(cum[S_apply - 1])
            self.last_event_t = max(self.last_event_t, r.clock)
            if r.draining and r.load == 0:
                self._set_state(r, r.clock, active=False)
        if S_apply < K_stop:              # straddler: one in-flight step
            r.pend_kind = "decode"
            r.pend_dur = float(d[S_apply])
            r.pend_bb = int(bb_step[S_apply])
            r.pend_end = float(cum[S_apply])

    def _gather_steps(self) -> Dict[str, np.ndarray]:
        ts = [np.asarray(self.ps_t, np.float64)] + self.ch_t
        ds = [np.asarray(self.ps_dur, np.float64)] + self.ch_dur
        bs = [np.asarray(self.ps_bb, np.int64)] + \
            [c.astype(np.int64) for c in self.ch_bb]
        ks = [np.asarray(self.ps_kind, np.uint8)] + \
            [np.full(len(c), 1, np.uint8) for c in self.ch_t]
        rp = [np.asarray(self.ps_rep, np.int32)] + \
            [np.full(cn, rid, np.int32) for rid, cn in self.ch_rep]
        if self._comp_steps is not None:          # prior compactions
            c = self._comp_steps
            ts, ds = [c["t_end"]] + ts, [c["duration_s"]] + ds
            bs, ks = [c["bb"]] + bs, [c["kind"]] + ks
            rp = [c["replica"]] + rp
        t_end = np.concatenate(ts) if ts else np.zeros(0)
        order = np.argsort(t_end, kind="stable")
        dur = np.concatenate(ds)[order]
        bb = np.concatenate(bs)[order]
        return {"t_end": t_end[order], "replica": np.concatenate(rp)[order],
                "kind": np.concatenate(ks)[order], "bb": bb,
                "duration_s": dur, "tokens_out": bb}

    def _maybe_compact(self) -> None:
        """Under an ``obs.max_steps`` ring cap, fold the step buffers
        down to the most recent ``cap`` records whenever retention
        exceeds 2x cap — peak telemetry memory stays O(cap) however
        long the run, while ``_tot_*`` keeps the lossless aggregates."""
        cap = self._step_cap
        if not cap or self._retained <= 2 * cap:
            return
        g = self._gather_steps()
        n = len(g["t_end"])
        if n > cap:
            self._steps_dropped += n - cap
            g = {k: v[n - cap:] for k, v in g.items()}
        self._comp_steps = g
        self.ps_t.clear()
        self.ps_dur.clear()
        self.ps_bb.clear()
        self.ps_kind.clear()
        self.ps_rep.clear()
        self.ch_t.clear()
        self.ch_dur.clear()
        self.ch_bb.clear()
        self.ch_rep.clear()
        self._retained = len(g["t_end"])

    def _collect_steps(self) -> Dict[str, np.ndarray]:
        g = self._gather_steps()
        cap = self._step_cap
        if cap and len(g["t_end"]) > cap:         # final truncation
            self._steps_dropped += len(g["t_end"]) - cap
            g = {k: v[len(g["t_end"]) - cap:] for k, v in g.items()}
        return g
