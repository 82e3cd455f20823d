"""ALA-driven request scheduler / capacity planner.

This is the paper's motivation made concrete: the serving layer consults
ALA's throughput predictions (with confidence) to pick batch sizes and
replica counts without benchmarking every configuration.

* ``plan_batch_size`` — smallest bb whose predicted throughput meets a
  target, or the bb maximizing predicted throughput under a per-token
  latency SLO.  Low-confidence predictions are derated by the clamped
  ``derate_confidence`` safety factor (proportional below the floor,
  never under ``min_derate`` — so the implied scale-out headroom is
  bounded and the degenerate confidence=0.0 sentinel stays finite).
* ``BatchingQueue``  — groups incoming requests into (ii, oo)-homogeneous
  batches of the planned size (the regime the engine serves).

A copy of the reference package's ``inference/scheduler.py`` over the
port's ``ALA``: given the same fit it makes the reference's plans.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.ala import ALA


@dataclasses.dataclass
class Request:
    rid: int
    ii: int
    oo: int


@dataclasses.dataclass
class CapacityPlan:
    bb: int
    predicted_thpt: float
    confidence: float
    derated_thpt: float
    replicas: int = 1
    degenerate: bool = False   # confidence hit the (inf, 0.0) sentinel


def derate_confidence(conf: float, floor: float = 0.7,
                      min_derate: float = 0.25) -> float:
    """Safety multiplier applied to a prediction with confidence ``conf``.

    Full trust at or above ``floor``; below it, derate proportionally but
    never under ``min_derate`` — the degenerate sentinel
    (``confidence == 0.0``) and non-finite garbage land on ``min_derate``
    instead of zeroing the plan (whose 1/derate headroom would divide by
    zero).  Shared by the static ``CapacityPlanner`` and the dynamic
    ``repro_torch.serving.autoscaler``."""
    if not np.isfinite(conf):
        return min_derate
    if conf >= floor:
        return 1.0
    return float(np.clip(conf, min_derate, 1.0))


class CapacityPlanner:
    def __init__(self, ala: ALA, candidate_bb: Tuple[int, ...] = (
            1, 2, 4, 8, 16, 32, 64, 128, 256),
            confidence_floor: float = 0.7,
            min_derate: float = 0.25, max_replicas: int = 64):
        self.ala = ala
        self.candidate_bb = candidate_bb
        self.confidence_floor = confidence_floor
        self.min_derate = min_derate
        self.max_replicas = max_replicas

    def _confidence(self, ii: int, oo: int, bbs: np.ndarray) -> float:
        if self.ala.error_model is None or self.ala.sa_log is None:
            return 1.0
        new = (np.full(len(bbs), float(ii)), np.full(len(bbs), float(oo)),
               bbs.astype(np.float64), np.full(len(bbs), np.nan))
        _, conf = self.ala.estimate(new)
        return conf

    def plan_batch_size(self, ii: int, oo: int,
                        target_thpt: Optional[float] = None,
                        max_token_latency_s: Optional[float] = None
                        ) -> CapacityPlan:
        bbs = np.asarray(self.candidate_bb, np.float64)
        thpt = self.ala.predict(np.full(len(bbs), float(ii)),
                                np.full(len(bbs), float(oo)), bbs)
        conf = self._confidence(ii, oo, bbs)
        derate = derate_confidence(conf, self.confidence_floor,
                                   self.min_derate)
        eff = thpt * derate
        ok = np.ones(len(bbs), bool)
        if max_token_latency_s is not None:
            # per-token latency for a request ~ bb / thpt(bb)
            lat = bbs / np.maximum(eff, 1e-9)
            ok &= lat <= max_token_latency_s
        if target_thpt is not None:
            ok &= eff >= target_thpt
        if ok.any():
            # smallest qualifying batch (lowest latency at target)
            i = int(np.argmax(ok))
        else:
            # nothing qualifies: max effective throughput, scale out
            i = int(np.argmax(eff))
        replicas = 1
        if target_thpt is not None and eff[i] < target_thpt:
            replicas = int(min(np.ceil(target_thpt / max(eff[i], 1e-9)),
                               self.max_replicas))
        return CapacityPlan(bb=int(bbs[i]), predicted_thpt=float(thpt[i]),
                            confidence=float(conf),
                            derated_thpt=float(eff[i]), replicas=replicas,
                            degenerate=bool(conf <= 0.0))


class BatchingQueue:
    """Groups same-(ii,oo)-bucket requests into planned batch sizes."""

    def __init__(self, planner: CapacityPlanner,
                 target_thpt: Optional[float] = None):
        self.planner = planner
        self.target_thpt = target_thpt
        self.queues: Dict[Tuple[int, int], Deque[Request]] = \
            collections.defaultdict(collections.deque)
        self.plans: Dict[Tuple[int, int], CapacityPlan] = {}

    @staticmethod
    def bucket(ii: int, oo: int) -> Tuple[int, int]:
        b = lambda v: 1 << int(np.ceil(np.log2(max(v, 1))))
        return b(ii), b(oo)

    def submit(self, req: Request) -> None:
        self.queues[self.bucket(req.ii, req.oo)].append(req)

    def ready_batches(self) -> List[Tuple[Tuple[int, int], List[Request]]]:
        out = []
        for key, q in self.queues.items():
            if key not in self.plans:
                self.plans[key] = self.planner.plan_batch_size(
                    key[0], key[1], target_thpt=self.target_thpt)
            bb = self.plans[key].bb
            while len(q) >= bb:
                out.append((key, [q.popleft() for _ in range(bb)]))
        return out

    def flush(self) -> List[Tuple[Tuple[int, int], List[Request]]]:
        out = []
        for key, q in self.queues.items():
            if q:
                out.append((key, list(q)))
                q.clear()
        return out
