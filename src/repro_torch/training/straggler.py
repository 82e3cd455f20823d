"""Straggler detection & mitigation hooks.

A copy of the reference package's ``training/straggler.py`` (numpy only):
the port keeps its own because it imports nothing of the reference.

On a real fleet, per-host step durations feed this monitor; here the same
logic is driven by wall-clock step times (and unit-tested with synthetic
traces).  Mitigations exposed to the trainer:

  * flagging (exclude/replace a persistently slow host at the next elastic
    restart),
  * bounded-staleness accumulation: if the slow host exceeds the deadline,
    the step proceeds with the gradients that arrived (scaled), bounded to
    ``max_stale`` consecutive skips — the standard backup-worker recipe
    adapted to synchronous data parallelism.

ALA tie-in: the step-time EWMA doubles as an online throughput sample that
can be fed back into the benchmark database.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class StragglerConfig:
    window: int = 32
    threshold: float = 1.8      # x median => straggler
    max_stale: int = 4          # max consecutive proceed-without


class StragglerMonitor:
    def __init__(self, cfg: Optional[StragglerConfig] = None):
        self.cfg = cfg or StragglerConfig()
        self.durations: Dict[int, Deque[float]] = collections.defaultdict(
            lambda: collections.deque(maxlen=self.cfg.window))
        self.stale: Dict[int, int] = collections.defaultdict(int)

    def record(self, host: int, duration_s: float) -> None:
        self.durations[host].append(duration_s)

    def median_duration(self) -> float:
        allv = [v for q in self.durations.values() for v in q]
        return float(np.median(allv)) if allv else 0.0

    def stragglers(self) -> List[int]:
        med = self.median_duration()
        if med <= 0:
            return []
        out = []
        for host, q in self.durations.items():
            if len(q) >= 4 and float(np.median(q)) > self.cfg.threshold * med:
                out.append(host)
        return sorted(out)

    def should_proceed_without(self, host: int) -> bool:
        """Bounded staleness: proceed if the host hasn't been skipped more
        than max_stale consecutive steps."""
        if self.stale[host] >= self.cfg.max_stale:
            return False
        self.stale[host] += 1
        return True

    def mark_arrived(self, host: int) -> None:
        self.stale[host] = 0
