"""wallclock-in-sim: wall-clock reads inside simulation code.

Contract: simulated time advances only through the event heap / bucket
clock.  ``time.time``, ``time.monotonic`` and ``datetime.now`` inside the
port's ``serving/``, ``core/`` or ``perfmodel/`` leak host wall-clock into
simulation state, silently breaking replay determinism and the
heap-vs-fleet parity.  ``time.perf_counter`` stays allowed (the fit
pipeline and the engines use it for *reported timings*, never for sim
state), and bench and provenance code (``bench/``, ``launch/``, ``obs``
export, ``chip_smoke.py``) is out of scope: stamping artifacts with real
wall-clock is the point there.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.staticcheck.engine import (PORT_SRC, Finding, Rule,
                                            dotted_name)

_SCOPES = tuple(f"{PORT_SRC}{d}/" for d in ("serving", "core", "perfmodel"))
_BANNED = {
    "time.time", "time.monotonic", "time.monotonic_ns", "time.time_ns",
    "datetime.now", "datetime.utcnow",
    "datetime.datetime.now", "datetime.datetime.utcnow",
}


class WallclockInSim(Rule):
    name = "wallclock-in-sim"
    description = ("time.time/time.monotonic/datetime.now inside the "
                   "port's serving/, core/, or perfmodel/")
    contract = ("sim-clock purity: simulation state advances only via "
                "the event clock, so identical seeds replay "
                "identically on any host")

    def applies(self, relpath: str) -> bool:
        return relpath.startswith(_SCOPES)

    def check(self, tree: ast.AST, text: str,
              relpath: str) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(tree):
            # the bare-name spelling: `from time import time` makes the
            # later call site indistinguishable from any `time()`, so flag
            # the import itself
            if isinstance(node, ast.ImportFrom) and node.module == "time":
                for alias in node.names:
                    if alias.name in ("time", "monotonic", "time_ns",
                                      "monotonic_ns"):
                        out.append(self.finding(
                            relpath, node,
                            f"`from time import {alias.name}` hides a "
                            f"wall-clock read from the sim-clock "
                            f"contract; import the module and keep "
                            f"wall-clock out of simulation code"))
                continue
            if not isinstance(node, ast.Call):
                continue
            chain = dotted_name(node.func)
            if chain in _BANNED or (chain or "").endswith("datetime.now"):
                out.append(self.finding(
                    relpath, node,
                    f"{chain} reads host wall-clock inside simulation "
                    f"code; use the sim clock (time.perf_counter is "
                    f"allowed for reported timings only)"))
        return out


RULE = WallclockInSim()
