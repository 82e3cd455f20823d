"""Rule registry: one module per contract, one instance per rule, with
the reference checker's rule names.

Adding a rule: create ``rules/<name>.py`` with a ``Rule`` subclass and a
module-level ``RULE`` instance, import it here, append to ``ALL_RULES``,
name it in the README's port catalog, and add positive/negative/waived
fixtures in tests/test_torch_staticcheck.py.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.staticcheck.engine import Rule
from repro_torch.staticcheck.rules.banned_solve import RULE as BANNED_SOLVE
from repro_torch.staticcheck.rules.bench_provenance import \
    RULE as BENCH_PROVENANCE
from repro_torch.staticcheck.rules.float64_edges import RULE as FLOAT64_EDGES
from repro_torch.staticcheck.rules.jit_in_loop import RULE as JIT_IN_LOOP
from repro_torch.staticcheck.rules.mutable_default_config import \
    RULE as MUTABLE_DEFAULT_CONFIG
from repro_torch.staticcheck.rules.no_shim_import import RULE as NO_SHIM_IMPORT
from repro_torch.staticcheck.rules.unseeded_rng import RULE as UNSEEDED_RNG
from repro_torch.staticcheck.rules.wallclock_in_sim import \
    RULE as WALLCLOCK_IN_SIM

ALL_RULES: Tuple[Rule, ...] = (
    BANNED_SOLVE,
    NO_SHIM_IMPORT,
    UNSEEDED_RNG,
    WALLCLOCK_IN_SIM,
    BENCH_PROVENANCE,
    FLOAT64_EDGES,
    JIT_IN_LOOP,
    MUTABLE_DEFAULT_CONFIG,
)

RULES_BY_NAME: Dict[str, Rule] = {r.name: r for r in ALL_RULES}

__all__ = ["ALL_RULES", "RULES_BY_NAME"]
