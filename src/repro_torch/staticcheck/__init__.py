"""repro-torch-check: contract-aware static analysis for the port.

``python -m repro_torch.staticcheck [paths]`` runs the
AST rule engine (engine.py) with the port's contract rules (rules/, the
reference checker's eight rule names, scoped to the port's paths and
spelled as torch spells them) over every ``*.py`` under the given paths
(default: ``src/repro_torch`` ``chip_smoke.py``) and exits non-zero on
any finding.  The sibling ``tracers`` module holds the *runtime* side of
the same contracts: ``assert_max_compiles`` (gates on the port's
compilations: CUDA graph captures, ``nvcc`` builds, ``torch.compile``
frames) and ``nan_guard``.

The README's port section holds the rule catalog; the suppression
marker is ``# repro-torch-check: disable=<rule>``.
"""
from repro_torch.staticcheck.engine import (CheckResult, Finding, Rule,
                                            check_paths, check_source)
from repro_torch.staticcheck.rules import ALL_RULES, RULES_BY_NAME

__all__ = [
    "Finding", "Rule", "CheckResult", "check_source", "check_paths",
    "ALL_RULES", "RULES_BY_NAME",
]
