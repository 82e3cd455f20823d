"""bench-provenance: BENCH artifacts serialized outside ``_write_bench``.

Contract: every ``results/BENCH_*.json`` carries a provenance stamp (git
SHA, library versions, backend/device, UTC wall-clock, seed), so any
number in a committed artifact answers "which code, which machine, which
run".  A function named ``_write_bench`` is the single write path that
stamps it; a raw ``json.dump``/``json.dumps`` aimed at a ``BENCH_*`` file
ships an unstamped artifact.
"""
from __future__ import annotations

import ast
from typing import Dict, List

from repro_torch.staticcheck.engine import (Finding, Rule, dotted_name,
                                            enclosing_function, parent_map)

_HELPER = "_write_bench"


def _stmt_mentions_bench(stmt: ast.AST) -> bool:
    for node in ast.walk(stmt):
        if isinstance(node, ast.Constant) and \
                isinstance(node.value, str) and "BENCH_" in node.value:
            return True
    return False


class BenchProvenance(Rule):
    name = "bench-provenance"
    description = ("json.dump of a BENCH_* artifact outside the "
                   "provenance-stamping _write_bench helper")
    contract = ("artifact provenance: every results/BENCH_*.json is "
                "stamped with git SHA, versions, device, and seed")

    def check(self, tree: ast.AST, text: str,
              relpath: str) -> List[Finding]:
        out: List[Finding] = []
        parents: Dict[ast.AST, ast.AST] = parent_map(tree)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            chain = dotted_name(node.func)
            if chain not in ("json.dump", "json.dumps"):
                continue
            if enclosing_function(node, parents) == _HELPER:
                continue
            # climb to the enclosing statement: the filename usually sits
            # beside the dump (write_text / open target / f-string)
            stmt = node
            while stmt in parents and not isinstance(stmt, ast.stmt):
                stmt = parents[stmt]
            if _stmt_mentions_bench(stmt):
                out.append(self.finding(
                    relpath, node,
                    f"{chain} writes a BENCH_* artifact without a "
                    f"provenance stamp; route it through a {_HELPER} "
                    f"helper"))
        return out


RULE = BenchProvenance()
