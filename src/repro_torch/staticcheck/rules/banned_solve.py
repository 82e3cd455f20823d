"""banned-solve: dense ``linalg.solve`` anywhere in the port.

Contract: every 3x3 LM solve routes through the closed-form,
batch-invariant ``repro_torch.core.fit._solve3`` (its cofactor expression
on float64 scalars in ``fit_exponential_numpy``).  ``torch.linalg.solve``
and ``np.linalg.solve`` use pivoted LAPACK/cuSOLVER paths whose results
depend on batch composition and backend, which breaks the online engine's
bit-for-bit "untouched groups reuse their params" refit parity
(``update_exponential_database``).  Unlike the reference, the port has no
exempt file: its scalar oracle solves in closed form too.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.staticcheck.engine import (Finding, Rule, dotted_name,
                                            in_port)


class BannedSolve(Rule):
    name = "banned-solve"
    description = ("dense linalg.solve in the port (use the batch-invariant "
                   "fit._solve3)")
    contract = ("batch-invariant LM solves: untouched (ii,oo) groups "
                "reuse params bit-for-bit across online refits")

    def applies(self, relpath: str) -> bool:
        return in_port(relpath)

    def check(self, tree: ast.AST, text: str,
              relpath: str) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            chain = dotted_name(node.func)
            if chain and chain.endswith(".linalg.solve"):
                out.append(self.finding(
                    relpath, node,
                    f"{chain} is not batch-invariant; route through "
                    f"repro_torch.core.fit._solve3"))
        return out


RULE = BannedSolve()
