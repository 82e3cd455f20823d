"""float64-edges: bin-edge construction missing the float32 cast.

Contract: ``SubsetBank`` (``core/uncertainty.py``), ``StreamHist``
(``obs/metrics.py``) and the span histograms (``obs/tracing.py``) share
one fixed-bin contract: edges are **float32**, and bin assignment compares
float32 values against float32 edges (``searchsorted(side="right")``, in
numpy or torch).  An edge array left in float64 buckets boundary values
differently from the device path, so serial/batched parity and shard-merge
equality silently drift by one bin.  The rule scopes to the port's
contract modules and fires on any ``*edges*``-named function (or
``inner_edges`` assignment) that builds an array or tensor without a
float32 cast in sight: ``float32`` named (``np.float32``,
``dtype=torch.float32``, ``.to(torch.float32)``, ``"float32"``) or a
``.float()`` call.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.staticcheck.engine import Finding, Rule, dotted_name

_CONTRACT_FILES = (
    "src/repro_torch/core/uncertainty.py",
    "src/repro_torch/obs/metrics.py",
    "src/repro_torch/obs/tracing.py",
)
# numpy's builders and torch's (linspace and arange are both)
_BUILDERS = ("linspace", "geomspace", "logspace", "arange",
             "concatenate", "asarray", "array", "cat", "tensor", "as_tensor")


def _mentions_float32(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr == "float32":
            return True
        if isinstance(sub, ast.Name) and sub.id == "float32":
            return True
        if isinstance(sub, ast.Constant) and sub.value == "float32":
            return True
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute) \
                and sub.func.attr == "float" and not sub.args:
            return True
    return False


def _builds_array(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            chain = dotted_name(sub.func)
            if chain and chain.split(".")[-1] in _BUILDERS:
                return True
    return False


class Float64Edges(Rule):
    name = "float64-edges"
    description = ("bin-edge construction without a float32 cast in the "
                   "SubsetBank/StreamHist contract modules")
    contract = ("float32 fixed-bin edges: serial, device-side, and "
                "shard-merged histograms bucket boundary values "
                "identically")

    def applies(self, relpath: str) -> bool:
        return relpath in _CONTRACT_FILES

    def check(self, tree: ast.AST, text: str,
              relpath: str) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(tree):
            if isinstance(node, ast.FunctionDef) and "edges" in node.name:
                body = ast.Module(body=node.body, type_ignores=[])
                if _builds_array(body) and not _mentions_float32(body):
                    out.append(self.finding(
                        relpath, node,
                        f"{node.name} builds bin edges without a "
                        f"float32 cast; the SubsetBank/StreamHist "
                        f"contract compares float32 values against "
                        f"float32 edges"))
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                named = any("inner_edges" in (dotted_name(t) or "")
                            for t in targets)
                value = node.value
                if named and value is not None and _builds_array(value) \
                        and not _mentions_float32(value):
                    out.append(self.finding(
                        relpath, node,
                        "inner_edges assigned without a float32 cast; "
                        "edge arrays must be float32 to match the "
                        "device path's bucketize"))
        return out


RULE = Float64Edges()
