"""no-shim-import: imports of a ``perfmodel.tpu`` shim in the port.

Contract: every hardware descriptor the port prices against comes from
``repro_torch.perfmodel.hardware``.  The reference keeps
``repro.perfmodel.tpu`` only as a DeprecationWarning shim for
out-of-tree callers, and the port has no such module: an import of either
package's ``perfmodel.tpu``, in any spelling (``import``, ``from ...
import tpu``, ``importlib.import_module``), is a finding.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.staticcheck.engine import (Finding, Rule, dotted_name,
                                            in_port)

_SHIMS = ("repro.perfmodel.tpu", "repro_torch.perfmodel.tpu")
_MSG = ("import repro_torch.perfmodel.hardware instead; perfmodel.tpu is a "
        "deprecated shim the port does not have")


def _is_shim(module: str) -> bool:
    return any(module == s or module.startswith(s + ".") for s in _SHIMS)


class NoShimImport(Rule):
    name = "no-shim-import"
    description = ("import of a deprecated perfmodel.tpu shim in the port")
    contract = ("single hardware-descriptor module: all port code prices "
                "against repro_torch.perfmodel.hardware")

    def applies(self, relpath: str) -> bool:
        return in_port(relpath)

    def check(self, tree: ast.AST, text: str,
              relpath: str) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if _is_shim(alias.name):
                        out.append(self.finding(relpath, node, _MSG))
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if _is_shim(mod):
                    out.append(self.finding(relpath, node, _MSG))
                elif mod in ("repro.perfmodel", "repro_torch.perfmodel") \
                        and any(a.name == "tpu" for a in node.names):
                    out.append(self.finding(relpath, node, _MSG))
            elif isinstance(node, ast.Call):
                chain = dotted_name(node.func)
                if chain in ("importlib.import_module",
                             "import_module", "__import__") and \
                        node.args and \
                        isinstance(node.args[0], ast.Constant) and \
                        isinstance(node.args[0].value, str) and \
                        node.args[0].value.startswith(_SHIMS):
                    out.append(self.finding(relpath, node, _MSG))
        return out


RULE = NoShimImport()
