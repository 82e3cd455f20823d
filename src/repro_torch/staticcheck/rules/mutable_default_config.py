"""mutable-default-config: mutable defaults on dataclass fields.

Contract: config dataclasses (``SimConfig``, ``SAConfig``,
``OnlineConfig``, ``ObsConfig``, the frozen ``HardwareProfile`` /
``ModelConfig`` descriptors) are shared freely across benchmark arms and
fleet replicas; two arms mutating one shared default list/dict/array is
cross-arm contamination no parity test can detect.  The dataclass
machinery rejects bare ``list``/``dict``/``set`` *instances* at
class-creation time, but a ``field(default=[...])``, an ``np.zeros(...)``
or ``torch.zeros(...)`` default, or a constructor call (``dict()``,
``collections.deque()``) slips through and is shared by every instance.
Use ``field(default_factory=...)`` or an immutable tuple.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from repro_torch.staticcheck.engine import Finding, Rule, dotted_name

_DATACLASS_DECOS = {"dataclass", "dataclasses.dataclass"}
_FIELD_FNS = {"field", "dataclasses.field"}
_MUTABLE_CTORS = {"list", "dict", "set", "bytearray"}
_MUTABLE_ATTRS = {"zeros", "ones", "empty", "full", "array", "deque",
                  "defaultdict", "OrderedDict", "Counter"}


def _is_dataclass(cls: ast.ClassDef) -> bool:
    for deco in cls.decorator_list:
        target = deco.func if isinstance(deco, ast.Call) else deco
        if dotted_name(target) in _DATACLASS_DECOS:
            return True
    return False


def _mutable_default(node: ast.AST) -> Optional[str]:
    """A description of the mutable value, or None if it is safe."""
    if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                         ast.DictComp, ast.SetComp)):
        return "a mutable literal"
    if isinstance(node, ast.Call):
        chain = dotted_name(node.func)
        if chain in _MUTABLE_CTORS:
            return f"a {chain}() instance"
        if chain and chain.split(".")[-1] in _MUTABLE_ATTRS:
            return f"a {chain}(...) instance"
    return None


class MutableDefaultConfig(Rule):
    name = "mutable-default-config"
    description = ("mutable default value on a dataclass field "
                   "(shared across every instance)")
    contract = ("config isolation: dataclass instances shared across "
                "benchmark arms / replicas never alias mutable state")

    def check(self, tree: ast.AST, text: str,
              relpath: str) -> List[Finding]:
        out: List[Finding] = []
        for cls in ast.walk(tree):
            if not (isinstance(cls, ast.ClassDef) and _is_dataclass(cls)):
                continue
            for stmt in cls.body:
                if isinstance(stmt, (ast.AnnAssign, ast.Assign)):
                    default = stmt.value
                else:
                    continue
                if default is None:
                    continue
                if isinstance(default, ast.Call) and \
                        dotted_name(default.func) in _FIELD_FNS:
                    for kw in default.keywords:
                        if kw.arg == "default":
                            why = _mutable_default(kw.value)
                            if why:
                                out.append(self.finding(
                                    relpath, stmt,
                                    f"field(default=...) holds {why}, "
                                    f"shared by every {cls.name}; use "
                                    f"default_factory"))
                    continue
                why = _mutable_default(default)
                if why:
                    out.append(self.finding(
                        relpath, stmt,
                        f"dataclass field default is {why}, shared by "
                        f"every {cls.name} instance; use "
                        f"field(default_factory=...) or a tuple"))
        return out


RULE = MutableDefaultConfig()
