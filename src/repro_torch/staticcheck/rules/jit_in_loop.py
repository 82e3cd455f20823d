"""jit-in-loop: a compilation evaluated inside a ``for``/``while`` body.

Contract: the port's compilations are paid once per signature, as the
reference's XLA compiles are paid once per shape bucket.  In the port a
compilation is a CUDA graph capture (``torch.cuda.CUDAGraph()``,
``torch.cuda.graph(...)``, ``torch.cuda.make_graphed_callables``, the
engine's ``DecodeGraph(...)``), an ``nvcc`` build
(``kernels/_build.build(...)``), or a ``torch.compile`` /
``torch.jit.script`` / ``torch.jit.trace`` (also through
``functools.partial``, and as a bare decorator).  One evaluated
*syntactically inside a loop body* pays it every iteration, and the
``assert_max_compiles`` gates blow up.  A function *defined* inside the
loop shields its own calls (they run per call, not per iteration), so
only the directly-in-loop case fires.  Names match by their dotted
spelling: ``_build.build`` fires, a bare ``build`` (a local closure, say)
does not.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional

from repro_torch.staticcheck.engine import (Finding, Rule, dotted_name,
                                            in_port, parent_map)

_COMPILES = {"torch.compile", "torch.jit.script", "torch.jit.trace",
             "torch.cuda.CUDAGraph", "torch.cuda.graph",
             "torch.cuda.make_graphed_callables"}
# matched as the whole dotted name or as its last parts
_TAILS = ("DecodeGraph", "_build.build")
_DECORATORS = {"torch.compile", "torch.jit.script"}
_PARTIAL = {"functools.partial", "partial"}


def _compiles(chain: Optional[str]) -> bool:
    if chain is None:
        return False
    return chain in _COMPILES or any(
        chain == t or chain.endswith("." + t) for t in _TAILS)


def _is_compile_call(node: ast.Call) -> bool:
    chain = dotted_name(node.func)
    if _compiles(chain):
        return True
    if chain in _PARTIAL and node.args:
        return _compiles(dotted_name(node.args[0]))
    return False


class JitInLoop(Rule):
    name = "jit-in-loop"
    description = ("CUDA graph capture, nvcc build or torch.compile "
                   "evaluated inside a for/while body (per-iteration "
                   "compile)")
    contract = ("compile-once placement: graphs are captured, kernels "
                "built and functions compiled per signature, never per "
                "loop iteration")

    def applies(self, relpath: str) -> bool:
        return in_port(relpath)

    def check(self, tree: ast.AST, text: str,
              relpath: str) -> List[Finding]:
        out: List[Finding] = []
        parents: Dict[ast.AST, ast.AST] = parent_map(tree)
        # call sites, plus bare `@torch.compile` decorators (Attribute, not
        # Call): those execute in the enclosing scope when the def
        # statement runs, so a decorated def in a loop body compiles per
        # iteration just like a call would
        occurrences: List[ast.AST] = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and _is_compile_call(node):
                occurrences.append(node)
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                occurrences.extend(
                    deco for deco in node.decorator_list
                    if not isinstance(deco, ast.Call)
                    and dotted_name(deco) in _DECORATORS)
        for node in occurrences:
            child: ast.AST = node
            cur = parents.get(node)
            while cur is not None:
                if isinstance(cur, (ast.FunctionDef,
                                    ast.AsyncFunctionDef, ast.Lambda)):
                    # a decorator executes in the enclosing scope; anything
                    # else inside the def is shielded by its boundary
                    if child not in getattr(cur, "decorator_list", []):
                        break
                elif isinstance(cur, (ast.For, ast.While)):
                    what = dotted_name(getattr(node, "func", node))
                    out.append(self.finding(
                        relpath, node,
                        f"{what} evaluated inside a loop body compiles "
                        f"(captures, builds) every iteration; hoist it out "
                        f"of the loop or into a factory"))
                    break
                child = cur
                cur = parents.get(cur)
        return out


RULE = JitInLoop()
