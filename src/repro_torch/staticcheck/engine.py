"""AST rule engine for ``repro-torch-check``, the port's contract checker.

The port's bit-for-bit tests rest on the reference's implicit contracts
(batch-invariant solves, seeded random streams, the float32 fixed-bin
edge contract, sim-clock-only simulation code, provenance-stamped BENCH
artifacts, compile-once graph and kernel placement, immutable config
defaults).  Each contract is one :class:`Rule`, scoped to the port's
paths and spelled as torch spells it; the engine parses every file once,
hands the tree to each applicable rule, and filters the findings through
inline suppressions.

Suppression syntax (same line as the finding)::

    graph = torch.cuda.CUDAGraph()  # repro-torch-check: disable=jit-in-loop

Multiple rules separate with commas.  A disable comment that suppresses
nothing is itself a finding (``unused-suppression``).  The marker is
``repro-torch-check``, not the reference checker's ``repro-check``: both
checkers read every port file and each audits the waivers it can read, so
a waiver that only one checker's rule needs would be a stale waiver to the
other.  Each reads its own marker only.

Rules subclass :class:`Rule` and register in
``repro_torch.staticcheck.rules.ALL_RULES``; the engine imports the rules
package only inside the functions that need the registry (rules import the
engine), so adding a rule touches only ``rules/``.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import pathlib
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = [
    "Finding", "Rule", "CheckResult", "check_source", "check_paths",
    "dotted_name", "parent_map", "enclosing_function", "repo_relpath",
    "PORT_SRC", "in_port",
]

_SUPPRESS_RE = re.compile(
    r"#\s*repro-torch-check:\s*disable=([A-Za-z0-9_,\-]+)")


# the port's own files: its package and the script that drives it on the card
PORT_SRC = "src/repro_torch/"
_SMOKE = "chip_smoke.py"


def in_port(relpath: str) -> bool:
    """Whether ``relpath`` is a file of the port's package or its
    ``chip_smoke.py``."""
    return relpath.startswith(PORT_SRC) or relpath == _SMOKE


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One contract violation at ``path:line:col``."""
    path: str
    line: int
    col: int
    rule: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] " \
               f"{self.message}"


class Rule:
    """One machine-checked contract.

    Subclasses set ``name`` (the CLI/suppression identifier),
    ``description`` (one line for ``--list-rules``), and ``contract``
    (the invariant protected), then implement :meth:`check`.  Override
    :meth:`applies` to scope the rule to a subtree of the repo;
    ``relpath`` is always posix-style relative to the repo root
    (``src/repro_torch/serving/fleet.py``).
    """

    name: str = ""
    description: str = ""
    contract: str = ""

    def applies(self, relpath: str) -> bool:
        return True

    def check(self, tree: ast.AST, text: str,
              relpath: str) -> List[Finding]:
        raise NotImplementedError

    def finding(self, relpath: str, node: ast.AST,
                message: str) -> Finding:
        return Finding(path=relpath, line=getattr(node, "lineno", 1),
                       col=getattr(node, "col_offset", 0) + 1,
                       rule=self.name, message=message)


# ------------------------------------------------------------------ AST utils
def dotted_name(node: ast.AST) -> Optional[str]:
    """``Attribute``/``Name`` chain as a dotted string, else None.

    ``torch.linalg.solve`` -> "torch.linalg.solve"; anything rooted in a
    call/subscript (``foo().bar``) yields None: rules match syntactic
    spelling, not resolved objects.
    """
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def parent_map(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    """Child -> parent for every node (the stdlib ast has no uplinks)."""
    parents: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def enclosing_function(node: ast.AST,
                       parents: Dict[ast.AST, ast.AST]) -> Optional[str]:
    """Name of the nearest enclosing def, or None at module level."""
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur.name
        cur = parents.get(cur)
    return None


# ------------------------------------------------------------- suppressions
def _parse_suppressions(text: str) -> Dict[int, List[str]]:
    """line -> rule names disabled on that line (source order kept).

    Tokenized, not regexed over raw lines: a disable spelled inside a
    string literal (docs, fixtures) is content, not a waiver.
    """
    out: Dict[int, List[str]] = {}
    try:
        tokens = tokenize.generate_tokens(io.StringIO(text).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if m:
                out[tok.start[0]] = [n.strip()
                                     for n in m.group(1).split(",")
                                     if n.strip()]
    except tokenize.TokenizeError:
        pass
    return out


def _default_rules() -> Sequence[Rule]:
    from repro_torch.staticcheck.rules import ALL_RULES
    return ALL_RULES


def _default_rules_by_name() -> Dict[str, Rule]:
    from repro_torch.staticcheck.rules import RULES_BY_NAME
    return RULES_BY_NAME


def check_source(text: str, relpath: str,
                 rules: Optional[Sequence[Rule]] = None) -> List[Finding]:
    """Run every applicable rule over one file's source.

    Returns the post-suppression findings, including synthesized
    ``unused-suppression`` findings for disable comments that shielded
    nothing, and a ``parse-error`` finding when the file does not parse
    (a file the checker cannot see is a file the contracts do not cover).
    """
    if rules is None:
        rules = _default_rules()
    # three tiers of rule-name knowledge for suppression auditing:
    # registry-known names from an unselected rule (CLI --rule subset)
    # pass silently, selected-but-inapplicable or fired-nothing names are
    # stale waivers, and unregistered names are typos
    try:
        registry = set(_default_rules_by_name())
    except Exception:
        registry = set()
    selected = {r.name for r in rules}
    known = registry | selected
    applicable_names = {r.name for r in rules if r.applies(relpath)}
    try:
        tree = ast.parse(text)
    except SyntaxError as e:
        return [Finding(path=relpath, line=e.lineno or 1,
                        col=(e.offset or 0) + 1, rule="parse-error",
                        message=f"file does not parse: {e.msg}")]

    raw: List[Finding] = []
    for rule in rules:
        if rule.applies(relpath):
            raw.extend(rule.check(tree, text, relpath))

    suppress = _parse_suppressions(text)
    kept: List[Finding] = []
    used: Set[Tuple[int, str]] = set()
    for f in raw:
        names = suppress.get(f.line, [])
        if f.rule in names:
            used.add((f.line, f.rule))
        else:
            kept.append(f)
    for line, names in suppress.items():
        for nm in names:
            if (line, nm) in used:
                continue
            if nm not in known:
                kept.append(Finding(
                    path=relpath, line=line, col=1,
                    rule="unused-suppression",
                    message=f"disable names unknown rule '{nm}'"))
            elif nm in selected and nm not in applicable_names:
                kept.append(Finding(
                    path=relpath, line=line, col=1,
                    rule="unused-suppression",
                    message=f"disable={nm} is moot: the rule does not "
                            f"apply to {relpath}; remove the waiver"))
            elif nm in applicable_names:
                kept.append(Finding(
                    path=relpath, line=line, col=1,
                    rule="unused-suppression",
                    message=f"disable={nm} suppresses nothing on this "
                            f"line; remove the stale waiver"))
            # registry-known but unselected (--rule subset): tolerated
    kept.sort()
    return kept


# ------------------------------------------------------------------ walking
def repo_relpath(path: pathlib.Path,
                 root: Optional[pathlib.Path] = None) -> str:
    """Posix path relative to the repo root, for rule scoping.

    The root is the first ancestor of the file holding ``src/repro_torch``
    (or a ``.git``); files outside any repo keep their given spelling, and
    scoped rules then simply don't apply, the safe direction for a checker.
    """
    path = pathlib.Path(path)
    resolved = path.resolve()
    if root is None:
        for anc in resolved.parents:
            if (anc / "src" / "repro_torch").is_dir() or \
                    (anc / ".git").exists():
                root = anc
                break
    if root is not None:
        try:
            return resolved.relative_to(pathlib.Path(root).resolve()) \
                           .as_posix()
        except ValueError:
            pass
    return path.as_posix()


@dataclasses.dataclass
class CheckResult:
    findings: List[Finding]
    n_files: int

    @property
    def ok(self) -> bool:
        return not self.findings


def _iter_py_files(paths: Iterable[pathlib.Path]) -> List[pathlib.Path]:
    files: List[pathlib.Path] = []
    for p in paths:
        p = pathlib.Path(p)
        if p.is_dir():
            files.extend(sorted(f for f in p.rglob("*.py")
                                if "__pycache__" not in f.parts))
        elif p.suffix == ".py":
            files.append(p)
    return files


def check_paths(paths: Sequence, rules: Optional[Sequence[Rule]] = None,
                root: Optional[pathlib.Path] = None) -> CheckResult:
    """Check every ``*.py`` under ``paths`` (files or directories)."""
    findings: List[Finding] = []
    files = _iter_py_files(paths)
    for f in files:
        findings.extend(check_source(f.read_text(),
                                     repo_relpath(f, root=root),
                                     rules=rules))
    findings.sort()
    return CheckResult(findings=findings, n_files=len(files))
