"""unseeded-rng: global-state or seedless random draws in the port.

Contract: every stochastic stream in the port is explicitly seeded, an
``np.random.default_rng(seed)`` or a ``torch.Generator`` passed as
``generator=``: trace generation, fault plans, SA chains, telemetry
corruption, weight init and stub inputs are *replayable by construction*,
and the bit-for-bit tests against the reference depend on it.  Spellings
that break it:

* numpy's legacy ``np.random.<dist>`` global-state calls, stdlib
  ``random.*`` module functions, and ``default_rng()`` with no seed (the
  reference's rule);
* torch draws with no ``generator=`` (``torch.rand``, ``randn``,
  ``randint``, ``randperm``, ``multinomial``, ``normal``, ``bernoulli``,
  ``poisson``, the ``*_like`` draws), and in-place samplers
  (``.uniform_``, ``.normal_``, ...) with none, all of which draw from
  torch's global stream;
* seeding that global stream (``torch.manual_seed``,
  ``torch.cuda.manual_seed[_all]``, ``torch.seed``): code that relies on
  it shares one mutable stream with every other caller.

Benchmarks and tests may do what they like; the rule scopes to the port's
package.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.staticcheck.engine import (PORT_SRC, Finding, Rule,
                                            dotted_name)

# np.random members that construct explicit generators/seeds rather than
# drawing from the legacy global stream
_NP_CONSTRUCTORS = {
    "default_rng", "Generator", "SeedSequence", "BitGenerator",
    "PCG64", "PCG64DXSM", "Philox", "MT19937", "SFC64", "RandomState",
}
# stdlib random module functions (module-level = hidden global state)
_STDLIB_FNS = {
    "random", "randint", "randrange", "choice", "choices", "shuffle",
    "sample", "uniform", "gauss", "seed", "betavariate", "expovariate",
    "normalvariate", "lognormvariate", "triangular", "vonmisesvariate",
    "paretovariate", "weibullvariate", "getrandbits", "randbytes",
}
# torch functions that draw from the global stream unless given generator=
_TORCH_DRAWS = {
    f"torch.{fn}" for fn in (
        "rand", "randn", "randint", "randperm", "multinomial", "normal",
        "bernoulli", "poisson", "rand_like", "randn_like", "randint_like")}
# in-place samplers of a tensor (and of torch.nn.init's same-named helpers)
_INPLACE_DRAWS = {"uniform_", "normal_", "random_", "exponential_",
                  "bernoulli_", "cauchy_", "geometric_", "log_normal_"}
_TORCH_SEEDING = {"torch.manual_seed", "torch.seed", "torch.random.seed",
                  "torch.random.manual_seed", "torch.cuda.manual_seed",
                  "torch.cuda.manual_seed_all", "torch.cuda.seed",
                  "torch.cuda.seed_all"}


def _is_none(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value is None


def _seedless(node: ast.Call) -> bool:
    """No positional seed and no seed= keyword, or an explicit None."""
    if node.args:
        return _is_none(node.args[0])
    for kw in node.keywords:
        if kw.arg == "seed":
            return _is_none(kw.value)
    return True


def _no_generator(node: ast.Call) -> bool:
    """No generator= keyword, or an explicit None."""
    for kw in node.keywords:
        if kw.arg == "generator":
            return _is_none(kw.value)
    return True


class UnseededRng(Rule):
    name = "unseeded-rng"
    description = ("global-state np.random/stdlib random/torch draw, torch "
                   "global seeding, or seedless default_rng() in the port")
    contract = ("seed-determinism: traces, fault plans, SA chains, "
                "corruption streams and weights replay bit-identically "
                "from their recorded seeds")

    def applies(self, relpath: str) -> bool:
        return relpath.startswith(PORT_SRC)

    def check(self, tree: ast.AST, text: str,
              relpath: str) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(tree):
            # bare-name imports make later call sites untraceable: flag
            # `from random import choice` / `from numpy.random import
            # normal` at the import
            if isinstance(node, ast.ImportFrom):
                if node.module == "random":
                    for alias in node.names:
                        if alias.name in _STDLIB_FNS:
                            out.append(self.finding(
                                relpath, node,
                                f"`from random import {alias.name}` "
                                f"pulls in hidden global RNG state; "
                                f"use a seeded default_rng"))
                elif node.module == "numpy.random":
                    for alias in node.names:
                        if alias.name not in _NP_CONSTRUCTORS:
                            out.append(self.finding(
                                relpath, node,
                                f"`from numpy.random import "
                                f"{alias.name}` draws from the global "
                                f"stream; use a seeded default_rng"))
                continue
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _INPLACE_DRAWS and _no_generator(node):
                out.append(self.finding(
                    relpath, node,
                    f".{node.func.attr}() with no generator= draws from "
                    f"torch's global stream; pass a seeded "
                    f"torch.Generator"))
                continue
            chain = dotted_name(node.func)
            if chain is None:
                continue
            if chain in _TORCH_DRAWS:
                if _no_generator(node):
                    out.append(self.finding(
                        relpath, node,
                        f"{chain} with no generator= draws from torch's "
                        f"global stream; pass a seeded torch.Generator"))
            elif chain in _TORCH_SEEDING:
                out.append(self.finding(
                    relpath, node,
                    f"{chain} seeds torch's global stream, which every "
                    f"caller shares; seed a torch.Generator and pass it "
                    f"as generator="))
            elif chain.startswith(("np.random.", "numpy.random.")):
                member = chain.rsplit(".", 1)[1]
                if member in ("default_rng", "RandomState"):
                    if _seedless(node):
                        out.append(self.finding(
                            relpath, node,
                            f"{chain}() with no seed draws fresh OS "
                            f"entropy; pass an explicit seed"))
                elif member not in _NP_CONSTRUCTORS:
                    out.append(self.finding(
                        relpath, node,
                        f"{chain} uses numpy's global RNG stream; draw "
                        f"from an explicitly seeded "
                        f"np.random.default_rng(seed)"))
            elif chain.startswith("random.") and chain.count(".") == 1:
                member = chain.split(".", 1)[1]
                if member in _STDLIB_FNS:
                    out.append(self.finding(
                        relpath, node,
                        f"stdlib {chain} uses hidden global state; use "
                        f"a seeded np.random.default_rng(seed)"))
            elif chain == "default_rng" and _seedless(node):
                out.append(self.finding(
                    relpath, node,
                    "default_rng() with no seed draws fresh OS entropy; "
                    "pass an explicit seed"))
        return out


RULE = UnseededRng()
