"""repro-torch-check, the port's contract checker: each rule's positive,
negative and waived fixtures (torch spellings included), its agreement
with the reference checker's rule on every numpy or stdlib fixture, the
two waiver markers, suppression auditing, the CLI, the README's catalog,
and the self-check that the port is clean at HEAD."""
import pathlib

import pytest

from repro.staticcheck import RULES_BY_NAME as REF_RULES
from repro.staticcheck import check_paths as ref_check_paths
from repro.staticcheck import check_source as ref_check_source
from repro_torch.staticcheck import (ALL_RULES, RULES_BY_NAME, check_paths,
                                     check_source)
from repro_torch.staticcheck.__main__ import main as cli_main

REPO = pathlib.Path(__file__).resolve().parents[1]
CORE = "src/repro_torch/core/x.py"
SMOKE = "chip_smoke.py"


def names(findings, rule=None):
    return [f.rule for f in findings if rule is None or f.rule == rule]


def waive(src: str, line: int, rule: str,
          marker: str = "repro-torch-check") -> str:
    lines = src.splitlines()
    lines[line - 1] += f"  # {marker}: disable={rule}"
    return "\n".join(lines) + "\n"


# (rule, path, source, line of the violation): paths matter, since most
# rules are scoped to the port's package or its chip_smoke.py
POSITIVE = [
    ("banned-solve", "src/repro_torch/core/fit.py",
     "import torch\nd = torch.linalg.solve(A, r)\n", 2),
    ("banned-solve", SMOKE, "d = np.linalg.solve(A, r)\n", 1),
    ("banned-solve", "src/repro_torch/core/online.py",
     "d = scipy.linalg.solve(A, r)\n", 1),
    ("no-shim-import", "src/repro_torch/serving/x.py",
     "from repro_torch.perfmodel import tpu\n", 1),
    ("no-shim-import", "src/repro_torch/core/x.py",
     "import repro_torch.perfmodel.tpu\n", 1),
    ("no-shim-import", SMOKE,
     "from repro.perfmodel.tpu import TPU_V5E\n", 1),
    ("no-shim-import", CORE,
     "import importlib\nm = importlib.import_module("
     "'repro_torch.perfmodel.tpu')\n", 2),
    ("unseeded-rng", CORE, "import torch\nx = torch.randn(4, 8)\n", 2),
    ("unseeded-rng", CORE,
     "x = torch.randint(0, 5, (3,), generator=None)\n", 1),
    ("unseeded-rng", CORE, "i = torch.multinomial(p, 1)\n", 1),
    ("unseeded-rng", CORE, "p = torch.randperm(8, device='cuda')\n", 1),
    ("unseeded-rng", CORE, "y = torch.rand_like(x)\n", 1),
    ("unseeded-rng", CORE, "y = torch.poisson(rates)\n", 1),
    ("unseeded-rng", CORE, "w.normal_(0.0, 0.02)\n", 1),
    ("unseeded-rng", CORE, "torch.nn.init.uniform_(w)\n", 1),
    ("unseeded-rng", CORE, "x.bernoulli_(0.5)\n", 1),
    ("unseeded-rng", CORE, "torch.manual_seed(0)\n", 1),
    ("unseeded-rng", CORE, "torch.cuda.manual_seed_all(0)\n", 1),
    ("unseeded-rng", CORE, "s = torch.seed()\n", 1),
    ("unseeded-rng", CORE, "torch.random.manual_seed(1)\n", 1),
    ("unseeded-rng", CORE, "torch.cuda.seed()\n", 1),
    ("unseeded-rng", CORE,
     "import numpy as np\nv = np.random.normal(0.0, 1.0)\n", 2),
    ("unseeded-rng", CORE, "r = np.random.default_rng()\n", 1),
    ("unseeded-rng", CORE, "from random import choice\n", 1),
    ("wallclock-in-sim", "src/repro_torch/serving/x.py",
     "import time\nt0 = time.time()\n", 2),
    ("wallclock-in-sim", "src/repro_torch/perfmodel/x.py",
     "from time import monotonic\n", 1),
    ("wallclock-in-sim", CORE, "t = datetime.datetime.now()\n", 1),
    ("bench-provenance", "src/repro_torch/bench/x.py",
     "import json\n(RESULTS / 'BENCH_extra.json').write_text("
     "json.dumps(payload))\n", 2),
    ("bench-provenance", SMOKE,
     "import json\njson.dump(rows, open('results/BENCH_h100.json', 'w'))\n",
     2),
    ("float64-edges", "src/repro_torch/obs/metrics.py",
     "import numpy as np\ndef my_edges(lo, hi, n):\n"
     "    return np.linspace(lo, hi, n)\n", 2),
    ("float64-edges", "src/repro_torch/obs/tracing.py",
     "import torch\ndef span_edges(lo, hi, n):\n"
     "    return torch.linspace(lo, hi, n, dtype=torch.float64)\n", 2),
    ("float64-edges", "src/repro_torch/core/uncertainty.py",
     "inner_edges = torch.cat([a, b])\n", 1),
    ("jit-in-loop", CORE,
     "import torch\nfor s in shapes:\n    f = torch.compile(g)\n", 3),
    ("jit-in-loop", SMOKE,
     "while True:\n    graph = torch.cuda.CUDAGraph()\n", 2),
    ("jit-in-loop", SMOKE,
     "for b in sizes:\n    with torch.cuda.graph(graph):\n"
     "        out = step(x)\n", 2),
    ("jit-in-loop", "src/repro_torch/bench/x.py",
     "for b in sizes:\n    dg = engine.DecodeGraph(model, b, 64)\n", 2),
    ("jit-in-loop", "src/repro_torch/kernels/x.py",
     "for name in names:\n    _build.build((name,))\n", 2),
    ("jit-in-loop", CORE,
     "for s in shapes:\n    @torch.compile\n    def f(x):\n"
     "        return x\n", 2),
    ("jit-in-loop", CORE,
     "import functools\nwhile True:\n    f = functools.partial("
     "torch.compile, mode='reduce-overhead')(g)\n", 3),
    ("jit-in-loop", CORE,
     "for m in mods:\n    f = torch.jit.trace(m, x)\n", 2),
    ("jit-in-loop", CORE,
     "for m in mods:\n    f = torch.cuda.make_graphed_callables(m, (x,))\n",
     2),
    ("mutable-default-config", "src/repro_torch/serving/x.py",
     "import dataclasses\n@dataclasses.dataclass\nclass C:\n"
     "    xs: list = dataclasses.field(default=[1])\n", 4),
    ("mutable-default-config", "src/repro_torch/configs/x.py",
     "import dataclasses\n@dataclasses.dataclass(frozen=True)\nclass C:\n"
     "    w: object = torch.zeros(3)\n", 4),
]

# (rule, path, source) that must raise no finding of that rule
NEGATIVE = [
    ("banned-solve", "src/repro_torch/core/fit.py",
     "d = _solve3(A, (r0, r1, r2))\n"),
    ("banned-solve", "tests/test_torch_fit.py",     # outside the port
     "d = np.linalg.solve(A, r)\n"),
    ("no-shim-import", "src/repro_torch/serving/x.py",
     "from repro_torch.perfmodel import hardware\n"),
    ("no-shim-import", "tests/test_torch_hardware.py",
     "import repro.perfmodel.tpu\n"),
    ("unseeded-rng", CORE, "x = torch.randn(4, 8, generator=g)\n"),
    ("unseeded-rng", CORE, "i = torch.multinomial(p, 1, generator=gen)\n"),
    ("unseeded-rng", CORE, "w.normal_(0.0, 0.02, generator=g)\n"),
    ("unseeded-rng", CORE,
     "g = torch.Generator('cuda').manual_seed(0)\n"),
    ("unseeded-rng", CORE, "g.manual_seed(seed)\n"),
    ("unseeded-rng", CORE, "x = rng.normal(0.0, 1.0, 4)\n"),
    ("unseeded-rng", CORE, "r = np.random.default_rng([seed, idx])\n"),
    ("unseeded-rng", SMOKE, "x = torch.randn(4)\n"),  # outside its scope
    ("wallclock-in-sim", "src/repro_torch/serving/x.py",
     "import time\nt0 = time.perf_counter()\n"),
    ("wallclock-in-sim", "src/repro_torch/launch/dryrun.py",
     "t = time.time()\n"),
    ("wallclock-in-sim", "src/repro/serving/x.py",     # the reference's
     "t = time.time()\n"),
    ("bench-provenance", "src/repro_torch/bench/x.py",
     "import json\ndef _write_bench(filename, payload):\n"
     "    (RESULTS / filename).write_text(json.dumps(payload))\n"),
    ("bench-provenance", SMOKE,
     "import json\nprint(json.dumps({'kernels': kernels}))\n"),
    ("float64-edges", "src/repro_torch/obs/metrics.py",
     "import numpy as np\ndef my_edges(lo, hi, n):\n"
     "    return np.linspace(lo, hi, n).astype(np.float32)\n"),
    ("float64-edges", "src/repro_torch/obs/tracing.py",
     "def span_edges(lo, hi, n):\n"
     "    return torch.linspace(lo, hi, n).float()\n"),
    ("float64-edges", "src/repro_torch/obs/tracing.py",
     "def span_edges(lo, hi, n):\n"
     "    return torch.linspace(lo, hi, n, dtype=torch.float32)\n"),
    ("float64-edges", "src/repro_torch/core/uncertainty.py",
     "inner_edges = torch.cat([a, b]).to(torch.float32)\n"),
    ("float64-edges", "src/repro_torch/serving/x.py",   # not a contract file
     "def my_edges(lo, hi, n):\n    return torch.linspace(lo, hi, n)\n"),
    ("jit-in-loop", CORE,
     "for s in shapes:\n    def make(s=s):\n"
     "        return torch.compile(g)\n"),
    ("jit-in-loop", "src/repro_torch/obs/tracing.py",
     "for name in names:\n    build((name,))\n"),  # a bare name: a closure
    ("jit-in-loop", SMOKE,
     "graph = torch.cuda.CUDAGraph()\nfor _ in range(3):\n"
     "    graph.replay()\n"),
    ("jit-in-loop", CORE,
     "@torch.compile\ndef f(x):\n    for _ in range(3):\n"
     "        x = x + 1\n    return x\n"),
    ("jit-in-loop", "tests/test_torch_x.py",
     "for s in shapes:\n    f = torch.compile(g)\n"),
    ("mutable-default-config", "src/repro_torch/serving/x.py",
     "import dataclasses\n@dataclasses.dataclass\nclass C:\n"
     "    xs: tuple = (1,)\n"
     "    ys: list = dataclasses.field(default_factory=list)\n"),
    ("mutable-default-config", "src/repro_torch/configs/x.py",
     "class C:\n    registry = {}\n"),
]


def _case_id(case):
    return f"{case[0]}:{case[1]}:{case[2].splitlines()[-1].strip()[:40]}"


@pytest.mark.parametrize("case", POSITIVE, ids=_case_id)
def test_rule_positive(case):
    rule, path, src, line = case
    hits = [f for f in check_source(src, path) if f.rule == rule]
    assert [(f.line, f.path) for f in hits] == [(line, path)], hits


@pytest.mark.parametrize("case", NEGATIVE, ids=_case_id)
def test_rule_negative(case):
    rule, path, src = case
    assert not names(check_source(src, path), rule)


@pytest.mark.parametrize("case", POSITIVE, ids=_case_id)
def test_rule_waived(case):
    rule, path, src, line = case
    findings = check_source(waive(src, line, rule), path)
    assert not names(findings, rule)
    # a used waiver is not reported as unused
    assert not names(findings, "unused-suppression")


def test_every_rule_has_fixtures_and_the_reference_names():
    assert {r.name for r in ALL_RULES} == set(REF_RULES)
    assert {c[0] for c in POSITIVE} == set(RULES_BY_NAME)
    assert {c[0] for c in NEGATIVE} == set(RULES_BY_NAME)


# ------------------------------------------- agreement with the reference
# fixtures in numpy or stdlib spelling, as (rule, path under the package,
# source): the port's rule under src/repro_torch/<path> must give the
# reference's rule's (rule, line) findings under src/repro/<path>
AGREE = [
    ("banned-solve", "core/database.py", "d = np.linalg.solve(A, r)\n"),
    ("banned-solve", "core/online.py",
     "import numpy\nd = numpy.linalg.solve(A, r)\n"),
    ("banned-solve", "core/online.py", "d = np.linalg.lstsq(A, r)\n"),
    ("no-shim-import", "serving/x.py", "from repro.perfmodel import tpu\n"),
    ("no-shim-import", "core/x.py", "import repro.perfmodel.tpu\n"),
    ("no-shim-import", "core/x.py",
     "import importlib\nm = importlib.import_module('repro.perfmodel.tpu')\n"),
    ("no-shim-import", "serving/x.py",
     "from repro.perfmodel import hardware\n"),
    ("unseeded-rng", "core/x.py",
     "import numpy as np\nv = np.random.normal(0.0, 1.0)\n"),
    ("unseeded-rng", "core/x.py", "r = np.random.default_rng()\n"),
    ("unseeded-rng", "core/x.py", "r = np.random.default_rng(seed=None)\n"),
    ("unseeded-rng", "core/x.py", "import random\nrandom.seed(3)\n"),
    ("unseeded-rng", "core/x.py", "from random import choice\n"),
    ("unseeded-rng", "core/x.py", "from numpy.random import normal\n"),
    ("unseeded-rng", "core/x.py", "v = np.random.rand(4)\n"),
    ("unseeded-rng", "core/x.py", "r = np.random.RandomState()\n"),
    ("unseeded-rng", "core/x.py", "r = np.random.default_rng(0)\n"),
    ("unseeded-rng", "core/x.py", "r = np.random.default_rng(seed)\n"),
    ("unseeded-rng", "core/x.py", "r = np.random.default_rng([seed, idx])\n"),
    ("unseeded-rng", "core/x.py", "v = rng.random(4)\n"),
    ("unseeded-rng", "serving/x.py",
     "rng = np.random.default_rng(0)\nv = rng.normal(0.0, 1.0)\n"
     "w = np.random.uniform(0, 1)\n"),
    ("wallclock-in-sim", "serving/x.py", "import time\nt0 = time.time()\n"),
    ("wallclock-in-sim", "perfmodel/x.py", "t = time.monotonic()\n"),
    ("wallclock-in-sim", "perfmodel/x.py", "t = datetime.now()\n"),
    ("wallclock-in-sim", "core/x.py", "t = datetime.datetime.utcnow()\n"),
    ("wallclock-in-sim", "core/x.py", "from time import time\n"),
    ("wallclock-in-sim", "serving/x.py", "t = time.perf_counter()\n"),
    ("wallclock-in-sim", "launch/dryrun.py", "t = time.time()\n"),
    ("bench-provenance", "bench/x.py",
     "import json\n(RESULTS / 'BENCH_extra.json').write_text("
     "json.dumps(payload))\n"),
    ("bench-provenance", "bench/x.py",
     "import json\ndef _write_bench(filename, payload):\n"
     "    (RESULTS / filename).write_text(json.dumps(payload))\n"),
    ("bench-provenance", "bench/x.py",
     "import json\npath.write_text(json.dumps(report))\n"),
    ("float64-edges", "obs/metrics.py",
     "import numpy as np\ndef my_edges(lo, hi, n):\n"
     "    return np.linspace(lo, hi, n)\n"),
    ("float64-edges", "obs/metrics.py",
     "import numpy as np\ndef my_edges(lo, hi, n):\n"
     "    return np.linspace(lo, hi, n).astype(np.float32)\n"),
    ("float64-edges", "core/uncertainty.py",
     "inner_edges = np.concatenate([a, b])\n"),
    ("float64-edges", "core/uncertainty.py",
     "inner_edges = np.asarray(e, np.float32)\n"),
    ("float64-edges", "obs/tracing.py",
     "def edges_of(lo, hi, n):\n    return np.geomspace(lo, hi, n)\n"),
    ("jit-in-loop", "core/x.py",
     "for s in shapes:\n    y = np.sum(np.asarray(s))\n"),
    ("mutable-default-config", "serving/x.py",
     "import dataclasses\n@dataclasses.dataclass\nclass C:\n"
     "    xs: list = dataclasses.field(default=[1])\n"),
    ("mutable-default-config", "configs/x.py",
     "import dataclasses\n@dataclasses.dataclass(frozen=True)\nclass C:\n"
     "    x: object = np.zeros(3)\n    y: dict = dict()\n"
     "    z: object = collections.deque()\n"),
    ("mutable-default-config", "serving/x.py",
     "import dataclasses\n@dataclasses.dataclass\nclass C:\n"
     "    xs: tuple = (1,)\n"),
]


@pytest.mark.parametrize("case", AGREE, ids=_case_id)
def test_rule_agrees_with_the_reference(case):
    rule, sub, src = case
    got = check_source(src, f"src/repro_torch/{sub}",
                       rules=[RULES_BY_NAME[rule]])
    want = ref_check_source(src, f"src/repro/{sub}", rules=[REF_RULES[rule]])
    assert [(f.rule, f.line) for f in got] == \
        [(f.rule, f.line) for f in want]


def test_agreement_fixtures_fire_for_every_rule_with_a_numpy_spelling():
    fired = {c[0] for c in AGREE if names(check_source(
        c[2], f"src/repro_torch/{c[1]}", rules=[RULES_BY_NAME[c[0]]]))}
    # jit-in-loop has no numpy spelling: only its negative agrees
    assert fired == set(RULES_BY_NAME) - {"jit-in-loop"}


# ------------------------------------------------------------- the markers
def test_reference_waiver_is_content_to_the_port():
    src = "import time\nt = time.time()  # repro-check: disable=wallclock-in-sim\n"
    got = check_source(src, "src/repro_torch/serving/x.py")
    assert names(got) == ["wallclock-in-sim"]


def test_port_waiver_is_content_to_the_reference():
    src = ("import time\n"
           "t = time.time()  # repro-torch-check: disable=wallclock-in-sim\n")
    want = ref_check_source(src, "src/repro/serving/x.py")
    assert names(want) == ["wallclock-in-sim"]
    # and the port's own waiver holds where the port's rule applies
    assert not check_source(src, "src/repro_torch/serving/x.py")


def test_reference_checker_stays_clean_over_the_port():
    res = ref_check_paths([REPO / "src" / "repro_torch",
                           REPO / "chip_smoke.py"], root=REPO)
    assert res.ok, "\n".join(f.format() for f in res.findings)


# ------------------------------------------------------------ suppressions
def test_unused_suppression_detected():
    src = "x = 1  # repro-torch-check: disable=banned-solve\n"
    assert names(check_source(src, CORE), "unused-suppression")


def test_unknown_rule_in_suppression_detected():
    src = "x = 1  # repro-torch-check: disable=no-such-rule\n"
    assert any("unknown rule" in f.message for f in check_source(src, CORE))


def test_suppression_outside_the_rules_scope_is_moot():
    src = "x = torch.randn(3)  # repro-torch-check: disable=unseeded-rng\n"
    got = check_source(src, "tests/test_torch_x.py")
    assert [f.rule for f in got] == ["unused-suppression"]
    assert "moot" in got[0].message


def test_suppression_for_unselected_rule_tolerated():
    src = ("d = torch.linalg.solve(A, r)"
           "  # repro-torch-check: disable=banned-solve\n")
    assert not check_source(src, CORE, rules=[RULES_BY_NAME["no-shim-import"]])


def test_suppression_inside_string_is_content_not_waiver():
    src = 'doc = "# repro-torch-check: disable=banned-solve"\n'
    assert not check_source(src, CORE)


def test_multi_rule_suppression_one_used_one_stale():
    src = ("import time\nt = time.time()"
           "  # repro-torch-check: disable=wallclock-in-sim,banned-solve\n")
    findings = check_source(src, "src/repro_torch/serving/x.py")
    assert not names(findings, "wallclock-in-sim")
    assert len(names(findings, "unused-suppression")) == 1


def test_parse_error_is_a_finding():
    assert names(check_source("def broken(:\n", CORE), "parse-error")


# --------------------------------------------------------------- the CLI
def test_cli_list_rules(capsys):
    assert cli_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for r in ALL_RULES:
        assert r.name in out


def test_cli_finds_and_formats(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("import torch\nx = torch.randn(3)\n")
    # outside any repo root the scoped rules don't apply: clean
    assert cli_main([str(bad)]) == 0
    # inside a repo layout the finding fires, as path:line:col: [rule]
    target = tmp_path / "fake" / "src" / "repro_torch" / "core"
    target.mkdir(parents=True)
    f = target / "bad.py"
    f.write_text("import torch\nx = torch.randn(3)\n")
    capsys.readouterr()
    assert cli_main([str(f)]) == 1
    out = capsys.readouterr().out
    assert out.startswith("src/repro_torch/core/bad.py:2:")
    assert "[unseeded-rng]" in out
    assert cli_main(["--rule", "banned-solve", str(f)]) == 0


def test_cli_bad_invocations(capsys):
    assert cli_main(["--rule", "no-such-rule", "src"]) == 2
    assert cli_main(["definitely/not/a/path"]) == 2
    capsys.readouterr()


def test_every_rule_in_the_readme_catalog():
    readme = (REPO / "README.md").read_text()
    start = readme.index("## PyTorch/CUDA port")
    port = readme[start:readme.index("\n## ", start)]
    assert "# repro-torch-check: disable=" in port
    for r in ALL_RULES:
        assert r.name and r.description and r.contract
        assert f"`{r.name}`" in port, f"{r.name} missing from the catalog"


# ----------------------------------------------------------- self-check
def test_port_clean_at_head():
    """The port's checker over its package, chip_smoke.py and the port's
    tests reports nothing at HEAD."""
    paths = [REPO / "src" / "repro_torch", REPO / "chip_smoke.py",
             *sorted((REPO / "tests").glob("test_torch_*.py"))]
    res = check_paths(paths, root=REPO)
    assert res.n_files > 100
    assert res.ok, "\n".join(f.format() for f in res.findings)
