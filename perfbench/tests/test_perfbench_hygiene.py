"""What the benchmark runs stands apart from the JAX package: no module
that ``perfbench/run.py``, its readers and its reference import has the
top-level name ``jax``, ``jaxlib``, ``flax`` or ``repro`` (names compared
whole: ``repro_torch`` is the port), and the reference imports nothing of
the program either."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from _perfbench_cells import REPO

BENCH = REPO / "perfbench"
FILES = sorted(p for p in BENCH.rglob("*.py")
               if "out" not in p.relative_to(BENCH).parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_benchmark_file_imports_jax_or_repro(path):
    assert not _roots(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_only_torch(path):
    assert _roots(path) <= {"__future__", "math", "torch"}


def _loaded(code):
    env = {**os.environ, "PYTHONPATH": f"{REPO / 'src'}{os.pathsep}{REPO}"}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_a_run_loads_no_jax_nor_repro():
    """Everything a run imports: the harness, every metric reader, the
    check and the program's modules it drives."""
    roots = _loaded(
        "import sys\n"
        "from pathlib import Path\n"
        "from perfbench import harness, check, devtrace\n"
        "for p in sorted(Path('perfbench/metrics').glob('*.py')):\n"
        "    harness.reader(Path('.'), p.stem)\n"
        "import repro_torch.inference.engine, repro_torch.models.transformer\n"
        "harness.model_config(harness.load_cell(Path('.'), "
        "'phi3.5-moe-l24.decode').config)\n"
        "print(*{n.split('.')[0] for n in sys.modules})\n")
    assert "repro_torch" in roots and "perfbench" in roots
    assert not roots & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    roots = _loaded("import sys\nimport perfbench.reference.decoder\n"
                    "print(*{n.split('.')[0] for n in sys.modules})\n")
    assert not roots & (FORBIDDEN | {"repro_torch"})
