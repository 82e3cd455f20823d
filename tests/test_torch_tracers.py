"""The port's runtime tracers: ``assert_max_compiles`` counts the port's
compilations (``torch.compile`` frames, CUDA graph captures, ``nvcc``
builds, each by its own counting site) and raises over budget, importing
the tracers loads neither Dynamo nor Triton, and ``nan_guard`` is the
reference's on numpy leaves and behaves the same on torch tensors."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.staticcheck import tracers as ref_tracers
from repro_torch.kernels import _build
from repro_torch.staticcheck.tracers import (CompileBudgetExceeded,
                                             assert_max_compiles,
                                             count_compiles, nan_guard,
                                             note_compile)

REPO = Path(__file__).resolve().parents[1]


def test_torch_compile_frames_are_counted_and_gated():
    def twice(x):
        return x * 2.0

    f = torch.compile(twice, backend="eager", dynamic=False)
    with count_compiles("two shapes") as rep:
        f(torch.ones(8))
        f(torch.ones(16))
    assert (rep.n_frames, rep.n_captures, rep.n_builds) == (2, 0, 0)
    assert rep.count == 2 and rep.limit is None
    with assert_max_compiles(0, label="steady") as rep:
        f(torch.ones(8))
        f(torch.ones(16))
    assert rep.count == 0
    with pytest.raises(CompileBudgetExceeded,
                       match=r"budget exceeded \[must not compile\]: 1 > 0"):
        with assert_max_compiles(0, label="must not compile"):
            f(torch.ones(32))


def test_noted_captures_and_builds_land_in_their_fields():
    with count_compiles() as rep:
        note_compile("capture")
        note_compile("build")
        note_compile("build")
    assert (rep.n_captures, rep.n_builds, rep.n_frames) == (1, 2, 0)
    assert rep.count == 3
    with pytest.raises(CompileBudgetExceeded, match="captures=1, builds=0"):
        with assert_max_compiles(0):
            note_compile("capture")
    with assert_max_compiles(1):
        note_compile("capture")
    with pytest.raises(ValueError, match="unknown compile kind"):
        note_compile("jit")


def test_build_counts_each_source_it_compiles_and_no_cached_one(
        tmp_path, monkeypatch):
    """``_build.build`` counts a build for every source it compiles, none
    for a library already built (a stand-in compiler writes the output)."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\nwhile [ \"$1\" != -o ]; do shift; done\n"
                    "echo built > \"$2\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_tool", lambda name="nvcc": str(nvcc))
    with count_compiles() as rep:
        logs = _build.build(("rmsnorm", "gbt_hist"))
    assert sorted(logs) == ["gbt_hist", "rmsnorm"]
    assert (rep.n_builds, rep.count) == (2, 2)
    with assert_max_compiles(0):
        assert _build.build(("rmsnorm", "gbt_hist")) == {}
    assert _build.library_path("rmsnorm").read_text() == "built\n"


def test_importing_the_tracers_loads_neither_dynamo_nor_triton():
    code = ("import sys\n"
            "import repro_torch.staticcheck.tracers as t\n"
            "with t.count_compiles() as rep:\n"
            "    pass\n"
            "print(rep.count, sorted(n for n in sys.modules if n == 'triton'\n"
            "      or n.startswith(('torch._dynamo', 'triton.'))))\n")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "0 []"


def test_the_counting_sites_do_not_load_the_checker():
    """The kernel builder and the serving engine count through
    ``repro_torch.compiles``: importing them loads none of the tooling
    package (its AST engine and rules)."""
    code = ("import sys\n"
            "import repro_torch.kernels._build, repro_torch.inference.engine\n"
            "print(sorted(n for n in sys.modules\n"
            "      if n.startswith('repro_torch.staticcheck')))\n")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# ---------------------------------------------------------------- nan_guard
NUMPY_OUTPUTS = [
    {"params": np.ones(3), "err": np.array([1.0, np.nan])},
    [np.arange(3), {"s": "text", "v": 1.5}],
    (np.inf, 0.0),
    [np.zeros(2), (np.float32(np.nan),)],
    np.array([[1.0, -np.inf], [2.0, 3.0]]),
    np.array([1 + 0j, complex(np.nan, 0)]),
]


@pytest.mark.parametrize("allow_inf", [True, False])
@pytest.mark.parametrize("i", range(len(NUMPY_OUTPUTS)))
def test_nan_guard_is_the_references_on_numpy_leaves(i, allow_inf):
    out = NUMPY_OUTPUTS[i]

    def outcome(guard):
        try:
            guard(lambda: out, label="fit", allow_inf=allow_inf)()
            return None
        except FloatingPointError as err:
            return str(err)

    got, want = outcome(nan_guard), outcome(ref_tracers.nan_guard)
    assert got == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nan_guard_on_tensors(dtype):
    clean = torch.tensor([1.0, 2.0], dtype=dtype)
    inf = torch.tensor([1.0, float("inf")], dtype=dtype)
    nan = torch.tensor([[1.0], [float("nan")]], dtype=dtype)
    assert nan_guard(lambda: {"p": clean, "d": inf})()["d"] is inf
    with pytest.raises(FloatingPointError,
                       match=r"nan_guard\[online.predict\]: non-finite fit "
                             r"output at output\[1\]: NaN"):
        nan_guard(lambda: (clean, nan), label="online.predict")()
    with pytest.raises(FloatingPointError, match=r"output\['d'\]: inf"):
        nan_guard(lambda: {"d": inf}, allow_inf=False)()
    # integer tensors and leaves that require grad pass through
    grad = clean.float().requires_grad_()
    assert nan_guard(lambda: [torch.arange(3), grad])()[1] is grad


def test_nan_guard_names_the_wrapped_function():
    @nan_guard
    def fit():
        return torch.tensor([float("nan")])

    with pytest.raises(FloatingPointError, match=r"nan_guard\[.*fit\]"):
        fit()
