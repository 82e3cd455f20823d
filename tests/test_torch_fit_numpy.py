"""The port's scalar float64 LM oracle ``fit_exponential_numpy`` against
the reference's on ``benchmarks/run.py::perf_vmapped_fit``'s seeded curves
(64 of its 512), and the port's batched float32 fit against the port's
oracle as ``tests/test_ala_core.py`` holds the JAX package's.

The port solves each 3x3 step by ``_solve3``'s cofactor expression where
the reference calls ``np.linalg.solve``: the two round differently, so
the fits agree within a tolerance, not bit for bit (on all 512 curves, at
60 and 200 iterations: theta within 2.1e-6 relative, predictions within
2.7e-9)."""
import numpy as np
import pytest

from repro.core.expmodel import exp_model as ref_exp_model
from repro.core.expmodel import initial_params as ref_initial_params
from repro.core.fit import fit_exponential_numpy as ref_fit
from repro_torch.core.expmodel import exp_model, initial_params
from repro_torch.core.fit import (fit_exponential_groups,
                                  fit_exponential_numpy)

N_CURVES = 64


def _curves(n=N_CURVES):
    """perf_vmapped_fit's groups: the first n of its 512 seeded curves."""
    rng = np.random.default_rng(0)
    groups = []
    for _ in range(n):
        bbv = np.array([1, 2, 4, 8, 16, 32, 64, 128, 256], float)
        a, b = rng.uniform(100, 5000), rng.uniform(0.01, 0.3)
        c = rng.uniform(500, 20000)
        y = ref_exp_model(bbv, a, b, min(c + a, 30000)) \
            * rng.lognormal(0, 0.03, len(bbv))
        groups.append((bbv, y, ref_initial_params(bbv, y)))
    return groups


GROUPS = _curves()


def test_initial_params_are_the_references():
    for bb, y, theta0 in GROUPS:
        assert initial_params(bb, y).tobytes() == theta0.tobytes()


@pytest.mark.parametrize("iters", [60, 200])
def test_oracle_matches_the_reference(iters):
    got = np.array([fit_exponential_numpy(*g, iters=iters) for g in GROUPS])
    want = np.array([ref_fit(*g, iters=iters) for g in GROUPS])
    assert got.dtype == np.float64 and got.shape == (N_CURVES, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    for (bb, _, _), g, w in zip(GROUPS, got, want):
        np.testing.assert_allclose(exp_model(bb, *g), ref_exp_model(bb, *w),
                                   rtol=1e-7, atol=0)


def test_oracle_leaves_its_inputs_alone():
    bb, y, theta0 = (a.copy() for a in GROUPS[0])
    fit_exponential_numpy(bb, y, theta0, iters=5)
    for a, b in zip((bb, y, theta0), GROUPS[0]):
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("which", ["test_ala_core", "perf_vmapped_fit"])
def test_batched_fit_matches_the_oracle(which):
    if which == "test_ala_core":
        # tests/test_ala_core.py::test_lm_jax_matches_numpy_oracle's curve
        rng = np.random.default_rng(0)
        bb = np.array([1, 2, 4, 8, 16, 32, 64], float)
        y = exp_model(bb, 800.0, 0.08, 1000.0) \
            * rng.lognormal(0, 0.02, len(bb))
        groups = [(bb, y, initial_params(bb, y))]
    else:
        groups = GROUPS
    batched = fit_exponential_groups(groups, device="cpu")
    for (bb, y, theta0), th in zip(groups, batched):
        np.testing.assert_allclose(
            exp_model(bb, *th),
            exp_model(bb, *fit_exponential_numpy(bb, y, theta0)), rtol=5e-2)
