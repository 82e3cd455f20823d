"""K4's whole-fit entry ``grow_fit`` on CPU tensors (its plain version),
held to the level-by-level loop, the host loop and the JAX package.

Bit for bit: ``grow_fit`` against ``core.gbt._grow_levels`` (one
``build_node_histograms`` and one ``split_level`` a level) and against
``core.gbt._grow_forests_host`` with K4's plain histograms (the float64
numpy oracle), on the same seeded fit.  Predictions of fits that
``grow_forests`` routes through ``grow_fit`` lie within the 1e-3 of
``tests/test_torch_gbt_level.py`` of the JAX package's ``use_kernel=True``
forests.  ``fits_on_chip`` is a pure function of the shapes, checked at the
main path's.  The kernel itself runs only on a card
(``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase [3])."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import gbt as jgbt

from repro_torch.core import gbt as tgbt
from repro_torch.core.predictor import (_DEFAULT_KW, _xy,
                                        train_param_predictors)
from repro_torch.kernels.gbt_hist import ops as gh_ops
from repro_torch.kernels.gbt_hist.cases import fit_case, fit_state

LAM, MCW, LR = 1.0, 1.0, 0.1
TREES = 2
STATE = ("pred", "grad", "node", "level", "feature", "threshold", "left",
         "right", "value", "n_nodes")


def _bits(t):
    return t.numpy().tobytes()


@pytest.mark.parametrize("n", [16, 48, 125])
@pytest.mark.parametrize("L", [1, 15])
@pytest.mark.parametrize("n_bins", [4, 64, 128])
@pytest.mark.parametrize("max_depth", [1, 2, 3, 4, 5, 6])
def test_grow_fit_is_the_level_loop_and_the_host_loop(max_depth, n_bins, L,
                                                      n):
    c = fit_case(max_depth * 1000 + n_bins + L + n, L, n, 5, n_bins,
                 distinct=3 if n_bins == 64 else 0)
    got = fit_state(c, TREES, max_depth, "cpu")
    gh_ops.grow_fit(got, TREES, max_depth, n_bins, LAM, MCW, LR)
    levels = fit_state(c, TREES, max_depth, "cpu")
    tgbt._grow_levels(levels, TREES, max_depth, n_bins, LAM, MCW, LR)
    for k in STATE:
        assert _bits(getattr(got, k)) == _bits(getattr(levels, k)), k
    host = tgbt._grow_forests_host(c["bins"], c["y"], c["w"], c["base"],
                                   TREES, LR, max_depth, n_bins, MCW, LAM,
                                   True, torch.device("cpu"))
    for k, want in zip(("feature", "threshold", "left", "right", "value",
                        "n_nodes"), host):
        a = getattr(got, k).numpy()
        assert a.dtype == want.dtype and a.tobytes() == want.tobytes(), k
    assert (got.feature >= 0).any()


@pytest.fixture
def on_chip(monkeypatch):
    """The dispatch the card takes, on CPU tensors: fits with K4 grow
    through ``grow_forests``, which hands every fit ``fits_on_chip``
    accepts to ``grow_fit`` (here its plain version); records those calls.
    Fits without K4 keep the float64 host loop."""
    monkeypatch.setattr(tgbt, "_resident_on",
                        lambda use_kernel, *a: bool(use_kernel))
    calls = []
    grow_fit = gh_ops.grow_fit

    def spy(state, *args):
        calls.append(tuple(state.bins.shape))
        return grow_fit(state, *args)

    monkeypatch.setattr(gh_ops, "grow_fit", spy)
    return calls


def _data(seed, C, n, f, O):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 10, (C, n, f))
    Y = np.stack([X[..., 0] * 3 + X[..., 1], np.sin(X[..., 2]),
                  X[..., 1] ** 2][:O], -1) + rng.normal(0, 0.1, (C, n, O))
    W = (rng.random((C, n)) < 0.7).astype(np.float64)
    return X, Y, W


def _near_jax(got, jax32, jax64, port64, ties):
    """``got`` (the port's fp32 forests through ``grow_fit``) within the
    1e-3 of ``tests/test_torch_gbt_level.py`` of ``jax32`` (the JAX
    package's ``use_kernel=True`` forests) at every prediction, except at
    a tie: where the JAX package's fp32 forests leave its own float64 ones
    by more than that, a near-tie split is decided by the fp32 histograms'
    summation order, which differs (a one-hot matmul there, row order in
    K4; ROADMAP queue C's finding on fp32 histograms).  At a tie ``got``
    is within 1e-3 of one of the two, and there are at most ``ties`` of
    them, the count measured on these seeded inputs.  The two packages'
    float64 forests agree within 1e-3 everywhere."""
    def close(a, b):
        return np.abs(a - b) <= 1e-3 * (1 + np.abs(b))
    tie = ~close(jax32, jax64)
    assert np.all(close(got, jax32) | (tie & close(got, jax64)))
    assert np.all(close(port64, jax64))
    assert tie.sum() <= ties


# (max_depth, n_bins, ties): the ties measured are 1 of 432 predictions
# (9 forests x 48 rows) at depth 2 over 16 bins, 8 of 432 at depth 4 over 64
@pytest.mark.parametrize("max_depth,n_bins,ties", [(2, 16, 1), (4, 64, 8)])
def test_packed_forest_through_grow_fit_near_the_jax_packages(on_chip,
                                                             max_depth,
                                                             n_bins, ties):
    X, Y, W = _data(30 + max_depth, 3, 48, 7, 3)
    kw = dict(n_estimators=5, max_depth=max_depth, n_bins=n_bins)
    got = tgbt.fit_packed_forest(X, Y, W, use_kernel=True, device="cpu", **kw)
    assert on_chip == [(9, 48, 7)]
    port64 = tgbt.fit_packed_forest(X, Y, W, use_kernel=False, device="cpu",
                                    **kw)
    assert on_chip == [(9, 48, 7)]            # the host loop: no grow_fit
    _near_jax(*(m.predict(X, backend="numpy") for m in (
        got, jgbt.fit_packed_forest(X, Y, W, use_kernel=True, **kw),
        jgbt.fit_packed_forest(X, Y, W, use_kernel=False, **kw), port64)),
        ties)


@pytest.mark.parametrize("max_depth,n_bins", [(3, 4), (6, 64)])
def test_gbt_regressor_through_grow_fit_near_the_jax_packages(on_chip,
                                                             max_depth,
                                                             n_bins):
    X, Y, _ = _data(40 + max_depth, 1, 125, 6, 1)
    kw = dict(n_estimators=6, max_depth=max_depth, n_bins=n_bins,
              learning_rate=0.2)
    got = tgbt.GBTRegressor(use_kernel=True, device="cpu", **kw).fit(
        X[0], Y[0, :, 0])
    assert on_chip == [(1, 125, 6)]
    port64 = tgbt.GBTRegressor(use_kernel=False, device="cpu", **kw).fit(
        X[0], Y[0, :, 0])
    _near_jax(*(m.predict(X[0]) for m in (
        got, jgbt.GBTRegressor(use_kernel=True, **kw).fit(X[0], Y[0, :, 0]),
        jgbt.GBTRegressor(use_kernel=False, **kw).fit(X[0], Y[0, :, 0]),
        port64)), ties=0)                   # measured: no tie in 125


def test_a_fit_beyond_the_chip_grows_level_by_level(on_chip, monkeypatch):
    X, Y, W = _data(50, 2, 40, 4, 1)
    kw = dict(n_estimators=3, max_depth=3, n_bins=16, use_kernel=True,
              device="cpu")
    want = tgbt.fit_packed_forest(X, Y, W, **kw)
    monkeypatch.setattr(gh_ops, "fits_on_chip", lambda *a: False)
    splits = []
    split_level = gh_ops.split_level
    monkeypatch.setattr(gh_ops, "split_level",
                        lambda *a: splits.append(a[3]) or split_level(*a))
    levels = tgbt.grow_forests.levels
    got = tgbt.fit_packed_forest(X, Y, W, **kw)
    assert on_chip == [(2, 40, 4)]            # the first fit only
    assert splits == [0, 1, 2, 3] * 3
    assert tgbt.grow_forests.levels - levels == 12
    for k in ("feature", "threshold", "left", "right", "value", "n_nodes"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k


# the main path's fits: (L, n, f, n_bins, max_depth)
MAIN_PATH = {
    "Alg 3 predictor": (3, 48, 7, 64, 4),
    "SA, 4 chains of 3 candidates": (36, 48, 7, 64, 4),
    "SA's packed forests, 60 trees": (15, 48, 7, 64, 4),
    "Alg 7, serial log": (1, 32, 24, 4, 4),
    "Alg 7, chains' log": (1, 125, 24, 4, 4),
    "registry, joint Alg 3": (114, 16, 7, 64, 4),
    "online refit of one combination": (3, 16, 7, 64, 4),
    "vanilla XGBoost on inhouse": (1, 3360, 3, 64, 6),
    "gradient boosting on inhouse": (1, 3360, 3, 64, 3),
}


@pytest.mark.parametrize("name", list(MAIN_PATH))
def test_fits_on_chip_takes_every_main_path_fit(name):
    """... and whatever cluster the card's plan picks, its block holds the
    fit."""
    L, n, f, n_bins, max_depth = MAIN_PATH[name]
    assert gh_ops.fits_on_chip(L, n, f, n_bins, max_depth)
    for most in range(1, min(f, gh_ops.GROW_MAX_CLUSTER) + 1):
        assert gh_ops.grow_smem_bytes(n, f, n_bins, max_depth, most) \
            <= gh_ops.GROW_SMEM


def test_fits_on_chip_refuses_what_the_kernel_cannot_hold():
    assert not gh_ops.fits_on_chip(1, 11_088, 3, 64, 6)   # suite's rows
    assert not gh_ops.fits_on_chip(1, 70_000, 1, 4, 1)    # 16-bit row ids
    assert not gh_ops.fits_on_chip(1, 48, 7, 129, 4)      # numpy's sum
    assert not gh_ops.fits_on_chip(1, 48, 7, 64, 9)       # 256 nodes a level
    assert not gh_ops.fits_on_chip(0, 48, 7, 64, 4)
    assert not gh_ops.fits_on_chip(2 ** 31, 48, 7, 64, 4)  # the grid
    # the shared memory grows with the rows: a row takes its bins, pred,
    # node, grad, hess and two 16-bit ids (feature 0 and the block's own)
    a, b = (gh_ops.grow_smem_bytes(n, 3, 64, 6, 3) for n in (1000, 2000))
    assert b - a == 1000 * (3 + 8 + 4 + 4 + 4 + 2 * 2)
    # (features a block, blocks) of a cluster of at most `most` blocks
    assert gh_ops.grow_split(7, 7) == (1, 7)
    assert gh_ops.grow_split(24, 8) == (3, 8)
    assert gh_ops.grow_split(9, 8) == (2, 5)
    assert gh_ops.grow_split(7, 2) == (4, 2)
    assert gh_ops.grow_split(7, 1) == (7, 1)


def test_grow_fit_checks_its_inputs():
    c = fit_case(5, 2, 20, 3, 16)
    s = fit_state(c, 2, 3, "cpu")
    with pytest.raises(TypeError, match="GrowState"):
        gh_ops.grow_fit(dataclasses.asdict(s), 2, 3, 16, LAM, MCW, LR)
    with pytest.raises(ValueError, match="n_trees"):
        gh_ops.grow_fit(s, 3, 3, 16, LAM, MCW, LR)
    with pytest.raises(ValueError, match="max_depth"):
        gh_ops.grow_fit(s, 2, 4, 16, LAM, MCW, LR)
    with pytest.raises(ValueError, match="n_bins"):
        gh_ops.grow_fit(s, 2, 3, 129, LAM, MCW, LR)
    bad = fit_state(c, 2, 3, "cpu")
    object.__setattr__(bad, "pred", bad.pred.float())    # wrong dtype
    with pytest.raises(ValueError, match="GrowState.pred"):
        gh_ops.grow_fit(bad, 2, 3, 16, LAM, MCW, LR)
    bad = fit_state(c, 2, 3, "cpu")
    object.__setattr__(bad, "node", bad.node[:, :5])      # wrong shape
    with pytest.raises(ValueError, match="GrowState.node"):
        gh_ops.grow_fit(bad, 2, 3, 16, LAM, MCW, LR)
    meta = gh_ops.GrowState(**{k: torch.empty_like(getattr(s, k),
                                                   device="meta")
                               for k in s.__dataclass_fields__})
    with pytest.raises(ValueError, match="meta"):
        gh_ops.grow_fit(meta, 2, 3, 16, LAM, MCW, LR)
    launches = gh_ops.grow_fit.launches
    gh_ops.grow_fit(s, 2, 3, 16, LAM, MCW, LR)
    assert gh_ops.grow_fit.launches == launches   # CPU: plain version
    assert (s.n_nodes > 1).any()


def test_fit_joint_fits_one_by_one_with_sampling():
    """The joint-fit decision lives in ``MultiOutputGBT.fit_joint``: with
    row sampling it fits each table alone on its rows of weight > 0, which
    is what ``train_param_predictors`` and ``MultiOutputGBT.fit`` get."""
    rng = np.random.default_rng(6)
    tables = [np.column_stack([rng.choice([128.0, 512.0, 2048.0], m),
                               rng.choice([64.0, 256.0], m),
                               rng.uniform(1, 9, (m, 3))])
              for m in (12, 9)]
    kw = dict(n_estimators=4, max_depth=2, n_bins=8, subsample=0.7)
    got = train_param_predictors(tables, device="cpu", **kw)
    for table, model in zip(tables, got):
        alone = tgbt.MultiOutputGBT(3, device="cpu",
                                    **dict(_DEFAULT_KW, **kw)).fit(*_xy(table))
        assert not model.can_joint
        for a, b in zip(model.models, alone.models):
            assert len(a.trees_) == len(b.trees_) == 4
            for ta, tb in zip(a.trees_, b.trees_):
                assert np.array_equal(ta.feature, tb.feature)
                assert np.array_equal(ta.value, tb.value)
