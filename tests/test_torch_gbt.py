"""K4 ``gbt_hist``'s plain version and the port's GBTs against the JAX
package.

Tolerances: the plain version within atol 1e-4 of ``gbt_hist_ref`` and of
the interpret-mode Pallas kernel (fp32 sums in another order), and exactly
equal to float32 ``np.add.at`` (the kernel's contract: fp32 sums in row
order).  With the float64 host path the trees are bit-equal to the
reference's; with ``use_kernel=True`` predictions lie within rtol 1e-3 of
the reference's ``use_kernel=True``, the reference's own bound."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gbt as jgbt
from repro.kernels.gbt_hist import ops as jgh_ops
from repro.kernels.gbt_hist.ref import gbt_hist_ref as jax_gbt_hist_ref

from repro_torch.core import gbt as tgbt
from repro_torch.kernels.gbt_hist import ops as gh_ops
from repro_torch.weights import (gbt_from_reference,
                                 packed_forest_from_reference)

TREE_FIELDS = ("feature", "threshold", "left", "right", "value")
FOREST_FIELDS = TREE_FIELDS + ("base", "bin_edges", "n_nodes")


def _hist_inputs(seed, L, n, f, n_nodes, n_bins, lo=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(lo, n_bins - lo, (L, n, f)).astype(np.int32),
            rng.standard_normal((L, n)).astype(np.float32),
            rng.random((L, n)).astype(np.float32),
            rng.integers(lo, n_nodes - lo, (L, n)).astype(np.int32))


def _hist(arrays, n_nodes, n_bins):
    return gh_ops.build_node_histograms(
        *(torch.from_numpy(a) for a in arrays), n_nodes, n_bins).numpy()


def _add_at(bins, grad, hess, node, n_nodes, n_bins, dtype):
    L, n, f = bins.shape
    out = np.zeros((L, n_nodes, f, n_bins, 2), dtype)
    ok = ((bins >= 0) & (bins < n_bins) & (node[..., None] >= 0)
          & (node[..., None] < n_nodes))
    li, ri, fi = np.nonzero(ok)
    for k, w in enumerate((grad, hess)):
        np.add.at(out, (li, node[li, ri], fi, bins[li, ri, fi], k),
                  w[li, ri].astype(dtype))
    return out


@pytest.mark.parametrize("n,f,n_bins", [(100, 3, 16), (512, 8, 64),
                                        (7, 1, 8)])
def test_plain_version_matches_jax_ref_and_interpret_kernel(n, f, n_bins):
    bins, grad, hess, _ = _hist_inputs(0, 1, n, f, 1, n_bins)
    got = _hist((bins, grad, hess, np.zeros((1, n), np.int32)), 1, n_bins)
    args = (jnp.asarray(bins[0]), jnp.asarray(grad[0]), jnp.asarray(hess[0]))
    want_ref = jax_gbt_hist_ref(*args, n_bins)
    want_int = jgh_ops.build_histograms(*args, n_bins=n_bins,
                                        force="interpret", block_n=64,
                                        block_f=4)
    for want in (want_ref, want_int):
        np.testing.assert_allclose(got[0, 0], np.asarray(want), atol=1e-4,
                                   rtol=0)


@pytest.mark.parametrize("L,n,f,n_nodes,n_bins", [
    (1, 96, 3, 4, 16), (3, 48, 7, 16, 64), (2, 300, 24, 8, 4)])
def test_plain_version_is_float32_add_at_and_near_float64(L, n, f, n_nodes,
                                                          n_bins):
    arrays = _hist_inputs(1, L, n, f, n_nodes, n_bins)
    got = _hist(arrays, n_nodes, n_bins)
    np.testing.assert_array_equal(
        got, _add_at(*arrays, n_nodes, n_bins, np.float32))
    np.testing.assert_allclose(
        got, _add_at(*arrays, n_nodes, n_bins, np.float64), atol=1e-4,
        rtol=0)


@pytest.mark.parametrize("seed", range(4))
def test_plain_version_conserves_mass(seed):
    arrays = _hist_inputs(seed, 2, 37 * (seed + 1), 3, 4, 16)
    total = _hist(arrays, 4, 16).sum(axis=(1, 3))         # (L, f, 2)
    _, grad, hess, _ = arrays
    np.testing.assert_allclose(total[..., 0], np.repeat(
        grad.sum(axis=1, keepdims=True), 3, axis=1), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(total[..., 1], np.repeat(
        hess.sum(axis=1, keepdims=True), 3, axis=1), rtol=1e-4, atol=1e-4)


def test_out_of_range_node_and_bin_ids_add_nothing():
    bins, grad, hess, node = _hist_inputs(2, 2, 200, 5, 4, 8, lo=-2)
    assert (bins < 0).any() and (bins >= 8).any()
    assert (node < 0).any() and (node >= 4).any()
    got = _hist((bins, grad, hess, node), 4, 8)
    np.testing.assert_array_equal(
        got, _add_at(bins, grad, hess, node, 4, 8, np.float32))


def test_kernel_histograms_match_the_reference_helper():
    rng = np.random.default_rng(4)
    bins = rng.integers(0, 16, size=(96, 3)).astype(np.int32)
    grad = rng.normal(size=96)
    hess = np.abs(rng.normal(size=96))
    node = rng.integers(0, 4, size=96)
    got = tgbt.kernel_histograms(bins, grad, hess, node, 4, 16, device="cpu")
    for force in (None, "interpret"):
        np.testing.assert_allclose(got, jgbt.kernel_histograms(
            bins, grad, hess, node, 4, 16, force=force), atol=1e-4, rtol=0)


def test_wrapper_checks_its_inputs():
    bins, grad, hess, node = (torch.from_numpy(a) for a in
                              _hist_inputs(0, 1, 8, 2, 1, 4))
    with pytest.raises(TypeError, match="grad"):
        gh_ops.build_node_histograms(bins, grad.double(), hess, node, 1, 4)
    with pytest.raises(ValueError, match="hess"):
        gh_ops.build_node_histograms(bins, grad, hess[:, :4], node, 1, 4)
    with pytest.raises(ValueError, match="n_nodes"):
        gh_ops.build_node_histograms(bins, grad, hess, node, 0, 4)
    launches = gh_ops.build_node_histograms.launches
    gh_ops.build_node_histograms(bins, grad, hess, node, 1, 4)
    assert gh_ops.build_node_histograms.launches == launches  # CPU: plain


# ------------------------------------------------------------------ GBTs --
@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 10, (150, 5))
    Y = np.stack([X[:, 0] * 3 + X[:, 1], np.sin(X[:, 2]), X[:, 3] ** 2], 1)
    W = (rng.random((4, 150)) < 0.7).astype(np.float64)
    return X, Y, W


def _trees_equal(a, b):
    assert len(a.trees_) == len(b.trees_)
    for ta, tb in zip(a.trees_, b.trees_):
        for k in TREE_FIELDS:
            np.testing.assert_array_equal(getattr(ta, k), getattr(tb, k))
    assert a.base_ == b.base_
    np.testing.assert_array_equal(a.bin_edges_, b.bin_edges_)


@pytest.mark.parametrize("kw", [dict(n_estimators=10, max_depth=4, n_bins=16),
                                dict(n_estimators=6, max_depth=3, n_bins=64,
                                     subsample=0.7, colsample=0.6, seed=3)])
def test_gbt_float64_path_trees_bit_equal(data, kw):
    X, Y, _ = data
    got = tgbt.GBTRegressor(device="cpu", **kw).fit(X, Y[:, 0])
    want = jgbt.GBTRegressor(**kw).fit(X, Y[:, 0])
    _trees_equal(got, want)
    np.testing.assert_array_equal(got.predict(X), want.predict(X))
    conv = gbt_from_reference(want, device="cpu")
    _trees_equal(conv, want)
    np.testing.assert_array_equal(conv.predict(X), want.predict(X))


def test_multi_output_gbt_float64_path_bit_equal(data):
    X, Y, _ = data
    kw = dict(n_estimators=8, max_depth=4, n_bins=32)
    got = tgbt.MultiOutputGBT(3, device="cpu", **kw).fit(X, Y)
    want = jgbt.MultiOutputGBT(3, **kw).fit(X, Y)
    for a, b in zip(got.models, want.models):
        _trees_equal(a, b)
    np.testing.assert_array_equal(got.predict(X), want.predict(X))


def test_packed_forest_float64_path_bit_equal(data):
    X, Y, W = data
    kw = dict(n_estimators=8, max_depth=4, n_bins=16)
    Xc = np.broadcast_to(X[None], (4,) + X.shape)
    Yc = np.broadcast_to(Y[None], (4,) + Y.shape)
    got = tgbt.fit_packed_forest(Xc, Yc, W, device="cpu", **kw)
    want = jgbt.fit_packed_forest(Xc, Yc, W, **kw)
    for k in FOREST_FIELDS:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    np.testing.assert_array_equal(got.predict(Xc, backend="numpy"),
                                  want.predict(Xc, backend="numpy"))


def test_packed_forest_torch_traversal_bit_equal_to_numpy(data):
    X, Y, W = data
    Xc = np.broadcast_to(X[None], (4,) + X.shape)
    forest = jgbt.fit_packed_forest(
        Xc, np.broadcast_to(Y[None], (4,) + Y.shape), W, n_estimators=12,
        max_depth=3, n_bins=32)
    port = packed_forest_from_reference(forest, device="cpu")
    bins = port.transform_bins(Xc)
    np.testing.assert_array_equal(port._apply_torch(bins),
                                  port._apply_numpy(bins))
    np.testing.assert_array_equal(port.predict(Xc, backend="torch"),
                                  forest.predict(Xc, backend="numpy"))


def test_use_kernel_fit_close_to_the_reference_kernel_path():
    """The reference's own bound (``test_sa_engine.py``): rtol 1e-3."""
    rng = np.random.default_rng(5)
    X = rng.uniform(0, 10, size=(200, 4))
    y = X[:, 0] * 3 + X[:, 1]
    kw = dict(n_estimators=8, max_depth=3, n_bins=16)
    got = tgbt.GBTRegressor(use_kernel=True, device="cpu", **kw).fit(X, y)
    want = jgbt.GBTRegressor(use_kernel=True, **kw).fit(X, y)
    np.testing.assert_allclose(got.predict(X), want.predict(X), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(got.predict(X, backend="torch"),
                               want.predict(X, backend="jax"), rtol=1e-3,
                               atol=1e-3)


def test_compacted_and_zero_weighted_rows_grow_the_same_kernel_trees(data):
    """fit_packed_forest's zero-weighted rows against GBTRegressor's
    compacted ones, both through K4's plain version: the same fp32 sums,
    so the same trees bit for bit."""
    X, Y, W = data
    kw = dict(n_estimators=6, max_depth=4, n_bins=16)
    keep = W[1] > 0
    forest = tgbt.fit_packed_forest(X[None], Y[None, :, :1], W[1:2],
                                    use_kernel=True, device="cpu", **kw)
    single = tgbt.GBTRegressor(use_kernel=True, device="cpu", **kw).fit(
        X[keep], Y[keep, 0])
    for t, tree in enumerate(single.trees_):
        nn = len(tree.feature)
        for k in TREE_FIELDS:
            np.testing.assert_array_equal(getattr(forest, k)[0, 0, t, :nn],
                                          getattr(tree, k))


def test_levels_counter_counts_each_tree_level_once(data):
    X, Y, _ = data
    before = tgbt._joint_histograms.levels
    model = tgbt.GBTRegressor(n_estimators=5, max_depth=3, n_bins=16,
                              device="cpu").fit(X, Y[:, 0])
    depth = [_tree_depth(t) for t in model.trees_]
    assert tgbt._joint_histograms.levels - before == sum(d + 1 for d in depth)


def _tree_depth(tree):
    depth = np.zeros(len(tree.feature), int)
    for i, f in enumerate(tree.feature):
        if f >= 0:
            depth[tree.left[i]] = depth[tree.right[i]] = depth[i] + 1
    return int(depth.max())


def test_random_forest_and_linear_regression_match(data):
    X, Y, _ = data
    got = tgbt.RandomForestRegressor(n_estimators=3, max_depth=4,
                                     device="cpu").fit(X, Y[:, 1])
    want = jgbt.RandomForestRegressor(n_estimators=3, max_depth=4).fit(
        X, Y[:, 1])
    np.testing.assert_array_equal(got.predict(X), want.predict(X))
    np.testing.assert_array_equal(
        tgbt.LinearRegression().fit(X, Y[:, 0]).predict(X),
        jgbt.LinearRegression().fit(X, Y[:, 0]).predict(X))


def test_gbt_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgbt.GBTRegressor()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgbt.MultiOutputGBT(3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgbt.fit_packed_forest(np.zeros((1, 4, 2)), np.zeros((1, 4, 1)))
