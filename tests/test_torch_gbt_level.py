"""K4's split step and the forests grown on the device (``grow_forests``),
held to numpy and to the JAX package.

Bit for bit: the split step's plain version against the numpy lines of
the host loop (``core.gbt._grow_forests_host``, one level) on the same
fp32 histograms, and the resident loop against the host loop with K4's
plain histograms (the oracle), through ``fit_packed_forest`` and
``GBTRegressor.fit`` as they dispatch on the card.  Predictions lie within
rtol 1e-3 of the JAX package's ``use_kernel=True`` forests, the
reference's own bound (``tests/test_torch_gbt.py``)."""
import math

import numpy as np
import pytest
import torch

from repro.core import gbt as jgbt

from repro_torch.core import gbt as tgbt
from repro_torch.kernels.gbt_hist import ops as gh_ops
from repro_torch.kernels.gbt_hist.cases import KINDS, level_case, level_state
from repro_torch.kernels.gbt_hist.ref import first_argmax, numpy_sum

LAM, MCW, LR = 1.0, 1.0, 0.1
FOREST_FIELDS = ("feature", "threshold", "left", "right", "value", "n_nodes",
                 "base")
TREE_FIELDS = ("feature", "threshold", "left", "right", "value")


def _numpy_level(hist, bins, node, alive, pred, valid, gid, next_free,
                 depth, max_depth, mcw):
    """One level of ``_grow_forests_host`` (its numpy lines as written
    there) on the fp32 histograms ``hist``; returns the tree entries it
    writes {(l, node id): (feature, threshold, left, right, value)}, and
    the rows' next nodes, alive mask and pred."""
    L, nlvl, f, n_bins, _ = hist.shape
    h = hist.astype(np.float64)
    hist_g, hist_h = h[..., 0], h[..., 1]
    lam = LAM
    out = {}
    Gtot = hist_g.sum(axis=-1)[..., 0]
    Htot = hist_h.sum(axis=-1)[..., 0]
    leaf_val = -Gtot / (Htot + lam)
    V = np.float32(leaf_val)
    if depth == max_depth:
        split = np.zeros_like(valid)
    else:
        GL = np.cumsum(hist_g, axis=-1)
        HL = np.cumsum(hist_h, axis=-1)
        GR = Gtot[..., None, None] - GL
        HR = Htot[..., None, None] - HL
        gain = 0.5 * (GL ** 2 / (HL + lam) + GR ** 2 / (HR + lam)
                      - (Gtot ** 2 / (Htot + lam))[..., None, None])
        ok = (HL >= mcw) & (HR >= mcw)
        ok[..., -1] = False
        gain = np.where(ok, gain, -np.inf)
        flat = gain.reshape(L, nlvl, f * n_bins)
        best = flat.argmax(axis=-1)
        best_gain = np.take_along_axis(flat, best[..., None], axis=-1)[..., 0]
        best_f = (best // n_bins).astype(np.int64)
        best_b = (best % n_bins).astype(np.int64)
        split = valid & np.isfinite(best_gain) & (best_gain > 1e-12)
    for li, lj in zip(*np.nonzero(valid & ~split)):
        out[li, gid[li, lj]] = (-1, 0, 0, 0, V[li, lj])
    k = np.cumsum(split, axis=1)
    base_local = 2 * (k - 1)
    for li, lj in zip(*np.nonzero(split)):
        out[li, gid[li, lj]] = (best_f[li, lj], best_b[li, lj],
                                next_free[li] + base_local[li, lj],
                                next_free[li] + base_local[li, lj] + 1, 0.0)
    nd = np.where(alive, node, 0)
    rsplit = np.take_along_axis(split, nd, axis=1) & alive
    rleaf = alive & ~rsplit
    pred = np.where(rleaf, pred + LR * np.take_along_axis(V, nd, axis=1),
                    pred)
    if depth < max_depth:
        bf = np.take_along_axis(best_f, nd, axis=1)
        bthr = np.take_along_axis(best_b, nd, axis=1)
        rowbin = np.take_along_axis(bins, np.maximum(bf, 0)[..., None],
                                    axis=2)[..., 0]
        nbase = np.take_along_axis(base_local, nd, axis=1)
        nd = np.where(rsplit, nbase + (rowbin > bthr), 0)
    return out, nd, alive & rsplit, pred, 2 * k[:, -1]


def _numpy_case(c, depth, max_depth):
    width = c["hist"].shape[1]
    valid = np.arange(width)[None] < c["n_valid"][:, None]
    return _numpy_level(c["hist"], c["bins"], c["node"], c["in_fit"],
                        c["pred"], valid, c["first"][:, None] + np.arange(width),
                        c["first"] + c["n_valid"], depth, max_depth, c["mcw"])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("width", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("n_bins", [4, 16, 64])
def test_split_step_plain_version_is_numpys_level_bit_for_bit(n_bins, width,
                                                              kind):
    t, depth, max_depth = 1, int(math.log2(width)), 5
    c = level_case(n_bins * 100 + width, 3, width, 5, n_bins, kind)
    s = level_state(c, 2, max_depth, "cpu")
    gh_ops.split_level(torch.from_numpy(c["hist"]), s, t, depth, max_depth,
                       LAM, c["mcw"], LR)
    want, nd, in_fit, pred, n_new = _numpy_case(c, depth, max_depth)
    N = s.value.shape[2]
    got = {(li, g): tuple(getattr(s, k)[li, t, g].item() for k in TREE_FIELDS)
           for li in range(3) for g in range(N)
           if s.feature[li, t, g] >= 0 or s.value[li, t, g] != 0}
    assert got == {key: tuple(float(x) for x in v) for key, v in want.items()
                   if v[0] >= 0 or v[4] != 0}
    for (li, g), v in want.items():   # leaf values' bits, -0.0 included
        assert s.value[li, t, g].numpy().tobytes() == \
            np.float32(v[4]).tobytes()
    np.testing.assert_array_equal(s.node.numpy(), np.where(in_fit, nd, -1))
    np.testing.assert_array_equal(s.pred.numpy(), pred)
    np.testing.assert_array_equal(
        s.level.numpy(), np.stack([c["first"] + c["n_valid"], n_new], 1))
    if kind == "mcw_blocks":
        assert (s.feature < 0).all()
    else:
        assert (s.feature >= 0).any()


def test_split_step_last_level_starts_the_next_tree():
    c = level_case(7, 2, 16, 3, 16)
    s = level_state(c, 1, 4, "cpu")
    gh_ops.split_level(torch.from_numpy(c["hist"]), s, 0, 4, 4, LAM, MCW, LR)
    _, _, _, pred, _ = _numpy_case(c, 4, 4)
    np.testing.assert_array_equal(s.pred.numpy(), pred)
    np.testing.assert_array_equal(s.n_nodes[:, 0].numpy(),
                                  np.minimum(c["first"] + c["n_valid"], 31))
    np.testing.assert_array_equal(s.node.numpy(),
                                  np.where(c["in_fit"], 0, -1))
    np.testing.assert_array_equal(
        s.grad.numpy(), ((pred - c["y"]) * c["in_fit"]).astype(np.float32))
    np.testing.assert_array_equal(s.level.numpy(), [[0, 1], [0, 1]])
    assert (s.feature < 0).all()


@pytest.mark.parametrize("n", [1, 5, 7, 8, 9, 16, 23, 64, 100, 127, 128])
def test_numpy_sum_is_numpys_pairwise_order(n):
    rng = np.random.default_rng(n)
    a = (rng.standard_normal((500, n))
         * np.exp2(rng.uniform(-40, 40, (500, n)))).astype(np.float32)
    want = a.astype(np.float64).sum(axis=-1)
    got = numpy_sum(torch.from_numpy(a).double()).numpy()
    assert got.tobytes() == want.tobytes()
    if n >= 16:   # where numpy's order matters: a plain loop differs
        seq = np.zeros(500)
        for i in range(n):
            seq = seq + a[:, i].astype(np.float64)
        assert (seq != want).any()


def test_first_argmax_is_numpys():
    x = np.array([[1.0, 3.0, 3.0, -np.inf], [-np.inf] * 4,
                  [2.0, np.nan, 5.0, np.nan], [0.0, -0.0, 0.0, -1.0],
                  [np.inf, 1.0, np.inf, np.nan]])
    np.testing.assert_array_equal(first_argmax(torch.from_numpy(x)).numpy(),
                                  x.argmax(axis=-1))


def test_split_level_checks_its_inputs():
    c = level_case(1, 1, 4, 3, 16)
    s = level_state(c, 2, 4, "cpu")
    h = torch.from_numpy(c["hist"])
    with pytest.raises(ValueError, match="hist"):
        gh_ops.split_level(h[:, :2], s, 0, 2, 4, LAM, MCW, LR)
    with pytest.raises(ValueError, match="hist"):
        gh_ops.split_level(h.double(), s, 0, 2, 4, LAM, MCW, LR)
    with pytest.raises(ValueError, match="tree"):
        gh_ops.split_level(h, s, 2, 2, 4, LAM, MCW, LR)
    with pytest.raises(ValueError, match="max_depth"):
        gh_ops.split_level(h, s, 0, 2, 3, LAM, MCW, LR)
    wide = torch.zeros((1, 4, 3, 200, 2))
    with pytest.raises(ValueError, match="n_bins"):
        gh_ops.split_level(wide, s, 0, 2, 4, LAM, MCW, LR)
    with pytest.raises(ValueError, match="GrowState.pred"):
        gh_ops.GrowState(**{**{k: getattr(s, k) for k in s.__dataclass_fields__},
                            "pred": s.pred.float()})
    launches = gh_ops.split_level.launches
    gh_ops.split_level(h, s, 0, 2, 4, LAM, MCW, LR)
    assert gh_ops.split_level.launches == launches   # CPU: plain version


def test_histograms_into_out():
    rng = np.random.default_rng(3)
    bins = torch.from_numpy(rng.integers(0, 8, (2, 40, 3)).astype(np.int32))
    grad = torch.from_numpy(rng.standard_normal((2, 40)).astype(np.float32))
    hess = torch.ones((2, 40))
    node = torch.from_numpy(rng.integers(0, 4, (2, 40)).astype(np.int32))
    out = torch.full((2, 4, 3, 8, 2), math.nan)
    got = gh_ops.build_node_histograms(bins, grad, hess, node, 4, 8, out=out)
    assert got is out
    assert torch.equal(out, gh_ops.build_node_histograms(bins, grad, hess,
                                                         node, 4, 8))
    with pytest.raises(ValueError, match="out"):
        gh_ops.build_node_histograms(bins, grad, hess, node, 4, 8,
                                     out=out[:, :2])


# -------------------------------------------------- the resident loop --
@pytest.fixture
def resident(monkeypatch):
    """The dispatch the card takes, on CPU tensors: fits grow their trees
    through ``grow_forests`` and the kernels' plain versions."""
    monkeypatch.setattr(tgbt, "_resident_on", lambda *a: True)


def _data(seed, C, n, f, O):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 10, (C, n, f))
    Y = np.stack([X[..., 0] * 3 + X[..., 1], np.sin(X[..., 2]),
                  X[..., 1] ** 2][:O], -1) + rng.normal(0, 0.1, (C, n, O))
    W = (rng.random((C, n)) < 0.7).astype(np.float64)
    return X, Y, W


@pytest.mark.parametrize("max_depth", [1, 2, 3, 4])
@pytest.mark.parametrize("C,O,n_bins", [(1, 1, 16), (5, 3, 64)])
def test_resident_forests_are_the_host_loops(monkeypatch, C, O, n_bins,
                                             max_depth):
    """L 1 and L 15: fit_packed_forest on CPU tensors through the resident
    loop against its host loop over K4's plain histograms."""
    X, Y, W = _data(max_depth, C, 48, 5, O)
    kw = dict(n_estimators=4, max_depth=max_depth, n_bins=n_bins,
              use_kernel=True, device="cpu")
    want = tgbt.fit_packed_forest(X, Y, W, **kw)
    levels = tgbt.grow_forests.levels
    monkeypatch.setattr(tgbt, "_resident_on", lambda *a: True)
    got = tgbt.fit_packed_forest(X, Y, W, **kw)
    assert tgbt.grow_forests.levels - levels == 4 * (max_depth + 1)
    for k in FOREST_FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert (want.n_nodes > 1).any()


@pytest.mark.parametrize("max_depth", [1, 2, 3, 4])
@pytest.mark.parametrize("n_bins", [4, 64])
def test_resident_gbt_regressor_is_the_host_loops(monkeypatch, n_bins,
                                                   max_depth):
    X, Y, _ = _data(10 + max_depth, 1, 125, 6, 1)
    kw = dict(n_estimators=5, max_depth=max_depth, n_bins=n_bins,
              learning_rate=0.05, use_kernel=True, device="cpu")
    want = tgbt.GBTRegressor(**kw).fit(X[0], Y[0, :, 0])
    monkeypatch.setattr(tgbt, "_resident_on", lambda *a: True)
    got = tgbt.GBTRegressor(**kw).fit(X[0], Y[0, :, 0])
    assert len(got.trees_) == len(want.trees_) == 5
    for a, b in zip(got.trees_, want.trees_):
        for k in TREE_FIELDS:
            x, z = getattr(a, k), getattr(b, k)
            assert x.dtype == z.dtype and np.array_equal(x, z), k
    assert got.base_ == want.base_
    np.testing.assert_array_equal(got.predict(X[0]), want.predict(X[0]))


def test_resident_forest_predictions_near_the_jax_packages(resident):
    X, Y, W = _data(20, 1, 100, 4, 2)
    kw = dict(n_estimators=4, max_depth=3, n_bins=16)
    got = tgbt.fit_packed_forest(X, Y, W, use_kernel=True, device="cpu", **kw)
    want = jgbt.fit_packed_forest(X, Y, W, use_kernel=True, **kw)
    np.testing.assert_allclose(got.predict(X, backend="numpy"),
                               want.predict(X, backend="numpy"), rtol=1e-3,
                               atol=1e-3)


def test_resident_gbt_predictions_near_the_jax_packages(resident):
    X, Y, _ = _data(21, 1, 120, 4, 1)
    kw = dict(n_estimators=6, max_depth=3, n_bins=16)
    got = tgbt.GBTRegressor(use_kernel=True, device="cpu", **kw).fit(
        X[0], Y[0, :, 0])
    want = jgbt.GBTRegressor(use_kernel=True, **kw).fit(X[0], Y[0, :, 0])
    np.testing.assert_allclose(got.predict(X[0]), want.predict(X[0]),
                               rtol=1e-3, atol=1e-3)


def test_only_cuda_fits_grow_on_the_device():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tgbt._resident_on(None, cuda, 64, 4)
    assert tgbt._resident_on(True, cuda, 128, 8)
    assert not tgbt._resident_on(None, cpu, 64, 4)
    assert not tgbt._resident_on(True, cpu, 64, 4)
    assert not tgbt._resident_on(False, cuda, 64, 4)
    assert not tgbt._resident_on(None, cuda, 129, 4)
    assert not tgbt._resident_on(None, cuda, 64, 9)
