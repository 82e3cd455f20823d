"""Alg 4, the port's ``ModelRegistry(device="cpu")`` against the JAX
package's, on ``suite.npz``'s 33 combinations and on the synthetic
cross-hardware rows of ``test_hardware_transfer.py``.

Tolerances, as measured on ``suite`` (20 trees a forest):

- Databases: the same combinations and (ii, oo) keys, and each group's
  curve at its own batch sizes held by ``fit.lm_agreement``: within 1e-3
  relative (the LM contract of ``test_torch_fit.py``) at every group
  whose reference fit has converged, that is lies within 1e-4 of the
  float64 optimum (``fit.lm_optimum``; 395 of the 462 training groups).
  At the others the float32 LM has not converged in its 60 steps and the
  two fits stop at different points of a flat valley, equally good: 36
  lie between 1e-3 and 1.16e-2, with sums of squared residuals within
  1.8% of each other, either side lower.  Such a group must stay within
  2e-2 with its sum of squares within 2.5%, and fewer than a tenth of
  all groups may lie beyond 1e-3.  Measured: converged groups at most
  5.6e-4 apart.  The same comparison refuses an LM run in bfloat16 (393
  converged groups beyond 1e-3) or cut to 20 steps (2 converged groups
  beyond 1e-3, 26 others beyond 2e-2); it cannot tell 40 steps from 60.
- Predictors trained on the reference's databases
  (``weights.registry_from_reference``): bit-equal predictions.
- Held-out medAPE over all combinations, with the (ii, oo) groups
  (512, 1024) and (2048, 128) held out: 25.71% against 25.79% (0.074
  points).  Bound: 0.5 points.  One combination alone can differ far
  more: Alg 3's trees, fitted on 14 database rows, turn the LM's float32
  differences into held-out predictions up to 66% apart (ROADMAP queue C).
- The batched fit against one fit per combination: bit for bit.
- Transfer, given the reference's fitted state: the predicted error bit
  for bit, ``d_min`` and confidence within 1e-6 (the reference's
  serial-vs-batched contract)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.annealing import SAConfig as JaxSAConfig
from repro.core.dataset import Dataset as JaxDataset
from repro.core.registry import ModelRegistry as JaxRegistry

from repro_torch.core import fit as tfit
from repro_torch.core.annealing import SAConfig, median_ape
from repro_torch.core.database import exponential_groups
from repro_torch.core.dataset import Dataset
from repro_torch.core.expmodel import exp_model
from repro_torch.core.predictor import train_param_predictors
from repro_torch.core.registry import ModelRegistry
from repro_torch.perfmodel.hardware import (PROFILES, feature_names,
                                            feature_row)
from repro_torch.weights import registry_from_reference

N_EST = 20
FLAT_SSE = 0.025        # unconverged groups: equally good fits
MEDAPE_TOL = 0.5        # pooled held-out medAPE, points (measured 0.074)
HELD_OUT = ((512.0, 1024.0), (2048.0, 128.0))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensor ops: one intra-op thread keeps parallel test workers
    from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def suite():
    return Dataset.load("results/data/suite")


def _ref(ds: Dataset) -> JaxDataset:
    return JaxDataset(dict(ds.cols))


def _held_out(ds: Dataset):
    ii, oo = ds["ii"], ds["oo"]
    return np.any([(ii == a) & (oo == o) for a, o in HELD_OUT], axis=0)


@pytest.fixture(scope="module")
def fitted(suite):
    train = suite.mask(~_held_out(suite))
    tfit._solve_padded.solves = 0
    port = ModelRegistry(device="cpu").fit(train, n_estimators=N_EST)
    solves = tfit._solve_padded.solves
    ref = JaxRegistry().fit(_ref(train), n_estimators=N_EST)
    return port, ref, train, solves


def _rows_of(ds: Dataset, keys, combo) -> Dataset:
    arr = np.stack([ds[k].astype(str) for k in keys], axis=1)
    return ds.mask(np.all(arr == np.asarray(combo), axis=1))


def _lm_fits(port, ref, train):
    """Every training group of every combination, with the port's and the
    reference's fits and the float64 optimum."""
    groups, got, want = [], [], []
    for combo, cm in port.combos.items():
        rows = _rows_of(train, port._active_keys, combo).workload
        _, _, gs = exponential_groups(*rows)
        keys = list(ref.combos[combo].db.params)
        assert len(gs) == len(keys)
        groups += gs
        got += [cm.db.params[k] for k in keys]
        want += [ref.combos[combo].db.params[k] for k in keys]
    # 16 groups of at most 21 rows in every combination: rows padded to 32
    return groups, np.array(got), np.array(want), tfit.lm_optimum(groups, 32)


@pytest.fixture(scope="module")
def lm(fitted):
    return _lm_fits(*fitted[:3])


def test_databases_match_the_reference(fitted, lm):
    port, ref, train, solves = fitted
    assert list(port.combos) == list(ref.combos) and len(port.combos) == 33
    assert port._active_keys == ref._active_keys
    assert solves == 1          # one padding class
    for combo, cm in port.combos.items():
        assert list(cm.db.params) == list(ref.combos[combo].db.params)
    groups, got, want, opt = lm
    agree = tfit.lm_agreement(groups, got, want, opt)
    assert agree["ok"], {k: v for k, v in agree.items()
                         if k not in ("rel", "is_converged")}
    for i in np.nonzero(agree["rel"] > 1e-3)[0]:
        bb, thpt, _ = groups[i]
        sse = [np.sum((exp_model(bb, *th) - thpt) ** 2)
               for th in (got[i], want[i])]
        assert abs(sse[0] / sse[1] - 1.0) <= FLAT_SSE, (i, sse)


@pytest.mark.parametrize("wrong", [dict(dtype=torch.bfloat16),
                                   dict(iters=20)],
                         ids=["bf16", "20-steps"])
def test_database_comparison_refuses_a_wrong_lm(lm, wrong):
    """The control: the same comparison fails an LM run in bfloat16 or
    cut to a third of its steps."""
    groups, _, want, opt = lm
    bad = tfit.fit_exponential_groups(groups, pad_to=32, device="cpu",
                                      **wrong)
    assert not tfit.lm_agreement(groups, bad, want, opt)["ok"]


def test_predictors_on_the_reference_databases_are_bit_equal(fitted, suite):
    port, ref, _, _ = fitted
    conv = registry_from_reference(ref, device="cpu")
    preds = train_param_predictors(
        [cm.db.training for cm in conv.combos.values()], device="cpu",
        n_estimators=N_EST)
    for cm, pred in zip(conv.combos.values(), preds):
        cm.predictor = pred
    # every row, the held-out (ii, oo) groups (predictor misses) included
    np.testing.assert_array_equal(conv.predict(suite),
                                  ref.predict(_ref(suite)))


def test_held_out_medape_matches_within_measured_tolerance(fitted, suite):
    port, ref, _, _ = fitted
    test = suite.mask(_held_out(suite))
    got = median_ape(test["thpt"], port.predict(test))
    want = median_ape(test["thpt"], ref.predict(_ref(test)))
    assert abs(got - want) <= MEDAPE_TOL


def test_batched_fit_is_one_fit_per_combination_bit_for_bit(fitted, suite):
    port, _, train, _ = fitted
    probe = suite.mask(_held_out(suite))
    for combo, cm in port.combos.items():
        alone = ModelRegistry(device="cpu").fit(
            _rows_of(train, port._active_keys, combo), n_estimators=N_EST)
        one = alone.combos[combo]
        np.testing.assert_array_equal(one.db.training, cm.db.training)
        rows = _rows_of(probe, port._active_keys, combo)
        np.testing.assert_array_equal(alone.predict(rows), port.predict(rows))


def test_batched_fit_grows_every_combination_in_one_resident_loop(
        monkeypatch, suite):
    """The card's path run on CPU tensors (``grow_forests`` forced on, as
    ``test_torch_gbt_level.py`` does): one LM solve and one
    ``grow_forests`` of n_estimators x (max_depth + 1) levels for all
    combinations, no host loop, and the trees of the host loop over K4's
    plain histograms, bit for bit."""
    from repro_torch.core import gbt
    some = suite.mask(np.isin(suite["model"], ["llama3.2-3b", "qwen3-0.6b"]))
    data, probe = some.mask(~_held_out(some)), some.mask(_held_out(some))
    host = ModelRegistry(device="cpu").fit(data, n_estimators=6,
                                           use_kernel=True)
    monkeypatch.setattr(gbt, "_resident_on", lambda *a: True)
    counts = (tfit._solve_padded.solves, gbt.grow_forests.levels,
              gbt._joint_histograms.levels)
    reg = ModelRegistry(device="cpu").fit(data, n_estimators=6,
                                          use_kernel=True)
    assert len(reg.combos) > 1
    assert (tfit._solve_padded.solves - counts[0],
            gbt.grow_forests.levels - counts[1],
            gbt._joint_histograms.levels - counts[2]) == (1, 6 * 5, 0)
    np.testing.assert_array_equal(reg.predict(probe), host.predict(probe))


def test_registry_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelRegistry()


# ------------------------------------------- refit, update_combo, stale fits
KEY_COLS = dict(acc="tpu-v5e", acc_count=4, back="sim-trace", prec="bf16",
                mode="serve")


def _ds(model, n, seed, iis=(128, 256, 512, 1024)):
    r = np.random.default_rng(seed)
    ii = r.choice(iis, n)
    oo = r.choice([64, 128, 256], n)
    bb = r.choice([1, 2, 4, 8, 16, 32, 64], n)
    thpt = (5000 * (1 - np.exp(-0.05 * bb)) * (512 / ii) ** 0.3
            * r.lognormal(0, 0.03, n))
    return Dataset.from_rows([dict(model=model, **KEY_COLS, ii=int(a),
                                   oo=int(b), bb=int(c), thpt=float(t))
                              for a, b, c, t in zip(ii, oo, bb, thpt)])


def test_full_fit_drops_stale_combos():
    reg = ModelRegistry(device="cpu").fit(
        _ds("m-a", 30, 1).concat(_ds("m-b", 30, 2)), n_estimators=10)
    assert len(reg.combos) == 2
    first = next(iter(reg.combos))
    reg.combos[first] = dataclasses.replace(reg.combos[first], ala=object())
    reg.fit(_ds("m-a", 30, 3), n_estimators=10)
    assert len(reg.combos) == 1
    assert next(iter(reg.combos))[0] == "m-a"
    assert next(iter(reg.combos.values())).ala is None


def test_refit_updates_only_targets_and_checks_keys():
    both = _ds("m-a", 30, 1).concat(_ds("m-b", 30, 2))
    reg = ModelRegistry(device="cpu").fit(both, n_estimators=10)
    combo_a = next(c for c in reg.combos if c[0] == "m-a")
    combo_b = next(c for c in reg.combos if c[0] == "m-b")
    reg.attach_ala(combo_b, object())
    kept = reg.combos[combo_b]
    reg.refit(_ds("m-a", 45, 4), combos=[combo_a], n_estimators=10)
    assert reg.combos[combo_b] is kept
    assert reg.combos[combo_a].ala is None
    pred = reg.predict(both)
    assert np.isfinite(pred).all() and (pred > 0).all()
    with pytest.raises(ValueError, match="no rows"):
        reg.refit(_ds("m-a", 10, 2), combos=[("m-zzz",) * 6])
    missing_keys = Dataset({k: _ds("m-a", 10, 3)[k]
                            for k in ("ii", "oo", "bb", "thpt", "model")})
    with pytest.raises(ValueError, match="key columns"):
        reg.refit(missing_keys)
    with pytest.raises(KeyError, match="unknown combination"):
        reg.attach_ala(("m-zzz",) * 6, object())


def test_update_combo_is_a_full_fit_bit_for_bit():
    """Append-only update of one combination == a from-scratch fit: the
    delta's groups re-solve at the full fit's padding, the rest are kept."""
    d0, d1 = _ds("m-a", 40, 1), _ds("m-a", 12, 2, iis=(64, 256))
    full = d0.concat(d1)
    reg = ModelRegistry(device="cpu").fit(d0, n_estimators=10)
    combo = next(iter(reg.combos))
    reg.update_combo(combo, full.workload, n_delta=len(d1), n_estimators=10)
    scratch = ModelRegistry(device="cpu").fit(full, n_estimators=10)
    np.testing.assert_array_equal(reg.predict(full), scratch.predict(full))
    with pytest.raises(KeyError, match="unknown combination"):
        reg.update_combo(("m-zzz",) * 6, full.workload, n_delta=1)


# ------------------------------------------------ cross-hardware transfer
def _grid_rows(acc: str, cap: float, rng) -> list:
    """Saturating-throughput rows on one accelerator with its descriptor
    columns, as ``test_hardware_transfer.py`` makes them."""
    hw_cols = feature_row(acc) if acc in PROFILES else {
        k: 0.0 for k in feature_names()}
    bbs = np.array([1, 2, 4, 8, 16, 32, 64], float)
    rows = []
    for ii in (128.0, 512.0):
        for oo in (128.0, 256.0):
            for bb, t in zip(bbs, exp_model(bbs, 0.9 * cap, 0.08, cap)):
                rows.append(dict(model="m", acc=acc, acc_count=4, back="f",
                                 prec="bf16", mode="serve", ii=ii, oo=oo,
                                 bb=bb, thpt=t * rng.normal(1.0, 0.01),
                                 **hw_cols))
    return rows


def _relabel(src: Dataset, acc: str) -> Dataset:
    cols = dict(src.cols)
    cols["acc"] = np.full(len(src), acc)
    hw = (feature_row(acc) if acc in PROFILES
          else {k: 0.0 for k in feature_names()})
    for k, v in hw.items():
        cols[k] = np.full(len(src), v)
    return Dataset(cols)


SA_SMALL = dict(n_iters=3, seed=0, n_chains=2, gbt_kw=dict(n_estimators=15))


@pytest.fixture(scope="module")
def transfer():
    src = Dataset.from_rows(_grid_rows("tpu-v5e", 4000.0,
                                       np.random.default_rng(0)))
    port = ModelRegistry(device="cpu").fit(src, n_estimators=20)
    port.fit_uncertainty(src, sa_cfg=SAConfig(**SA_SMALL), n_estimators=15)
    ref = JaxRegistry().fit(_ref(src), n_estimators=20)
    ref.fit_uncertainty(_ref(src), sa_cfg=JaxSAConfig(**SA_SMALL),
                        n_estimators=15)
    return port, ref, src


def test_donor_is_nearest_fitted_hardware(transfer):
    _, _, src = transfer
    far = Dataset.from_rows(_grid_rows("gpu-l4", 900.0,
                                       np.random.default_rng(1)))
    reg = ModelRegistry(device="cpu").fit(src.concat(far), n_estimators=20)
    hi = reg._active_keys.index("acc")
    v5e = next(c for c in reg.combos if c[hi] == "tpu-v5e")
    l4 = next(c for c in reg.combos if c[hi] == "gpu-l4")
    assert reg.donor_for(v5e[:hi] + ("tpu-v4",) + v5e[hi + 1:]) == v5e
    assert reg.donor_for(l4[:hi] + ("gpu-a100-80g",) + l4[hi + 1:]) == v5e
    assert reg.donor_for(v5e[:hi] + ("martian-npu",) + v5e[hi + 1:]) is None


def test_transfer_confidence_strictly_below_native(transfer):
    port, _, src = transfer
    _, native_d, native_conf = port.estimate(src)
    assert np.isfinite(native_conf).all() and (native_conf > 0).all()
    moved = _relabel(src, "tpu-v4")
    err0, d0, c0 = port.estimate(moved)
    assert np.isnan(err0).all() and np.isinf(d0).all() and (c0 == 0).all()
    err, d, conf = port.estimate(moved, transfer=True)
    assert np.isfinite(conf).all() and (conf > 0).all()
    assert (conf < native_conf).all()
    np.testing.assert_allclose(d, native_d)
    numpy_path = port.estimate(moved, backend="numpy", transfer=True)
    np.testing.assert_allclose(numpy_path[2], conf, rtol=0, atol=1e-6)


def test_transfer_unknown_hardware_keeps_sentinel(transfer):
    port, _, src = transfer
    err, d, conf = port.estimate(_relabel(src, "martian-npu"), transfer=True)
    assert np.isnan(err).all() and np.isinf(d).all() and (conf == 0).all()


def test_transfer_predict_applies_scale_fn(transfer):
    port, _, src = transfer
    moved = _relabel(src, "tpu-v4")
    hi = port._active_keys.index("acc")
    raw = port.predict(moved, transfer=True)
    assert (raw > 0).all()

    def scale(combo, donor, ii, oo, bb):
        assert combo[hi] == "tpu-v4" and donor[hi] == "tpu-v5e"
        return 1.5

    np.testing.assert_allclose(port.predict(moved, transfer=True,
                                            scale_fn=scale), raw * 1.5)


def test_transfer_given_the_reference_state_matches_it(transfer):
    _, ref, src = transfer
    conv = registry_from_reference(ref, device="cpu")
    for acc in ("tpu-v5e", "tpu-v4", "gpu-a100-80g", "martian-npu"):
        moved = _relabel(src, acc)
        np.testing.assert_array_equal(
            conv.predict(moved, transfer=True),
            ref.predict(_ref(moved), transfer=True))
        got = conv.estimate(moved, transfer=True)
        want = ref.estimate(_ref(moved), transfer=True)
        np.testing.assert_array_equal(got[0], want[0])
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def measure(n_estimators: int = N_EST) -> dict:
    """The numbers this file's tolerances come from: the port's registry
    against the reference's on ``suite`` with the groups ``HELD_OUT``
    held out, and the database comparison applied to wrong LMs
    (``python tests/test_torch_registry.py [n_estimators]``)."""
    suite = Dataset.load("results/data/suite")
    train, test = suite.mask(~_held_out(suite)), suite.mask(_held_out(suite))
    port = ModelRegistry(device="cpu").fit(train, n_estimators=n_estimators)
    ref = JaxRegistry().fit(_ref(train), n_estimators=n_estimators)
    groups, got, want, opt = _lm_fits(port, ref, train)
    agree = tfit.lm_agreement(groups, got, want, opt)
    flat = np.nonzero(agree["rel"] > 1e-3)[0]
    sse = [np.sum((exp_model(groups[i][0], *got[i]) - groups[i][1]) ** 2)
           / np.sum((exp_model(groups[i][0], *want[i]) - groups[i][1]) ** 2)
           for i in flat]
    controls = {}
    for name, wrong in (("bf16", dict(dtype=torch.bfloat16)),
                        *((f"{n} steps", dict(iters=n))
                          for n in (10, 20, 30, 40))):
        bad = tfit.fit_exponential_groups(groups, pad_to=32, device="cpu",
                                          **wrong)
        a = tfit.lm_agreement(groups, bad, want, opt)
        conv = a["is_converged"]
        controls[name] = dict(
            ok=a["ok"], converged_beyond_1e3=int(
                (a["rel"][conv] > 1e-3).sum()),
            unconverged_beyond_2e2=int((a["rel"][~conv] > 2e-2).sum()),
            beyond_1e3=a["beyond"], worst=a["worst"])
    p, q = port.predict(test), ref.predict(_ref(test))
    per_combo = [abs(median_ape(test["thpt"][m], p[m])
                     - median_ape(test["thpt"][m], q[m]))
                 for m in (np.all(np.stack([test[k].astype(str) for k in
                                            port._active_keys], 1)
                                  == np.asarray(c), 1) for c in port.combos)]
    return dict(groups=agree["n"], converged=agree["converged"],
                worst_converged=agree["worst_converged"],
                beyond_1e3=agree["beyond"], max_curve_rel=agree["worst"],
                max_sse_change=float(np.abs(np.array(sse) - 1).max()),
                controls=controls,
                medape_port=median_ape(test["thpt"], p),
                medape_ref=median_ape(test["thpt"], q),
                max_pred_rel=float(np.max(np.abs(p - q) / np.abs(q))),
                max_combo_medape_diff=float(max(per_combo)))


if __name__ == "__main__":
    import sys
    torch.set_num_threads(1)
    print(measure(int(sys.argv[1]) if len(sys.argv) > 1 else N_EST))
