"""The port's ``OnlineALA(device="cpu")`` against the JAX package's: the
parity, drift, gate and ``min_rows`` cases of ``test_online_engine.py``,
each delta fed to both engines.

Three engines take every delta: the port's and the reference's, each with
its own history, and a port engine converted from the reference's state
just before the ingest (``weights.online_from_reference``).  Tolerances:

- The decisions, on both port engines: the same changed, refit and
  skipped lists, quarantine count, drifted flags and reasons, and
  generations as the reference's.
- The drift signal's numbers, given the reference's state: the predicted
  error and the residual medAPE bit for bit, the confidence within 1e-6
  (the reference's serial-vs-batched contract).  The engines' own SA
  trajectories are never compared (``test_torch_ala.py``).
- Predictions at every row the registry was fitted on, each a database
  hit, on the port's own engine after a case's last ingest: the LM contract of
  ``test_torch_registry.py`` (``fit.lm_agreement``), 1e-3 relative where
  the reference's fit of the row's (ii, oo) group has converged and 2e-2
  where it has not.
- Where the reference holds the incremental serving path to a
  from-scratch registry within 1e-6, the port holds it bit for bit: every
  refit gives a combination the database and predictor a fit of its rows
  alone gives."""
import numpy as np
import pytest
import torch

from repro.core.annealing import SAConfig as JaxSAConfig
from repro.core.dataset import Dataset as JaxDataset
from repro.core.online import OnlineALA as JaxOnlineALA
from repro.core.online import OnlineConfig as JaxOnlineConfig
from repro.serving.faults import FaultConfig, injector

from repro_torch.core import fit as tfit
from repro_torch.core.annealing import SAConfig
from repro_torch.core.database import exponential_groups
from repro_torch.core.dataset import Dataset
from repro_torch.core.online import OnlineALA, OnlineConfig
from repro_torch.core.registry import ModelRegistry
from repro_torch.weights import online_from_reference

KEY_COLS = dict(acc="tpu-v5e", acc_count=4, back="sim-trace", prec="bf16",
                mode="serve")
SA_SMALL = dict(n_iters=4, n_chains=2, seed=0,
                gbt_kw=dict(n_estimators=15, learning_rate=0.2, max_depth=3))
CONF_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensor ops: one intra-op thread keeps parallel test workers
    from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rows(model, n, seed, scale=1.0, iis=(128, 256, 512, 1024)):
    r = np.random.default_rng(seed)
    ii = r.choice(iis, n)
    oo = r.choice([64, 128, 256], n)
    bb = r.choice([1, 2, 4, 8, 16, 32, 64], n)
    thpt = (scale * 5000 * (1 - np.exp(-0.05 * bb)) * (512 / ii) ** 0.3
            * r.lognormal(0, 0.03, n))
    return [dict(model=model, **KEY_COLS, ii=int(a), oo=int(b), bb=int(c),
                 thpt=float(t))
            for a, b, c, t in zip(ii, oo, bb, thpt)]


def _ds(model, n, seed, **kw):
    return Dataset.from_rows(_rows(model, n, seed, **kw))


def _small_cfg(warm_iters=3, **kw):
    sa = SAConfig(**SA_SMALL)
    return OnlineConfig(sa=sa, warm_iters=warm_iters,
                        gbt_kw=dict(sa.gbt_kw), **kw)


def _engine(**kw):
    return OnlineALA(_small_cfg(**kw), device="cpu")


class Pair:
    """The port's engine and the reference's, configured alike; ``ingest``
    feeds both, and a port engine converted from the reference's state,
    the same rows, and holds them together."""

    def __init__(self, warm_iters=3, **kw):
        self.port = _engine(warm_iters=warm_iters, **kw)
        self.ref = JaxOnlineALA(JaxOnlineConfig(
            sa=JaxSAConfig(**SA_SMALL), warm_iters=warm_iters,
            gbt_kw=dict(SA_SMALL["gbt_kw"]), **kw))

    def ingest(self, rows, **from_rows):
        shared = online_from_reference(self.ref, device="cpu")
        rep = self.port.ingest(Dataset.from_rows(rows, **from_rows),
                               n_estimators=10)
        srep = shared.ingest(Dataset.from_rows(rows, **from_rows),
                             n_estimators=10)
        want = self.ref.ingest(JaxDataset.from_rows(rows, **from_rows),
                               n_estimators=10)
        for got, eng in ((rep, self.port), (srep, shared)):
            assert (got.changed, got.refit, got.skipped,
                    got.n_quarantined) == (want.changed, want.refit,
                                           want.skipped, want.n_quarantined)
            assert {c: (d.n_rows, d.drifted, d.reason)
                    for c, d in got.drift.items()} == \
                {c: (d.n_rows, d.drifted, d.reason)
                 for c, d in want.drift.items()}
            assert [eng.generation_of(c) for c in self.ref.combos] == \
                [self.ref.generation_of(c) for c in self.ref.combos]
        for c, d in srep.drift.items():
            w = want.drift[c]
            np.testing.assert_array_equal([d.pred_err, d.resid_ape],
                                          [w.pred_err, w.resid_ape])
            np.testing.assert_allclose(d.confidence, w.confidence, rtol=0,
                                       atol=CONF_TOL)
        return rep

    def hold_predictions(self):
        """The port's predictions at every row its registry was fitted on
        against the reference's, by the LM contract (once a case, after
        its last ingest: the float64 optimum takes about half a second)."""
        groups, got, want, where, n_rows = [], [], [], [], 0
        for combo in self.ref.combos:
            st, ref_st = self.port._state[combo], self.ref._state[combo]
            assert st.fitted_rows == ref_st.fitted_rows
            rows = st.data[np.arange(st.fitted_rows)]
            uniq, kept, gs = exponential_groups(*rows.workload)
            keys = [tuple(map(float, uniq[g])) for g in kept]
            pdb = self.port.registry.combos[combo].db
            rdb = self.ref.registry.combos[combo].db
            assert list(pdb.params) == list(rdb.params) == keys
            groups += gs
            got += [pdb.params[k] for k in keys]
            want += [rdb.params[k] for k in keys]
            where.append((rows, len(groups) - len(gs), keys))
            n_rows += len(rows)
        agree = tfit.lm_agreement(groups, np.array(got), np.array(want),
                                  tfit.lm_optimum(groups), share=None)
        assert agree["ok"], {k: v for k, v in agree.items()
                             if k not in ("rel", "is_converged")}
        for rows, first, keys in where:
            p = self.port.predict(rows)
            q = self.ref.predict(JaxDataset(dict(rows.cols)))
            group = first + np.array([keys.index((float(a), float(b)))
                                      for a, b in zip(rows["ii"],
                                                      rows["oo"])])
            tol = np.where(agree["is_converged"][group], 1e-3, 2e-2)
            assert np.all(np.abs(p - q) <= tol * np.abs(q))


def _scratch(full):
    return ModelRegistry(device="cpu").fit(full, n_estimators=10)


def test_online_parity_and_selective_refit():
    pair = Pair()
    eng = pair.port
    pair.ingest(_rows("m-a", 40, 1) + _rows("m-b", 40, 2))
    combo_a = next(c for c in eng.combos if c[0] == "m-a")
    combo_b = next(c for c in eng.combos if c[0] == "m-b")
    full = eng.full_data()
    np.testing.assert_array_equal(eng.predict(full),
                                  _scratch(full).predict(full))
    ala_b = eng.ala_for(combo_b)
    rep = pair.ingest(_rows("m-a", 20, 3))
    assert rep.changed == [combo_a] and rep.refit == [combo_a]
    assert eng.ala_for(combo_b) is ala_b
    full = eng.full_data()
    np.testing.assert_array_equal(eng.predict(full),
                                  _scratch(full).predict(full))
    err, d, conf = eng.estimate(full, backend="numpy")
    assert np.isfinite(err).all() and (conf > 0).all()
    np.testing.assert_allclose(eng.estimate(full)[2], conf, rtol=0,
                               atol=1e-6)
    pair.hold_predictions()


def test_online_drift_detection_and_policy():
    pair = Pair(refit="drift", drift_err_ratio=2.0)
    pair.ingest(_rows("m-a", 50, 1))
    combo = pair.port.combos[0]
    rep = pair.ingest(_rows("m-a", 15, 2))
    assert not rep.drift[combo].drifted
    assert rep.refit == [] and rep.skipped == [combo]
    rep2 = pair.ingest(_rows("m-a", 15, 3, scale=0.25))
    assert rep2.drift[combo].drifted
    assert rep2.drift[combo].reason in ("residual_growth",
                                        "confidence_collapse")
    assert rep2.refit == [combo]
    pair.hold_predictions()


def test_online_drift_policy_refits_skipped_epoch_rows():
    pair = Pair(refit="drift", drift_err_ratio=2.0)
    eng = pair.port
    pair.ingest(_rows("m-a", 50, 1))
    combo = eng.combos[0]
    skipped = pair.ingest(_rows("m-a", 12, 2, iis=(64, 128)))
    assert skipped.refit == []
    forced = pair.ingest(_rows("m-a", 12, 3, scale=0.25))
    assert forced.refit == [combo]
    full = eng.full_data()
    np.testing.assert_array_equal(eng.predict(full),
                                  _scratch(full).predict(full))
    pair.hold_predictions()


def test_online_request_refit_forces_recalibration():
    pair = Pair(refit="drift")
    eng = pair.port
    pair.ingest(_rows("m-a", 50, 1))
    combo = eng.combos[0]
    eng.request_refit(combo)
    pair.ref.request_refit(combo)
    rep = pair.ingest(_rows("m-a", 12, 2))
    assert rep.refit == [combo]
    gen = eng.generation_of(combo)
    eng.request_refit(combo)
    pair.ref.request_refit(combo)
    rep2 = pair.ingest(_rows("m-b", 30, 3))
    assert combo in rep2.refit and combo not in rep2.changed
    assert eng.generation_of(combo) == gen + 1
    pair.hold_predictions()


def test_online_min_rows_skips_uncertainty_not_predict():
    pair = Pair(min_rows=64)
    eng = pair.port
    rep = pair.ingest(_rows("m-a", 20, 1))
    combo = eng.combos[0]
    assert rep.refit == [] and eng.ala_for(combo) is None
    probe = _rows("m-a", 10, 2)
    assert np.isfinite(eng.predict(Dataset.from_rows(probe))).all()
    got = eng.estimate(Dataset.from_rows(probe), backend="numpy")
    want = pair.ref.estimate(JaxDataset.from_rows(probe), backend="numpy")
    err, d, conf = got
    assert np.isnan(err).all() and (conf == 0.0).all()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    pair.hold_predictions()


def test_online_key_mismatch_raises():
    eng = _engine()
    eng.ingest(_ds("m-a", 20, 1), n_estimators=10)
    bad = Dataset({k: _ds("m-a", 5, 2)[k]
                   for k in ("model", "ii", "oo", "bb", "thpt")})
    with pytest.raises(ValueError, match="key columns"):
        eng.ingest(bad)


def test_online_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OnlineALA()


# ----------------------------------------------- robust-ingestion gate
def test_gate_quarantines_with_reasons_as_the_reference():
    clean = _rows("m-a", 6, 2)
    nan_row = dict(clean[0], thpt=float("nan"))
    dup_row = dict(clean[1])
    poison = dict(clean[2], thpt=clean[2]["thpt"] * 50.0)
    rows = clean + [nan_row, dup_row, poison]
    pair = Pair(gate=True)
    eng = pair.port
    pair.ingest(_rows("m-a", 40, 1))
    rep = pair.ingest(rows, require_finite=None)
    assert rep.n_quarantined >= 3
    by_reason = {}
    for q in eng.quarantine:
        by_reason.setdefault(q.reason, []).append(q.row)
    assert set(by_reason) <= {"nonfinite", "duplicate", "outlier"}
    assert any(not np.isfinite(r["thpt"]) for r in by_reason["nonfinite"])
    assert any(r["thpt"] == dup_row["thpt"] for r in by_reason["duplicate"])
    assert any(r["thpt"] == poison["thpt"] for r in by_reason["outlier"])
    assert np.isfinite(eng.predict(_ds("m-a", 10, 3))).all()
    # the reference engine refuses the same rows for the same reasons
    assert [(q.reason, repr(q.row["thpt"])) for q in eng.quarantine] == \
        [(q.reason, repr(q.row["thpt"])) for q in pair.ref.quarantine]
    pair.hold_predictions()


def test_gate_quarantine_parity_with_prefiltered_stream():
    """A fault-corrupted delta through the gate lands on the state a
    perfect pre-filter gives: predictions and estimates bit for bit."""
    base = _ds("m-a", 40, 1)
    corrupted, rep = injector(FaultConfig(
        seed=6, drop_p=0.1, dup_p=0.15, poison_nan_p=0.15)).corrupt_rows(
            _rows("m-a", 30, 2))
    assert rep.n_dropped and rep.n_duplicated and rep.n_poisoned
    eng_a, eng_b = _engine(gate=True), _engine(gate=True)
    eng_a.ingest(base, n_estimators=10)
    rep_a = eng_a.ingest(Dataset.from_rows(corrupted, require_finite=None),
                         n_estimators=10)
    eng_b.ingest(base, n_estimators=10)
    eng_b.ingest(Dataset.from_rows(rep.clean_rows), n_estimators=10)
    assert rep_a.n_quarantined >= rep.n_poisoned + rep.n_duplicated
    combo = eng_a.combos[0]
    assert eng_a.generation_of(combo) == eng_b.generation_of(combo)
    probe = _ds("m-a", 20, 5)
    np.testing.assert_array_equal(eng_a.predict(probe), eng_b.predict(probe))
    ea, _, ca = eng_a.estimate(probe, backend="numpy")
    eb, _, cb = eng_b.estimate(probe, backend="numpy")
    np.testing.assert_array_equal(ea, eb)
    np.testing.assert_array_equal(ca, cb)


def test_nonfinite_rows_filtered_even_without_gate():
    pair = Pair()
    eng = pair.port
    pair.ingest(_rows("m-a", 40, 1))
    clean = _rows("m-a", 8, 2)
    bad = [dict(clean[0], thpt=float("nan")),
           dict(clean[1], thpt=float("inf")),
           dict(clean[2], thpt=-10.0)]
    rep = pair.ingest(clean + bad, require_finite=None)
    assert rep.n_quarantined == 3
    assert all(q.reason == "nonfinite" for q in eng.quarantine)
    assert np.isfinite(eng.predict(_ds("m-a", 10, 3))).all()
    pair.hold_predictions()
