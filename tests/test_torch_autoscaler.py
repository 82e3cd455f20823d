"""The port's ALA-driven control (``inference/scheduler.py``,
``serving/autoscaler.py``) against the JAX package's.

The port's ``CapacityPlanner``, ``BatchingQueue`` and ``ALAAutoscaler``
run over a port ``ALA`` converted from the reference's by
``weights.ala_from_reference`` (database, Alg 3 predictor, SA log, Alg 7
error model), so both sides read the same fit: the same plans and
batches, and through whole simulated runs (heap and fleet engines, with
hardware placement aware and round-robin) the same action at every
control tick, the same tick log (confidence within the reference's own
1e-6 serial-vs-batched contract, derate and fallback exact), the same
degradations and placements, and the adapter's rows of those runs bit
for bit.

The closed loop (``benchmarks/run.py``'s ``online_engine`` at smoke
size, two epochs): each epoch slices an MMPP trace, simulates it with an
autoscaler attached to an ``OnlineALA``, adapts the windows and ingests
them.  The port's loop runs its own ``OnlineALA`` on the CPU from the
same seed grid: the same actions, the same deltas bit for bit, and the
same refit decisions, drift flags and generations as the reference's
loop."""
import math

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.annealing import SAConfig as JaxSAConfig
from repro.core.dataset import Dataset as JaxDataset
from repro.core.online import OnlineALA as JaxOnlineALA
from repro.core.online import OnlineConfig as JaxOnlineConfig
from repro.inference import scheduler as jsch
from repro.obs import ObsConfig as JaxObsConfig
from repro.perfmodel import hardware as jax_hw
from repro.perfmodel import simulator as jax_perf
from repro.serving import adapter as jad
from repro.serving import autoscaler as jas
from repro.serving import simulator as jsim
from repro.serving import traces as jt

from repro_torch.configs import get_config
from repro_torch.core.annealing import SAConfig
from repro_torch.core.dataset import Dataset
from repro_torch.core.online import OnlineALA, OnlineConfig
from repro_torch.core.registry import ModelRegistry
from repro_torch.inference import scheduler as tsch
from repro_torch.obs import CalibrationAudit, ObsConfig
from repro_torch.perfmodel import hardware
from repro_torch.perfmodel import simulator as perf
from repro_torch.serving import adapter as tad
from repro_torch.serving import autoscaler as tas
from repro_torch.serving import simulator as tsim
from repro_torch.serving import traces as tt
from repro_torch.weights import ala_from_reference

CONF_TOL = 1e-6
SA_SMALL = dict(n_iters=4, n_chains=2, seed=0,
                gbt_kw=dict(n_estimators=15, learning_rate=0.2, max_depth=3))
GBT_KW = dict(n_estimators=10, learning_rate=0.15)
GRID = [(ii, oo, bb) for ii in (128, 512, 2048) for oo in (64, 256)
        for bb in (1, 4, 16, 64)]
ARCH = "llama3.1-8b"
EPOCH_S = 10.0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _setups():
    return (perf.ServingSetup(get_config(ARCH), hardware.TPU_V5E, chips=4),
            jax_perf.ServingSetup(jax_get_config(ARCH), jax_hw.TPU_V5E,
                                  chips=4))


def _seed_rows():
    """The online_engine benchmark's calibration grid, at smoke size."""
    setup = _setups()[1]
    rng = np.random.default_rng(0)
    return [dict(model=ARCH, acc="tpu-v5e", acc_count=4,
                 back=jad.TRACE_BACKEND, prec="bf16", mode="serve",
                 ii=ii, oo=oo, bb=bb, thpt=float(t),
                 **jax_hw.feature_row(jax_hw.TPU_V5E))
            for ii, oo, bb in GRID
            for t in jax_perf.sample_throughput(setup, ii, oo, bb, 2, rng)]


def _online_pair():
    port = OnlineALA(OnlineConfig(sa=SAConfig(**SA_SMALL), warm_iters=3,
                                  gbt_kw=dict(SA_SMALL["gbt_kw"])),
                     device="cpu")
    ref = JaxOnlineALA(JaxOnlineConfig(sa=JaxSAConfig(**SA_SMALL),
                                       warm_iters=3,
                                       gbt_kw=dict(SA_SMALL["gbt_kw"])))
    return port, ref


@pytest.fixture(scope="module")
def fitted():
    """A reference ALA with an SA log and error model, fitted through its
    OnlineALA on the seed grid, and the port's copy of it."""
    _, ref = _online_pair()
    rows = _seed_rows()
    ref.ingest(JaxDataset.from_rows(rows), **GBT_KW)
    combo = ref.combos[0]
    jala = ref.ala_for(combo)
    assert jala.error_model is not None and jala.sa_log is not None
    return ala_from_reference(jala, device="cpu"), jala


def _trace(m, seed=29, horizon=40.0):
    cap = jax_perf.throughput(_setups()[1], 512, 192, 64) / 192
    return m.make_trace(m.TraceConfig(
        arrival="mmpp", rate=0.7 * cap, burst_rate=2.0 * cap,
        horizon_s=horizon, shape_mix=m.mix(("chat", 0.7), ("generate", 0.3)),
        seed=seed))


def test_derate_confidence_as_the_reference():
    for conf in (float("nan"), float("inf"), -1.0, 0.0, 0.1, 0.25, 0.5,
                 0.69, 0.7, 0.9, 1.0):
        for floor, low in ((0.7, 0.25), (0.5, 0.1)):
            assert tsch.derate_confidence(conf, floor, low) == \
                jsch.derate_confidence(conf, floor, low)


def test_capacity_planner_and_queue_as_the_reference(fitted):
    ala, jala = fitted
    plan, jplan = tsch.CapacityPlanner(ala), jsch.CapacityPlanner(jala)
    for ii, oo in ((128, 64), (512, 256), (2048, 128), (700, 90)):
        for target, lat in ((None, None), (500.0, None), (1e6, None),
                            (None, 0.05), (2000.0, 0.2)):
            got = plan.plan_batch_size(ii, oo, target, lat)
            want = jplan.plan_batch_size(ii, oo, target, lat)
            assert (got.bb, got.replicas, got.degenerate) == \
                (want.bb, want.replicas, want.degenerate)
            assert got.predicted_thpt == want.predicted_thpt
            assert abs(got.confidence - want.confidence) <= CONF_TOL
            assert got.derated_thpt == pytest.approx(want.derated_thpt,
                                                     rel=CONF_TOL)
    rng = np.random.default_rng(4)
    q, jq = tsch.BatchingQueue(plan, 800.0), jsch.BatchingQueue(jplan, 800.0)
    for rid in range(300):
        ii, oo = int(rng.integers(60, 3000)), int(rng.integers(30, 600))
        q.submit(tsch.Request(rid, ii, oo))
        jq.submit(jsch.Request(rid, ii, oo))
        assert tsch.BatchingQueue.bucket(ii, oo) == \
            jsch.BatchingQueue.bucket(ii, oo)

    def ids(batches):
        return [(k, [r.rid for r in b]) for k, b in batches]

    assert ids(q.ready_batches()) == ids(jq.ready_batches())
    assert ids(q.flush()) == ids(jq.flush())


SCALERS = {
    "fleet-agnostic": dict(),
    "placement-aware": dict(hardware_pool=("tpu-v5e", "gpu-h100-sxm",
                                           "tpu-v4"),
                            fitted_hardware="tpu-v5e", scale=True),
    "placement-roundrobin": dict(hardware_pool=("tpu-v5e", "gpu-a100-80g"),
                                 placement="roundrobin"),
    "ring-capped-log": dict(max_log_entries=4, drift_window=3),
}


def _scalers(name, fitted):
    kw = dict(SCALERS[name])
    ala, jala = fitted
    out = []
    for m, a in ((tas, ala), (jas, jala)):
        k = dict(kw)
        if k.pop("scale", False):
            k["hardware_scale"] = {
                "gpu-h100-sxm": lambda ii, oo, bb: 1.8,
                "tpu-v4": lambda ii, oo, bb: 0.9 + bb / 1000.0}
        out.append(m.ALAAutoscaler(ala=a, max_replicas=6, **k))
    return out


@pytest.mark.parametrize("engine", ["heap", "fleet"])
@pytest.mark.parametrize("name", list(SCALERS))
def test_autoscaler_takes_the_references_actions(engine, name, fitted):
    pol, jpol = _scalers(name, fitted)
    setup, jsetup = _setups()
    res = tsim.simulate(_trace(tt), tsim.SimConfig(
        setup=setup, n_replicas=1, max_replicas=6, bucket_s=0.25), pol,
        engine=engine)
    jres = jsim.simulate(_trace(jt), jsim.SimConfig(
        setup=jsetup, n_replicas=1, max_replicas=6, bucket_s=0.25), jpol,
        engine=engine)
    assert len(res.controls) == len(jres.controls) >= 15
    assert [(t, a.n_replicas, a.batch_cap, a.hardware)
            for t, a in res.controls] == \
        [(t, a.n_replicas, a.batch_cap, a.hardware) for t, a in jres.controls]
    assert len({a.n_replicas for _, a in res.controls}) > 1
    assert len(pol.log) == len(jpol.log)
    for (c, d, f), (jc, jd, jf_) in zip(pol.log, jpol.log):
        assert abs(c - jc) <= CONF_TOL and (d, f) == (jd, jf_)
    assert list(pol.degradations) == list(jpol.degradations)
    assert [(t, h) for t, h, _ in pol.placements] == \
        [(t, h) for t, h, _ in jpol.placements]
    assert res.accounting() == jres.accounting()
    for k in jres.req if engine == "fleet" else ():
        a, b = res.req[k], jres.req[k]
        assert (a.tolist() == b.tolist() if b.dtype == object
                else a.tobytes() == b.tobytes()), k
    if name == "ring-capped-log":
        assert len(pol.log) == 4 and pol.log.n_total > 4
    if not SCALERS[name].get("hardware_pool"):
        got = tad.windows_to_dataset(res, setup, ARCH, window_s=5.0)
        want = jad.windows_to_dataset(jres, jsetup, ARCH, window_s=5.0)
        assert list(got.cols) == list(want.cols) and len(got) > 0
        for k in want.cols:
            assert got[k].tobytes() == want[k].tobytes(), k


def test_observability_hooks_are_accepted_as_the_reference(fitted):
    """``obs`` with no ``audit`` builds one, a given audit is shared, a
    disabled ``obs`` builds none, and ``obs.max_log_entries`` caps the
    decision logs, on both sides alike; ``StaticPolicy`` takes neither."""
    ala, jala = fitted
    for obs, jobs in ((ObsConfig(max_log_entries=3),
                       JaxObsConfig(max_log_entries=3)),
                      (ObsConfig(enabled=False),
                       JaxObsConfig(enabled=False))):
        pol = tas.ALAAutoscaler(ala=ala, obs=obs)
        jpol = jas.ALAAutoscaler(ala=jala, obs=jobs)
        assert type(pol.audit).__name__ == type(jpol.audit).__name__
        assert type(pol.log).__name__ == type(jpol.log).__name__
        assert getattr(pol.log, "cap", None) == getattr(jpol.log, "cap",
                                                        None)
    assert isinstance(tas.ALAAutoscaler(ala=ala, obs=ObsConfig()).audit,
                      CalibrationAudit)
    shared = CalibrationAudit()
    assert tas.ALAAutoscaler(ala=ala, audit=shared,
                             obs=ObsConfig()).audit is shared
    assert math.isnan(tas.ALAAutoscaler(ala=ala)._last_pred_err)
    pol = tas.StaticPolicy(n_replicas=3, batch_cap=16)
    act = pol.control(None)
    assert (act.n_replicas, act.batch_cap, act.hardware) == (3, 16, None)


def _epoch(m, sim, ad, eng, scaler, trace, setup, e):
    tr = trace.slice(e * EPOCH_S, (e + 1) * EPOCH_S)
    res = sim.simulate(tr, sim.SimConfig(setup=setup, batch_cap=64,
                                         n_replicas=1, max_replicas=4,
                                         t_start=e * EPOCH_S), scaler)
    delta = ad.windows_to_dataset(res, setup, ARCH, window_s=EPOCH_S / 4.0)
    return res, delta, eng.ingest(delta, **GBT_KW)


def test_two_epoch_closed_loop_keeps_the_references_decisions():
    port, ref = _online_pair()
    rows = _seed_rows()
    rep = port.ingest(Dataset.from_rows(rows), **GBT_KW)
    jrep = ref.ingest(JaxDataset.from_rows(rows), **GBT_KW)
    assert (rep.changed, rep.refit) == (jrep.changed, jrep.refit)
    combo = ref.combos[0]
    assert port.combos == [combo]
    scaler = tas.ALAAutoscaler(ala=port.ala_for(combo), online=port,
                               combo=combo, max_replicas=4, drift_window=3)
    jscaler = jas.ALAAutoscaler(ala=ref.ala_for(combo), online=ref,
                                combo=combo, max_replicas=4, drift_window=3)
    setup, jsetup = _setups()
    trace, jtrace = _trace(tt, horizon=2 * EPOCH_S), \
        _trace(jt, horizon=2 * EPOCH_S)
    for e in range(2):
        res, delta, rep = _epoch(tt, tsim, tad, port, scaler, trace, setup, e)
        jres, jdelta, jrep = _epoch(jt, jsim, jad, ref, jscaler, jtrace,
                                    jsetup, e)
        res.check_conservation()
        assert res.accounting() == jres.accounting()
        assert [(t, a.n_replicas, a.batch_cap) for t, a in res.controls] == \
            [(t, a.n_replicas, a.batch_cap) for t, a in jres.controls]
        assert list(delta.cols) == list(jdelta.cols) and len(delta) > 0
        for k in jdelta.cols:
            assert delta[k].tobytes() == jdelta[k].tobytes(), (e, k)
        assert (rep.changed, rep.refit, rep.skipped, rep.n_quarantined) == \
            (jrep.changed, jrep.refit, jrep.skipped, jrep.n_quarantined)
        assert {c: (d.n_rows, d.drifted, d.reason)
                for c, d in rep.drift.items()} == \
            {c: (d.n_rows, d.drifted, d.reason)
             for c, d in jrep.drift.items()}
        assert port.generation_of(combo) == ref.generation_of(combo) == e + 2
        assert len(scaler.recalibrations) == len(jscaler.recalibrations)
        # the autoscaler rebinds to the refitted ALA on its next tick
        assert scaler._generation == ref.generation_of(combo) - 1
    full = port.full_data()
    np.testing.assert_array_equal(
        port.predict(full),
        ModelRegistry(device="cpu").fit(full, **GBT_KW).predict(full))
