"""The port's calibration audit (``obs/calibration.py``) and its two
feeds against the JAX package's.

- ``pav`` and ``reliability_curve`` bit for bit on seeded inputs, with
  ties, zero weights, one bin, empty input and ``monotone=False``.
- A ``CalibrationAudit`` fed one event sequence on both sides: the same
  ``to_dict()`` list, ``counts``, ``ticks()``, ``reliability()`` and
  ``summary()``, and the same ``RingLog`` eviction under
  ``max_cal_events``.
- ``ALAAutoscaler(obs=ObsConfig())`` over ``weights.ala_from_reference``
  beside the reference's autoscaler over the same ALA, through whole
  heap and fleet runs: the same tick (with Alg 7's ``pred_err``),
  recalibration and degradation events, bit for bit but the Alg 8
  confidence, which is held to the reference's own 1e-6
  serial-vs-batched contract (``test_torch_autoscaler.py``).
- ``OnlineALA(audit=...)``: fresh engines on both sides take the first
  delta, then before every later delta the port's engine is converted
  from the reference's (``weights.online_from_reference``, given the
  port's audit) and both take it; the drift, quarantine and refit events are the
  reference's, drift confidence within 1e-6, and ``wall_s`` (a refit's
  wall-clock seconds) is left out of every comparison."""
import numpy as np
import pytest
import torch

from _torch_obs_cases import same_obj
from test_torch_autoscaler import fitted  # noqa: F401 (a fixture)
from repro.core.annealing import SAConfig as JaxSAConfig
from repro.core.dataset import Dataset as JaxDataset
from repro.core.online import DriftSignal as JaxDriftSignal
from repro.core.online import OnlineALA as JaxOnlineALA
from repro.core.online import OnlineConfig as JaxOnlineConfig
from repro.core.online import RefitReport as JaxRefitReport
from repro.obs import ObsConfig as JaxObsConfig
from repro.obs import calibration as jcal
from repro.obs.metrics import RingLog as JaxRingLog
from repro.serving import autoscaler as jas
from repro.serving import simulator as jsim
from repro.serving import traces as jt

from repro_torch.core.annealing import SAConfig
from repro_torch.core.dataset import Dataset
from repro_torch.core.online import DriftSignal, OnlineALA, OnlineConfig, \
    RefitReport
from repro_torch.obs import ObsConfig
from repro_torch.obs import calibration as tcal
from repro_torch.obs.metrics import RingLog
from repro_torch.serving import autoscaler as tas
from repro_torch.serving import simulator as tsim
from repro_torch.serving import traces as tt
from repro_torch.weights import online_from_reference

CONF_TOL = 1e-6
# event fields that follow Alg 8's confidence, held to CONF_TOL
CONF_KEYS = ("confidence", "median_confidence")
# the autoscaler's trace: long enough for every kind of event
HORIZON_S = 20.0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _same_events(got, want, drop=(), conf_tol=None):
    """Event dicts equal, ``drop`` keys left out, confidence fields within
    ``conf_tol`` where it is given (else bit for bit)."""
    got = [{k: v for k, v in e.to_dict().items() if k not in drop}
           for e in got]
    want = [{k: v for k, v in e.to_dict().items() if k not in drop}
            for e in want]
    assert [list(e) for e in got] == [list(e) for e in want]
    for g, w in zip(got, want):
        for k in w:
            if conf_tol is not None and k in CONF_KEYS:
                assert abs(g[k] - w[k]) <= conf_tol, (k, g[k], w[k])
            else:
                same_obj(g[k], w[k])


# -- pav / reliability_curve ---------------------------------------------------

def _pav_inputs():
    rng = np.random.default_rng(0)
    yield rng.normal(size=40), rng.uniform(0.5, 3.0, 40)
    yield np.array([0.3, 0.3, 0.1, 0.1, 0.5]), np.ones(5)          # ties
    yield np.array([0.9, 0.2, 0.4, 0.1]), np.array([0.0, 0.0, 1.0, 0.0])
    yield np.array([0.7]), np.array([2.0])                          # one
    yield np.array([0.1, 0.2, 0.5, 0.9]), np.ones(4)                # sorted
    yield np.linspace(1.0, 0.0, 25), rng.integers(1, 9, 25).astype(float)
    for n in (7, 60):
        r = np.random.default_rng(n)
        yield r.random(n).round(1), r.uniform(0.1, 2.0, n)


@pytest.mark.parametrize("case", range(8))
def test_pav_bit_equal(case):
    y, w = list(_pav_inputs())[case]
    got, want = tcal.pav(y, w), jcal.pav(y, w)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_pav_on_empty_input_raises_as_the_reference():
    for pav in (tcal.pav, jcal.pav):
        with pytest.raises(ValueError, match="concatenate"):
            pav(np.zeros(0), np.zeros(0))


def _curve_inputs():
    rng = np.random.default_rng(1)
    conf = rng.uniform(0.0, 1.0, 3000)
    ok = (rng.random(3000) < conf).astype(float)
    yield conf, ok
    yield conf, 1.0 - ok                                   # PAV acts
    yield np.array([0.05, 0.06, 0.95, 0.96, np.nan]), \
        np.array([0.0, 0.0, 1.0, 1.0, 1.0])                # NaN, empty bins
    yield np.full(12, 0.5), (np.arange(12) % 3 == 0).astype(float)  # ties
    yield np.array([0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0]), \
        np.array([1.0, 1, 0, 1, 0, 0, 1, 0, 1, 1, 0])      # edge values
    yield np.zeros(0), np.zeros(0)                          # empty


@pytest.mark.parametrize("monotone", [True, False])
@pytest.mark.parametrize("n_bins", [10, 4, 1])
@pytest.mark.parametrize("case", range(6))
def test_reliability_curve_bit_equal(case, n_bins, monotone):
    conf, ok = list(_curve_inputs())[case]
    got = tcal.reliability_curve(conf, ok, n_bins=n_bins, monotone=monotone)
    want = jcal.reliability_curve(conf, ok, n_bins=n_bins, monotone=monotone)
    same_obj(got, want)
    acc = got["bin_acc"]
    if monotone:
        assert all(a <= b + 1e-12 for a, b in zip(acc, acc[1:]))


# -- the audit itself ------------------------------------------------------------

def _report(m, epoch, quarantined, drifted):
    """A RefitReport and its DriftSignals from package ``m``'s classes."""
    drift_cls, report_cls = m
    sig = drift_cls(combo=("m", "a"), n_rows=8, confidence=0.4,
                    pred_err=30.0, resid_ape=80.0, drifted=drifted,
                    reason="residual_growth" if drifted else "")
    calm = drift_cls(combo=("m", "b"), n_rows=8, confidence=0.9,
                     pred_err=5.0, resid_ape=6.0, drifted=False, reason="")
    return report_cls(epoch=epoch, n_rows=16,
                      changed=[("m", "a"), ("m", "b")], refit=[("m", "a")],
                      skipped=[("m", "b")],
                      drift={("m", "a"): sig, ("m", "b"): calm},
                      registry_s=0.1, uncertainty_s=0.2, wall_s=0.3,
                      n_quarantined=quarantined)


def _feed(audit, m):
    """One event sequence: ticks with every APE branch, decisions,
    reports on the epoch clock."""
    rng = np.random.default_rng(3)
    for i in range(30):
        conf = float(rng.uniform())
        measured = float(rng.uniform(50.0, 150.0))
        audit.tick(float(i), predicted=measured * (1.0 + (0.6 - conf)),
                   measured=measured, confidence=conf,
                   pred_err=float(rng.uniform(5.0, 40.0)))
    audit.tick(30.0, predicted=float("nan"), measured=100.0, confidence=0.1)
    audit.tick(31.0, predicted=90.0, measured=0.0, confidence=0.2)
    audit.tick(32.0, predicted=90.0, measured=100.0, confidence=0.7,
               ape=3.5, pred_err=float("inf"))
    audit.event(33.0, "degradation", reason="backoff")
    audit.event(34.0, "recalibration", median_ape=41.0,
                median_confidence=0.3)
    audit.event(35.0, "decision", n_replicas=4)
    for epoch, q, d in ((1, 0, False), (2, 4, True), (3, 0, True)):
        audit.ingest_report(_report(m, epoch, q, d))


@pytest.mark.parametrize("cap", [None, 7, 30])
def test_audit_fed_alike_gives_the_references_log(cap):
    got = tcal.CalibrationAudit(ObsConfig(max_cal_events=cap,
                                          ape_ok_pct=20.0,
                                          reliability_bins=5))
    want = jcal.CalibrationAudit(JaxObsConfig(max_cal_events=cap,
                                              ape_ok_pct=20.0,
                                              reliability_bins=5))
    _feed(got, (DriftSignal, RefitReport))
    _feed(want, (JaxDriftSignal, JaxRefitReport))
    assert isinstance(got.events, RingLog if cap else list)
    assert isinstance(want.events, JaxRingLog if cap else list)
    if cap:
        assert (got.events.n_dropped, got.events.n_total) == \
            (want.events.n_dropped, want.events.n_total)
        assert got.events.n_dropped > 0
    _same_events(got.events, want.events)
    same_obj(got.counts, want.counts)
    gt, wt = got.ticks(), want.ticks()
    assert list(gt) == list(wt)
    for k in wt:
        assert gt[k].tobytes() == wt[k].tobytes(), k
    for n_bins, mono in ((None, True), (3, False), (10, True)):
        same_obj(got.reliability(n_bins, mono),
                  want.reliability(n_bins, mono))
    same_obj(got.summary(), want.summary())
    if cap is None:
        assert "ape_over_pred_err" in got.summary()


def test_empty_audit_summary_as_the_reference():
    same_obj(tcal.CalibrationAudit().summary(),
              jcal.CalibrationAudit().summary())
    assert tcal.EVENT_KINDS == jcal.EVENT_KINDS


# -- the autoscaler feed ---------------------------------------------------------

class _Online:
    """An online engine that never refits: the autoscaler's drift
    evidence then reaches ``request_refit`` (a recalibration event) while
    its fit stays put."""

    def __init__(self):
        self.requests = 0

    def generation_of(self, combo):
        return 0

    def ala_for(self, combo):
        return None

    def request_refit(self, combo):
        self.requests += 1


@pytest.mark.parametrize("engine", ["heap", "fleet"])
def test_autoscaler_audit_events_are_the_references(engine, fitted):
    from test_torch_autoscaler import _setups, _trace
    ala, jala = fitted
    kw = dict(max_replicas=6, combo=("llama3.1-8b",), drift_window=3,
              drift_ape_threshold=10.0)
    pol = tas.ALAAutoscaler(ala=ala, obs=ObsConfig(max_log_entries=5),
                            online=_Online(), **kw)
    jpol = jas.ALAAutoscaler(ala=jala, obs=JaxObsConfig(max_log_entries=5),
                             online=_Online(), **kw)
    assert isinstance(pol.audit, tcal.CalibrationAudit)
    setup, jsetup = _setups()
    res = tsim.simulate(_trace(tt, horizon=HORIZON_S), tsim.SimConfig(
        setup=setup, n_replicas=1, max_replicas=6, bucket_s=0.25), pol,
        engine=engine)
    jres = jsim.simulate(_trace(jt, horizon=HORIZON_S), jsim.SimConfig(
        setup=jsetup, n_replicas=1, max_replicas=6, bucket_s=0.25), jpol,
        engine=engine)
    assert res.accounting() == jres.accounting()
    counts = pol.audit.counts
    assert counts == jpol.audit.counts
    assert counts["tick"] >= 8 and counts["recalibration"] >= 1 \
        and counts["degradation"] >= 1
    assert pol.online.requests == counts["recalibration"]
    _same_events(pol.audit.events, jpol.audit.events, conf_tol=CONF_TOL)
    ticks = pol.audit.ticks()
    assert np.isfinite(ticks["pred_err"]).all()     # Alg 7 rode along
    # obs.max_log_entries caps the decision logs as the reference's
    assert isinstance(pol.log, RingLog) and len(pol.log) == 5
    assert pol.log.n_total == jpol.log.n_total > 5
    assert list(pol.degradations) == list(jpol.degradations)


# -- the online-loop feed --------------------------------------------------------

def _rows(model, n, seed, scale=1.0):
    from test_torch_online import _rows as rows
    return rows(model, n, seed, scale=scale)


# smaller than test_torch_autoscaler's SA_SMALL: the reference compiles its SA anew at each
# combination's row count, and the drift, quarantine and refit events
# still all occur
SA_ONLINE = dict(n_iters=2, n_chains=2, seed=0,
                 gbt_kw=dict(n_estimators=8, learning_rate=0.2, max_depth=3))


def _cfg(m_sa, m_cfg):
    return m_cfg(sa=m_sa(**SA_ONLINE), warm_iters=2,
                 gbt_kw=dict(SA_ONLINE["gbt_kw"]), refit="drift",
                 drift_err_ratio=2.0, gate=True)


def test_online_audit_events_are_the_references():
    audit = tcal.CalibrationAudit()
    jaudit = jcal.CalibrationAudit()
    port = OnlineALA(_cfg(SAConfig, OnlineConfig), audit=audit,
                     device="cpu")
    ref = JaxOnlineALA(_cfg(JaxSAConfig, JaxOnlineConfig), audit=jaudit)
    assert port.audit is audit
    clean = _rows("m-b", 6, 5)
    gate = clean + [dict(clean[0], thpt=float("nan")), dict(clean[1]),
                    dict(clean[2], thpt=clean[2]["thpt"] * 50.0)]
    deltas = [(_rows("m-a", 50, 1) + _rows("m-b", 30, 4), {}),
              (_rows("m-a", 15, 2), {}),
              (_rows("m-a", 15, 3, scale=0.25), {}),
              (gate, dict(require_finite=None))]
    for i, (rows, kw) in enumerate(deltas):
        if i:   # the port's engine from the reference's state
            port = online_from_reference(ref, device="cpu")
            port.audit = audit
        port.ingest(Dataset.from_rows(rows, **kw), n_estimators=6)
        ref.ingest(JaxDataset.from_rows(rows, **kw), n_estimators=6)
    assert audit.counts == jaudit.counts
    assert audit.counts["refit"] == 4 and audit.counts["drift"] >= 1 \
        and audit.counts["quarantine"] == 1
    _same_events(audit.events, jaudit.events, drop=("wall_s",),
                 conf_tol=CONF_TOL)
    assert all(e.clock == "epoch" for e in audit.events)
    assert all(e.data["wall_s"] >= 0.0 for e in audit.events
               if e.kind == "refit")
