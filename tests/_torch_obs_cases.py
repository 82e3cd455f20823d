"""Shared inputs of the ``tests/test_torch_obs_*.py`` files: one seeded
smoke fleet trace (three tenants, diurnal load, flash crowds) served by
both packages' engines under one fault plan (crashes and stragglers),
with a retry budget and a shed deadline, so that the spans hold shed
requests, retries and crash instants, and the bit-for-bit comparisons
the files share."""
import math

import numpy as np

from repro.configs import get_config as jax_get_config
from repro.obs import ObsConfig as JaxObsConfig
from repro.perfmodel import hardware as jax_hw
from repro.perfmodel.simulator import ServingSetup as JaxSetup
from repro.serving import faults as jf
from repro.serving import simulator as jsim
from repro.serving import traces as jt

from repro_torch.configs import get_config
from repro_torch.obs import ObsConfig
from repro_torch.perfmodel import hardware
from repro_torch.perfmodel.simulator import ServingSetup
from repro_torch.serving import faults as tf
from repro_torch.serving import simulator as tsim
from repro_torch.serving import traces as tt

ARCH = "llama3.1-8b"
HORIZON_S = 40.0
FAULTS = dict(seed=3, horizon_s=HORIZON_S, n_replicas=4, mttf_s=10.0,
              mttr_s=3.0, straggler_rate_hz=0.1, straggler_dur_s=4.0)
SIM = dict(bucket_s=0.25, n_replicas=3, batch_cap=16, max_retries=1,
           shed_after_s=6.0)


def fleet_config(m, horizon=HORIZON_S):
    return m.FleetTraceConfig(tenants=(
        m.TenantConfig(name="chat", trace=m.TraceConfig(
            arrival="poisson", rate=6.0, shape_mix=m.mix(("chat", 1.0))),
            ttft_slo_s=1.5, diurnal_amp=0.4, diurnal_period_s=30.0),
        m.TenantConfig(name="summarize", trace=m.TraceConfig(
            arrival="gamma", rate=2.0, cv=2.0,
            shape_mix=m.mix(("summarize", 1.0))), ttft_slo_s=8.0),
        m.TenantConfig(name="generate", trace=m.TraceConfig(
            arrival="mmpp", rate=3.0, burst_rate=8.0,
            shape_mix=m.mix(("generate", 1.0))), ttft_slo_s=4.0,
            flash_crowds=2, flash_mult=3.0, flash_dur_s=5.0),
    ), horizon_s=horizon, seed=42)


def traces():
    """(port trace, reference trace), the same seeded requests."""
    return (tt.make_fleet_trace(fleet_config(tt)),
            jt.make_fleet_trace(fleet_config(jt)))


def configs(obs=None, **extra):
    """(port SimConfig, reference SimConfig) of the faulted scenario;
    ``obs`` holds ``ObsConfig`` fields (None: no hook).  ``device`` and
    ``traj_backend`` go to the port alone."""
    out = []
    for m, faults, get, hw, setup_cls, obs_cls in (
            (tsim, tf, get_config, hardware, ServingSetup, ObsConfig),
            (jsim, jf, jax_get_config, jax_hw, JaxSetup, JaxObsConfig)):
        c = dict(SIM, **extra)
        if m is jsim:
            c.pop("device", None)
            c.pop("traj_backend", None)
        out.append(m.SimConfig(
            setup=setup_cls(get(ARCH), hw.TPU_V5E, chips=4),
            faults=faults.injector(faults.FaultConfig(**FAULTS)),
            obs=None if obs is None else obs_cls(**obs), **c))
    return tuple(out)


def same_float(a, b):
    """Equal bits, or both NaN."""
    assert (isinstance(b, float) and math.isnan(b) and math.isnan(a)) or \
        np.float64(a).tobytes() == np.float64(b).tobytes(), (a, b)


def same_obj(a, b):
    """Nested dicts, lists and scalars equal, floats bit for bit."""
    if isinstance(b, dict):
        assert list(a) == list(b)
        for k in b:
            same_obj(a[k], b[k])
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same_obj(x, y)
    elif isinstance(b, float):
        same_float(a, b)
    else:
        assert a == b and type(a) is type(b), (a, b)


def same_array(a, b, name=""):
    """Equal dtype, shape and bytes (object arrays by value)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, name
    if b.dtype == object:
        assert a.tolist() == b.tolist(), name
    else:
        assert a.tobytes() == b.tobytes(), name
