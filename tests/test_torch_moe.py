"""The port's MoE FFN against the JAX package's: ``moe_ffn`` outputs and
aux loss in fp32 (1e-4: the same math, another summation order) and bf16
(2e-2), top-1 and top-2, from one token to counts that overflow the
experts' capacity; the routing and the dropped entries equal the
reference's exactly where router probabilities tie; ``expert_capacity``
over a grid.  Weights and inputs are drawn with numpy from seeds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import moe as jmoe

from repro_torch.configs import get_smoke_config
from repro_torch.models import moe as tmoe

ARCH = "phi3.5-moe-42b-a6.6b"  # smoke: d 64, 4 experts of 128, top-2
_DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
           "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _cfgs(dtype_name, **over):
    jdt, tdt, _ = _DTYPES[dtype_name]
    return (jax_get_smoke_config(ARCH).scaled(compute_dtype=jdt, **over),
            get_smoke_config(ARCH).scaled(compute_dtype=tdt, **over))


def _params(cfg, seed, router=None):
    """Numpy weights at the reference's fan-in scales, and both packages'
    trees holding them (torch's in the compute dtype, as the model holds
    them)."""
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.expert_d_ff, cfg.n_experts
    w = {"router": rng.standard_normal((d, e)) / d ** 0.5 if router is None
         else router,
         "w_gate": rng.standard_normal((e, d, f)) / d ** 0.5,
         "w_up": rng.standard_normal((e, d, f)) / d ** 0.5,
         "w_down": rng.standard_normal((e, f, d)) / f ** 0.5}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    jp = {"router": jnp.asarray(w["router"]),
          "experts": {k: jnp.asarray(v) for k, v in w.items()
                      if k != "router"}}
    return w, jp


def _torch_params(w, dtype):
    return {"router": torch.from_numpy(w["router"]).to(dtype),
            "experts": {k: torch.from_numpy(v).to(dtype)
                        for k, v in w.items() if k != "router"}}


def _both(dtype_name, x, router=None, seed=0, **over):
    jcfg, tcfg = _cfgs(dtype_name, **over)
    w, jp = _params(tcfg, seed, router)
    tp = _torch_params(w, tcfg.compute_dtype)
    jy, jaux = jmoe.moe_ffn(jcfg, jp, jnp.asarray(x, jcfg.compute_dtype))
    ty, taux = tmoe.moe_ffn(tcfg, tp,
                            torch.from_numpy(x).to(tcfg.compute_dtype))
    return tcfg, tp, (_np(jy), float(jaux)), (_np(ty), float(taux))


def _kept(cfg, tp, x):
    """The port's dispatch: (T, k) experts chosen and whether each
    (token, choice) entry is kept, in token-major order."""
    xt = torch.from_numpy(x).to(cfg.compute_dtype).reshape(-1, cfg.d_model)
    _, _, idx = tmoe.route(cfg, tp["router"], xt)
    cap = tmoe.expert_capacity(cfg, xt.shape[0])
    _, order, _, keep = tmoe.dispatch(cfg, idx, cap)
    kept = torch.empty_like(keep)
    kept[order] = keep
    return idx.numpy(), kept.view(idx.shape).numpy()


@pytest.mark.parametrize("n_tokens", [1, 5, 64, 384])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_moe_ffn_matches_jax(dtype_name, top_k, n_tokens):
    """Outputs and aux loss, one token to a count past capacity (the
    inputs are shifted along the router's first column, so expert 0 takes
    more than its share and drops entries at 384 tokens)."""
    rng = np.random.default_rng(n_tokens)
    x = rng.standard_normal((1, n_tokens, 64)).astype(np.float32)
    router = rng.standard_normal((64, 4)).astype(np.float32) / 8
    x += 0.5 * router[:, 0] / np.linalg.norm(router[:, 0])
    tol = _DTYPES[dtype_name][2]
    cfg, tp, (jy, jaux), (ty, taux) = _both(dtype_name, x, router,
                                            top_k=top_k)
    np.testing.assert_allclose(ty, jy, rtol=tol, atol=tol)
    assert abs(taux - jaux) <= tol * abs(jaux)
    _, kept = _kept(cfg, tp, x)
    if n_tokens == 384:
        assert not kept.all()  # the case overflows capacity
    if n_tokens <= 5:
        assert kept.all()      # 8 slots an expert at least


@pytest.mark.parametrize("top_k", [1, 2])
def test_zeroed_router_ties_route_and_drop_as_the_reference(top_k):
    """A zeroed router makes every probability equal: the reference's
    ``lax.top_k`` takes experts 0..k-1, and its stable dispatch keeps each
    expert's first ``cap`` tokens.  The port picks the same experts and
    drops the same tokens, whose output is exactly zero in both."""
    n = 256
    x = np.random.default_rng(3).standard_normal((2, n // 2, 64))
    x = x.astype(np.float32)
    router = np.zeros((64, 4), np.float32)
    cfg, tp, (jy, jaux), (ty, taux) = _both("float32", x, router,
                                            top_k=top_k)
    idx, kept = _kept(cfg, tp, x)
    cap = tmoe.expert_capacity(cfg, n)
    assert (idx == np.arange(top_k)).all()
    assert (kept == (np.arange(n) < cap)[:, None]).all()
    jy, ty = jy.reshape(n, -1), ty.reshape(n, -1)
    dropped = ~kept.any(1)
    assert dropped.sum() == n - cap
    assert (ty[dropped] == 0).all() and (jy[dropped] == 0).all()
    assert (jy[~dropped] != 0).any(1).all()
    np.testing.assert_allclose(ty, jy, rtol=1e-4, atol=1e-4)
    assert taux == jaux == pytest.approx(1.0)


@pytest.mark.parametrize("top_k", [1, 2])
def test_tied_experts_go_to_the_lower_index(top_k):
    """Experts 1 and 3 share a router column, so their probabilities tie
    at every token: as ``lax.top_k``, the port ranks expert 1 before 3,
    and the reference's choice of experts equals the port's at every
    token."""
    rng = np.random.default_rng(4)
    router = (rng.standard_normal((64, 4)) / 8).astype(np.float32)
    router[:, 3] = router[:, 1]
    x = rng.standard_normal((1, 200, 64)).astype(np.float32)
    cfg, tp, (jy, jaux), (ty, taux) = _both("float32", x, router,
                                            top_k=top_k)
    idx, _ = _kept(cfg, tp, x)
    jlogits = jnp.asarray(x.reshape(-1, 64)) @ jnp.asarray(router)
    _, jidx = jax.lax.top_k(jax.nn.softmax(jlogits, axis=-1), top_k)
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    # expert 3 never ranks before its twin
    assert (idx[:, 0] == 1).any() and (idx[:, 0] != 3).all()
    if top_k == 2:
        assert (idx[idx[:, 1] == 3, 0] == 1).all()
    np.testing.assert_allclose(ty, jy, rtol=1e-4, atol=1e-4)
    assert taux == pytest.approx(jaux, rel=1e-6)


@pytest.mark.parametrize("n_experts", [4, 16, 128])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("capacity_factor", [1.0, 1.25, 2.0])
def test_expert_capacity_matches_jax(n_experts, top_k, capacity_factor):
    jcfg, tcfg = _cfgs("float32", n_experts=n_experts, top_k=top_k,
                       capacity_factor=capacity_factor)
    for n in (1, 2, 7, 8, 16, 100, 128, 1000, 8192, 32768):
        cap = tmoe.expert_capacity(tcfg, n)
        assert cap == jmoe.expert_capacity(jcfg, n), n
        assert cap >= 8 and cap % 8 == 0
