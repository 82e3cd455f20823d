"""The port's sharded steps on eight gloo ranks, a (data 2, model 4) mesh,
against its local calls and against the reference's sharded runs.

The reference runs in a subprocess on 8 fake host devices (XLA fixes the
device count at its first use) with a mesh of Auto axes: its own
``jax.make_mesh`` gives Explicit axes on this JAX, which its
``with_sharding_constraint`` refuses (ROADMAP queue C).  That subprocess
draws the weights and inputs, runs the reference's sharded step, and
writes the weights in the port's names (``weights.params_from_jax``);
the port's ranks (``tests/_torch_dist_cases.py``, one subprocess with its
own timeout) read them.  Cases, each in fp32 against the port's local
call within 1e-5 and in bf16 against the reference's sharded run:

* qwen2.5-32b's smoke serve step, B 8, T 64 (T-sharded cache: 2 KV heads
  on a 4-wide model axis), within the reference's 5e-2;
* llama3.2-3b's smoke context-parallel prefill at 6/2 heads
  (``cp_replicate_weights``, ``serving_2d=False``), which the reference's
  own test only compiles, within the same 5e-2;
* ``moe_ffn_ep`` on phi3.5-moe's smoke config at capacity factor 8,
  within the reference's 3e-2 and aux 1e-3, ``moe_ffn`` under the policy
  handing over to it, and its fp32 gradients (input, router, experts)
  within 1e-5 of the local call's, each scaled by its largest;

and, port only, jamba's smoke model (Mamba, attention and MoE blocks,
the MoE through ``moe_ffn_ep``) under a serving policy with 2D weights:
a prefill and a decode step within 1e-5 of the local calls in fp32.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

ORACLE = r"""
import sys
import jax, jax.numpy as jnp, numpy as np, torch
from repro.configs import get_smoke_config
from repro.configs.shapes import ShapeSpec
from repro.distributed.ep_moe import moe_ffn_ep
from repro.distributed.sharding import ShardingPolicy, use_policy
from repro.launch.steps import build_serve_step, build_step
from repro.models import moe as moe_mod
from repro.models.transformer import Model
from repro_torch.configs import get_smoke_config as port_config
from repro_torch.weights import params_from_jax

d = sys.argv[1]
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
rng = np.random.default_rng(0)
f32 = lambda t: np.asarray(jnp.asarray(t, jnp.float32))

def save_params(name, arch, cfg_kw, params):
    torch.save(params_from_jax(jax.tree.map(np.asarray, params),
                               port_config(arch).scaled(**cfg_kw), "cpu"),
               f"{d}/{name}_params.pt")

# serve step
cfg = get_smoke_config("qwen2.5-32b").scaled(param_dtype=jnp.bfloat16)
policy = ShardingPolicy(mesh, data_axes=("data",), serving=True,
                        serving_2d=False)
model = Model(cfg)
step, in_sh, out_sh, _ = build_serve_step(
    model, policy, ShapeSpec("d", seq_len=64, global_batch=8, kind="decode"))
params = model.init(jax.random.key(0))
cache = model.init_cache(8, 64, filled=63)
kv = {}
blocks = []
for i, st in enumerate(cache.blocks):
    k = rng.standard_normal(st.k.shape).astype(np.float32)
    v = rng.standard_normal(st.v.shape).astype(np.float32)
    st = type(st)(k=jnp.asarray(k, st.k.dtype), v=jnp.asarray(v, st.v.dtype))
    kv[f"k{i}"], kv[f"v{i}"] = f32(st.k), f32(st.v)
    blocks.append(st)
cache = cache._replace(blocks=tuple(blocks))
toks = rng.integers(0, cfg.vocab_size, (8, 1)).astype(np.int32)
with use_policy(policy):
    logits, _ = jax.jit(step, in_shardings=in_sh, out_shardings=out_sh)(
        params, cache, jnp.asarray(toks))
save_params("serve", "qwen2.5-32b", {}, params)
np.savez(f"{d}/serve_inputs.npz", tokens=toks, **kv)
out = {"serve": f32(logits)}

# context-parallel prefill
cfg = get_smoke_config("llama3.2-3b").scaled(
    n_heads=6, n_kv_heads=2, param_dtype=jnp.bfloat16)
policy = ShardingPolicy(mesh, data_axes=("data",), serving=True,
                        serving_2d=False, cp_replicate_weights=True)
model = Model(cfg)
step, in_sh, out_sh, _ = build_step(
    model, policy, ShapeSpec("p", seq_len=64, global_batch=4, kind="prefill"))
params = model.init(jax.random.key(1))
toks = rng.integers(0, cfg.vocab_size, (4, 64)).astype(np.int32)
with use_policy(policy):
    logits, _ = jax.jit(step, in_shardings=in_sh, out_shardings=out_sh)(
        params, {"tokens": jnp.asarray(toks)})
save_params("cp", "llama3.2-3b", {"n_heads": 6, "n_kv_heads": 2}, params)
np.savez(f"{d}/cp_inputs.npz", tokens=toks)
out["cp"] = f32(logits)

# expert-parallel MoE
cfg = get_smoke_config("phi3.5-moe-42b-a6.6b").scaled(capacity_factor=8.0)
policy = ShardingPolicy(mesh, data_axes=("data",), model_axes=("model",))
params = moe_mod.init_moe(cfg, jax.random.key(0))
x = jax.random.normal(jax.random.key(1), (4, 16, cfg.d_model), jnp.float32)
with use_policy(policy):
    y, aux = jax.jit(lambda p, xx: moe_ffn_ep(cfg, p, xx, policy))(
        params, x.astype(cfg.compute_dtype))
np.savez(f"{d}/moe_inputs.npz", x=f32(x), router=f32(params["router"]),
         **{k: f32(w) for k, w in params["experts"].items()})
out["moe"], out["moe_aux"] = f32(y), f32(aux)
np.savez(f"{d}/reference.npz", **out)
"""


def _run(args, env, timeout=300):
    out = subprocess.run(args, env=env, capture_output=True, text=True,
                         timeout=timeout, cwd=REPO)
    assert out.returncode == 0, f"stderr:\n{out.stderr[-4000:]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's arrays, the port ranks' arrays)."""
    d = tmp_path_factory.mktemp("dist")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": os.environ.get("XLA_FLAGS", "")
           + " --xla_force_host_platform_device_count=8"}
    _run([sys.executable, "-c", ORACLE, str(d)], env)
    _run([sys.executable, str(REPO / "tests" / "_torch_dist_cases.py"),
          "serving", str(d)], env)
    return np.load(d / "reference.npz"), np.load(d / "serving.npz")


def _close(a, b, atol):
    assert a.shape == b.shape
    err = float(np.max(np.abs(a - b)))
    assert err <= atol, err


def test_sharded_serve_step_matches_local_and_reference(runs):
    ref, port = runs
    _close(port["serve_float32_sharded"], port["serve_float32_local"], 1e-5)
    _close(port["serve_float32_cache_sharded"],
           port["serve_float32_cache_local"], 1e-5)
    _close(port["serve_bfloat16_sharded"], ref["serve"], 5e-2)
    # the cache stays (data, T over model): 2 KV heads on a 4-wide axis
    assert port["serve_cache_shard_dims"].tolist() == [1, 2]
    assert port["serve_float32_pos"].tolist() == [64.0]


def test_cp_prefill_runs_and_matches_local_and_reference(runs):
    ref, port = runs
    _close(port["cp_prefill_float32_sharded"],
           port["cp_prefill_float32_local"], 1e-5)
    _close(port["cp_prefill_float32_cache_sharded"],
           port["cp_prefill_float32_cache_local"], 1e-5)
    _close(port["cp_prefill_bfloat16_sharded"], ref["cp"], 5e-2)


def test_ep_moe_matches_local_and_reference(runs):
    ref, port = runs
    _close(port["ep_moe_float32_ep"], port["ep_moe_float32_local"], 1e-5)
    _close(port["ep_moe_float32_aux_ep"], port["ep_moe_float32_aux_local"],
           1e-6)
    _close(port["ep_moe_bfloat16_ep"], ref["moe"], 3e-2)
    _close(port["ep_moe_bfloat16_aux_ep"], ref["moe_aux"], 1e-3)
    for k in ("x", "router", "w_gate", "w_up", "w_down"):
        want = port[f"ep_moe_grad_{k}_local"]
        _close(port[f"ep_moe_grad_{k}_ep"], want,
               1e-5 * max(1.0, float(np.abs(want).max())))
    for dtype in ("float32", "bfloat16"):
        np.testing.assert_array_equal(port[f"ep_moe_{dtype}_handoff"],
                                      port[f"ep_moe_{dtype}_ep"])
        np.testing.assert_array_equal(port[f"ep_moe_{dtype}_aux_handoff"],
                                      port[f"ep_moe_{dtype}_aux_ep"])


def test_hybrid_model_serves_under_a_policy(runs):
    _, port = runs
    _close(port["hybrid_sharded"], port["hybrid_local"], 1e-5)
    _close(port["hybrid_step_sharded"], port["hybrid_step_local"], 1e-5)
