"""The dry run (``launch/dryrun.py``, ``launch/cost.py``) on the CPU, with
nothing allocated: one rank of a fake process group traces a step over
meta tensors.

- Per-device FLOPs are counted at the local level only: a product of a
  tensor cut over a (16, 16) mesh counts 1/256 of its FLOPs, where
  ``FlopCounterMode`` counts the DTensor-level op as well.
- ``collective_stats`` on known redistributions, with the byte counts of
  the reference's ``tests/test_dryrun_unit.py`` (a gathered f32[16, 4],
  an all-reduced f32[8], a reduce-scattered bf16[32]).
- ``run_cell`` records a failure as the reference does, and saves its
  records under the reference's names (every arch's smoke config at the
  four shapes: ``tests/test_torch_dryrun_cells.py``).
- The depth-1/depth-2 extrapolation equals the full trace exactly.
- The parameters' argument bytes of full-width cells (llama3.1-8b and
  qwen2.5-32b at 16 x 16, ZeRO-1 training and serving) equal the sum of
  the shards the reference's ``tree_param_specs`` gives them (duck mesh,
  as in ``tests/test_torch_sharding.py``), and a record's arguments are
  those parameters, the cache and the tokens.
"""
import functools
import math
import types

import jax
import pytest
from _torch_dryrun_cases import _cut_shape
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as jax_get_config
from repro.distributed import sharding as jsh
from repro.models.transformer import Model as JModel

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.distributed.compat import (DTensor, Partial, Replicate,
                                            Shard, cost_analysis_dict)
from repro_torch.distributed.sharding import ShardingPolicy, tree_shardings
from repro_torch.distributed.staterules import decode_cache_shardings
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.launch import cost as C
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import (data_axes_of, make_host_mesh,
                                     make_production_mesh)
from repro_torch.launch.steps import place
from repro_torch.models.transformer import init_cache, param_structs

COUNTERS = (rms_ops.rmsnorm, rms_ops.add_rmsnorm, rms_ops.rmsnorm_bwd,
            fa_ops.flash_attention, fa_ops.flash_attention_bwd,
            da_ops.decode_attention)


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _dt(mesh, local_shape, placements, dtype=torch.float32):
    return DTensor.from_local(torch.empty(local_shape, dtype=dtype,
                                          device="meta"),
                              mesh, placements, run_check=False)


def test_local_product_counts_one_share():
    with D.fake_world(256):
        mesh = make_production_mesh(device_type="cuda")
        x = _dt(mesh, (4, 1024, 4096), (Shard(0), Replicate()),
                torch.bfloat16)
        w = _dt(mesh, (4096, 14336 // 16), (Replicate(), Shard(1)),
                torch.bfloat16)
        whole = 2 * 64 * 1024 * 4096 * 14336
        with C.StepCost() as cost:
            y = x @ w
        with FlopCounterMode(display=False) as both:
            x @ w
    assert y.placements == (Shard(0), Shard(2))
    assert cost.flops == whole // 256
    # FlopCounterMode counts the DTensor-level product: the whole of it
    assert both.get_total_flops() >= whole
    assert cost.bytes_accessed == 2 * (4 * 1024 * 4096 + 4096 * 896
                                       + 4 * 1024 * 896)
    assert cost.events == []


def test_collective_stats_of_known_redistributions():
    with D.fake_world(8):
        mesh = make_host_mesh(4, device_type="cuda")     # (data 2, model 4)
        gathered = _dt(mesh, (8, 4), (Shard(0), Replicate()))
        summed = _dt(mesh, (8,), (Replicate(), Partial()))
        scattered = _dt(mesh, (128,), (Replicate(), Partial()),
                        torch.bfloat16)
        with C.StepCost() as cost:
            gathered.redistribute(mesh, (Replicate(), Replicate()))
            summed.redistribute(mesh, (Replicate(), Replicate()))
            scattered.redistribute(mesh, (Replicate(), Shard(0)))
    stats = cost.collectives
    assert stats["all-gather"] == {"count": 1, "bytes": 256}
    assert stats["all-reduce"] == {"count": 1, "bytes": 32}
    assert stats["reduce-scatter"] == {"count": 1, "bytes": 64}
    assert sum(v["bytes"] for v in stats.values()) == 256 + 32 + 64
    assert C.collective_stats([("all-gather", 10), ("all-gather", 6),
                               ("all-to-all", 4)]) == {
        "all-gather": {"count": 2, "bytes": 16},
        "all-to-all": {"count": 1, "bytes": 4}}


def test_cost_analysis_dict_takes_the_reference_keys():
    cost = C.StepCost()
    cost.flops, cost.bytes_accessed = 7, 11
    assert cost_analysis_dict(cost) == {"flops": 7.0, "bytes accessed": 11.0}
    assert cost_analysis_dict(None) == {}


def test_run_cell_records_a_failure(monkeypatch):
    monkeypatch.setattr(D, "get_config", get_smoke_config)
    monkeypatch.setattr(D, "get_shape", _cut_shape)

    def broken(*_):
        raise ValueError("no rule")

    monkeypatch.setattr(D, "build_step", broken)
    rec = D.run_cell("qwen3-0.6b", "decode_32k", save=False)
    assert rec["status"] == "error" and rec["error"] == "ValueError: no rule"
    assert "traceback" in rec and not dist.is_initialized()


def test_records_saved_under_the_reference_names(monkeypatch, tmp_path):
    monkeypatch.setattr(D, "RESULTS", tmp_path)
    monkeypatch.setattr(D, "get_config", get_smoke_config)
    rec = D.run_cell("llama3.1-8b", "long_500k", unroll_periods=2,
                     policy_mode="baseline")
    assert rec["status"] == "skipped"
    assert [p.name for p in tmp_path.iterdir()] == [
        "llama3.1-8b__long_500k__16x16u2__pbase.json"]


def _extrapolated(u1, u2, n_periods, key):
    body = u2[key] - u1[key]
    return (u1[key] - body) + n_periods * body


@pytest.mark.parametrize("arch,shape", [("qwen3-0.6b", "prefill_32k"),
                                        ("whisper-medium", "decode_32k")])
def test_unrolled_extrapolation_equals_the_full_trace(monkeypatch, arch,
                                                      shape):
    cfg = get_smoke_config(arch).scaled(n_layers=4)
    if cfg.is_encdec:
        cfg = cfg.scaled(n_encoder_layers=4)
    monkeypatch.setattr(D, "get_config", lambda _: cfg)
    monkeypatch.setattr(D, "get_shape", _cut_shape)
    full, u1, u2 = (D.run_cell(arch, shape, unroll_periods=u, save=False)
                    for u in (0, 1, 2))
    for key in ("flops", "bytes_accessed"):
        assert _extrapolated(u1, u2, cfg.n_periods, key) == full[key]
    coll = {r["unroll_periods"]: sum(v["bytes"] for v in
                                     r["collectives"].values())
            for r in (full, u1, u2)}
    assert (coll[1] - (coll[2] - coll[1])) + cfg.n_periods * (
        coll[2] - coll[1]) == coll[0]


def _duck(mesh):
    return types.SimpleNamespace(shape=dict(zip(mesh.mesh_dim_names,
                                                mesh.shape)))


@functools.lru_cache(maxsize=None)
def _ref_leaves(arch):
    return jax.eval_shape(JModel(jax_get_config(arch)).init,
                          jax.random.key(0))


def _ref_param_bytes(arch, policy, itemsize, for_opt):
    """Per-rank bytes of the reference's parameters at its specs."""
    sizes = dict(policy.mesh.shape)
    specs = jsh.tree_param_specs(_ref_leaves(arch), policy,
                                 for_opt_state=for_opt)
    total = 0
    for leaf, spec in zip(jax.tree_util.tree_leaves(_ref_leaves(arch)),
                          jax.tree_util.tree_leaves(
                              specs, is_leaf=lambda s: isinstance(
                                  s, jax.sharding.PartitionSpec))):
        cut = math.prod(sizes[a] for e in spec if e is not None
                        for a in (e if isinstance(e, tuple) else (e,)))
        total += math.prod(leaf.shape) * itemsize // cut
    return total


@pytest.mark.parametrize("arch", ["llama3.1-8b", "qwen2.5-32b"])
def test_parameter_bytes_match_the_reference_shards(arch):
    with D.fake_world(256):
        mesh = make_production_mesh(device_type="cuda")
        cfg = get_config(arch)
        for kind in ("train", "serving"):
            serving = kind == "serving"
            serving_2d, cp = D.hillclimb(cfg, serving, 16)
            kw = dict(data_axes=data_axes_of(mesh), serving=serving,
                      serving_2d=serving_2d, cp_replicate_weights=cp)
            run_cfg = cfg.scaled(param_dtype=torch.bfloat16) \
                if serving else cfg
            params = param_structs(run_cfg, train=not serving)
            placed = place(params, tree_shardings(
                params, ShardingPolicy(mesh, **kw)))
            got = sum(C.storage_bytes(placed).values())
            want = _ref_param_bytes(arch, jsh.ShardingPolicy(_duck(mesh),
                                                             **kw),
                                    2 if serving else 4, False)
            assert got == want, (kind, got, want)
            if not serving:
                mv = place(params, tree_shardings(
                    params, ShardingPolicy(mesh, **kw), for_opt_state=True))
                assert sum(C.storage_bytes(mv).values()) == \
                    _ref_param_bytes(arch, jsh.ShardingPolicy(
                        _duck(mesh), **kw), 4, True)


def test_a_records_arguments_are_its_shards(monkeypatch):
    """llama3.1-8b decode_32k (cache cut to 64 slots): the arguments are
    the parameters' shards, the cache's and the tokens'."""
    monkeypatch.setattr(D, "get_shape", _cut_shape)
    rec = D.run_cell("llama3.1-8b", "decode_32k", save=False)
    assert rec["status"] == "ok"
    shape = _cut_shape("decode_32k")
    cfg = get_config("llama3.1-8b").scaled(param_dtype=torch.bfloat16)
    with D.fake_world(256):
        mesh = make_production_mesh(device_type="cuda")
        policy = ShardingPolicy(mesh, serving=True, serving_2d=False)
        params = param_structs(cfg)
        cache = init_cache(cfg, shape.global_batch, shape.seq_len,
                           shape.seq_len - 1, "meta")
        want = sum(C.storage_bytes(place(
            params, tree_shardings(params, policy))).values())
        want += sum(C.storage_bytes(place(
            cache, decode_cache_shardings(policy, cache))).values())
    tokens = shape.global_batch // 16 * 4
    assert rec["memory"]["argument_size_in_bytes"] == want + tokens
    assert rec["memory"]["output_size_in_bytes"] == \
        shape.global_batch // 16 * cfg.padded_vocab // 16 * 2
