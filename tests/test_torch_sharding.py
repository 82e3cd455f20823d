"""The port's sharding specs against the reference's, tuple for tuple, for
all eleven archs at full width, shape only (nothing is allocated), on the
(1, 1), (2, 4), (16, 16) and (2, 16, 16) meshes under each flag set.

The reference's spec functions read only ``mesh.shape``, so its side
takes a duck mesh; the port's side a ``DeviceMesh`` over a fake process
group of 1, 8, 256 or 512 ranks (``launch/mesh.py``), made for the
module and destroyed after it.  Also: the period-stack rule
(``tree_shardings`` places per-period tensors, each rank holding the
reference's share of the bytes, no leaf left replicated at these
meshes), the decode cache's specs, every activation rule and the logits
rule."""
import functools
import math
import os
import pathlib
import subprocess
import sys
import types

import jax
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs import get_config as jax_get_config
from repro.distributed import sharding as jsh
from repro.distributed import staterules as jstate
from repro.models.transformer import Model as JModel

from repro_torch.configs import ARCHS, get_config
from repro_torch.distributed import sharding as tsh
from repro_torch.distributed import staterules as tstate
from repro_torch.distributed.compat import Replicate, Shard
from repro_torch.launch.mesh import (data_axes_of, make_host_mesh,
                                     make_production_mesh, model_axes_of)
from repro_torch.models.transformer import init_cache, param_structs

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
MESHES = {"1x1": (1, 1), "2x4": (2, 4), "16x16": (16, 16),
          "2x16x16": (2, 16, 16)}
FLAGS = {"plain": {}, "opt_state": {"for_opt_state": True},
         "serving_2d": {"serving": True, "serving_2d": True},
         "serving_1d": {"serving": True, "serving_2d": False},
         "cp": {"cp_replicate_weights": True}}
# the shapes of tests/test_dryrun_unit.py's rule cases
RULE_SHAPES = [(8, 1024, 4, 128), (8, 1024, 2, 128), (1, 1024, 2, 128),
               (12, 64, 128)]


@pytest.fixture(scope="module", params=list(MESHES))
def mesh(request):
    """A DeviceMesh over a fake group of as many ranks as the mesh has."""
    shape = MESHES[request.param]
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        if len(shape) == 3:
            yield make_production_mesh(multi_pod=True)
        elif shape == (16, 16):
            yield make_production_mesh()
        else:
            yield make_host_mesh(shape[1])
    finally:
        dist.destroy_process_group()


def _duck(mesh):
    return types.SimpleNamespace(shape=dict(zip(mesh.mesh_dim_names,
                                                mesh.shape)))


def _policies(mesh, flags):
    """(reference policy, port policy, for_opt_state) for one flag set."""
    kw = dict(flags)
    for_opt = kw.pop("for_opt_state", False)
    axes = dict(data_axes=data_axes_of(mesh), model_axes=model_axes_of(mesh))
    return (jsh.ShardingPolicy(_duck(mesh), **axes, **kw),
            tsh.ShardingPolicy(mesh, **axes, **kw), for_opt)


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return jax.eval_shape(JModel(jax_get_config(arch)).init,
                          jax.random.key(0))


def _ref_tree_specs(arch, policy, for_opt):
    """{reference path: spec tuple} of the reference's tree_param_specs."""
    specs = jsh.tree_param_specs(_ref_params(arch), policy,
                                 for_opt_state=for_opt)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
    return {"/".join(jsh._key_str(k) for k in path): tuple(s)
            for path, s in flat}


def _ref_shapes(arch):
    flat = jax.tree_util.tree_flatten_with_path(_ref_params(arch))[0]
    return {"/".join(jsh._key_str(k) for k in path): leaf
            for path, leaf in flat}


def _axes(entry):
    return () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))


def _share(mesh, spec) -> int:
    """How many ranks a tensor of ``spec`` is cut over."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return math.prod(sizes[a] for e in spec for a in _axes(e))


@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("arch", ARCHS)
def test_tree_param_specs_equal_the_reference(mesh, arch, flags):
    jpol, tpol, for_opt = _policies(mesh, FLAGS[flags])
    ref = _ref_tree_specs(arch, jpol, for_opt)
    params = param_structs(get_config(arch))
    got = {}
    for name, spec in tsh.tree_param_specs(params, tpol, for_opt).items():
        got.setdefault(tsh.reference_path(name)[0], set()).add(tuple(spec))
    assert got == {path: {spec} for path, spec in ref.items()}
    # param_spec itself, leaf by leaf, at the reference's stacked shapes
    for path, leaf in _ref_shapes(arch).items():
        assert tuple(tsh.param_spec(path, leaf.shape, tpol,
                                    stacked="blocks" in path,
                                    for_opt_state=for_opt)) == ref[path]


@pytest.mark.parametrize("flags", ["plain", "opt_state", "serving_2d",
                                   "cp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_period_stack_rule_keeps_each_ranks_share(mesh, arch, flags):
    """Per-period tensors placed by ``tree_shardings`` hold, rank by rank,
    the bytes the reference's stacked leaf does: the stack dim's axis
    moves to a free dim it divides.  A leaf is left replicated over the
    axis only where no dim is free: jamba's Mamba vectors (d_inner, on
    ``model`` already) when its 9 periods take ``data``, which happens at
    (1, 1) alone, an axis of one rank (ROADMAP queue C)."""
    jpol, tpol, for_opt = _policies(mesh, FLAGS[flags])
    ref = _ref_tree_specs(arch, jpol, for_opt)
    ref_shapes = _ref_shapes(arch)
    params = param_structs(get_config(arch))
    specs, left = tsh.period_stack_placements(params, tpol, for_opt)
    expected = 189 if (arch == "jamba-1.5-large-398b" and mesh.size() == 1
                       and flags in ("opt_state", "serving_2d")) else 0
    assert len(left) == expected
    assert all(_share(mesh, (axes,)) == 1 for axes in left.values())
    shardings = tsh.tree_shardings(params, tpol, for_opt)
    per_rank = {}
    for name, t in params.items():
        spec = specs[name]
        assert len(spec) == t.dim()
        assert all(t.shape[d] % _share(mesh, (e,)) == 0
                   for d, e in enumerate(spec))
        pl = shardings[name].placements
        assert len(pl) == mesh.ndim
        for axis, p in zip(mesh.mesh_dim_names, pl):
            dims = [d for d, e in enumerate(spec) if axis in _axes(e)]
            assert p == (Shard(dims[0]) if dims else Replicate())
        path = tsh.reference_path(name)[0]
        per_rank[path] = per_rank.get(path, 0) + \
            t.numel() * t.element_size() // _share(mesh, spec)
    for name, t in params.items():  # the stacked leaf, in the port's dtype
        path = tsh.reference_path(name)[0]
        stacked = math.prod(ref_shapes[path].shape) * t.element_size()
        assert per_rank[path] == stacked // _share(mesh, ref[path]), path


def test_period_spec_leaves_an_axis_no_dim_divides():
    duck = types.SimpleNamespace(shape={"data": 16, "model": 16})
    assert tsh.period_spec(tsh.P("data", None), (3,), duck) == \
        (tsh.P(None), ("data",))
    assert tsh.period_spec(tsh.P("data", None, "model"), (48, 32), duck) == \
        (tsh.P("data", "model"), ())
    assert tsh.period_spec(tsh.P(None, "model"), (32,), duck) == \
        (tsh.P("model"), ())


@pytest.mark.parametrize("batch", [8, 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cache_specs_equal_the_reference(mesh, arch, batch):
    jpol, tpol, _ = _policies(mesh, {})
    jmodel = JModel(jax_get_config(arch))
    jcache = jax.eval_shape(lambda: jmodel.init_cache(batch, 1024))
    ref = jstate.decode_cache_specs(jpol, jcache)
    cache = init_cache(get_config(arch), batch, 1024, None, "meta")
    got = tstate.decode_cache_specs(tpol, cache)

    def tuples(states):
        return None if states is None else [
            None if st is None else [tuple(s) for s in st] for st in states]

    assert tuples(got.blocks) == tuples(ref.blocks)
    assert tuples(got.cross) == tuples(ref.cross)
    assert tuple(got.pos_t) == tuple(ref.pos) == ()
    named = tstate.decode_cache_shardings(tpol, cache)
    for st, st_spec in zip(named.blocks, got.blocks):
        for n, s in zip(st, st_spec):
            assert n.mesh is mesh and n.spec == s


@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("rule", list(jsh.DEFAULT_RULES))
def test_activation_rules_equal_the_reference(mesh, rule, flags):
    jpol, tpol, _ = _policies(mesh, FLAGS[flags])
    assert tsh.DEFAULT_RULES[rule] == jsh.DEFAULT_RULES[rule]
    for shape in RULE_SHAPES:
        assert tuple(tpol.resolve(rule, shape)) == \
            tuple(jpol.resolve(rule, shape))
        assert tpol.named(rule, shape).placements == tsh.placements(
            mesh, tpol.resolve(rule, shape))


def test_resolve_logits_equals_the_reference(mesh):
    jpol, tpol, _ = _policies(mesh, {})
    for shape in [(8, 1, 128_256), (1, 1, 128_256), (8, 64, 152_064),
                  (6, 51_865), (32, 1, 100)]:
        assert tuple(tpol.resolve_logits(shape)) == \
            tuple(jpol.resolve_logits(shape))


def test_constrain_is_the_identity_without_a_policy_or_a_dtensor(mesh):
    x = torch.zeros(8, 16, 32)
    assert tsh.constrain(x, "act_btd") is x
    with tsh.use_policy(tsh.ShardingPolicy(mesh)):
        assert tsh.constrain(x, "act_btd") is x
    assert tsh.get_policy() is None


def test_meshes_refuse_the_wrong_world(mesh):
    if mesh.size() != 256:
        with pytest.raises(RuntimeError, match="needs 256 ranks"):
            make_production_mesh()
    if mesh.size() != 512:
        with pytest.raises(RuntimeError, match="needs 512 ranks"):
            make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="does not divide"):
        make_host_mesh(3)


def test_placements_of_a_multi_axis_entry_follow_the_mesh_order():
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert tsh.placements(mesh, tsh.P(("pod", "data"), "model")) == \
        (Shard(0), Shard(0), Shard(1))
    assert tsh.placements(mesh, tsh.P(None, "data")) == \
        (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="axis order"):
        tsh.placements(mesh, tsh.P(("data", "pod")))


def test_meshes_need_a_process_group():
    code = ("from repro_torch.launch.mesh import make_host_mesh\n"
            "try:\n    make_host_mesh(1)\n"
            "except RuntimeError as e:\n    print(e)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    assert "needs an initialised process group" in out.stdout, out.stderr
