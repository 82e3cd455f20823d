"""The port's model inputs against the JAX package's: ``make_batch`` draws
the same arrays bit for bit (same seed, same order of draws, the same
rounding to the compute type) and ``input_specs`` gives the same shapes
and types, for the two stub frontends (whisper's frames, internvl2's
patches) and a text-only arch, at every kind of cell; the copied input
grid (``configs/shapes.py``, ``configs/common.py``) equals the
reference's."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import common as jcommon
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.configs import shapes as jshapes
from repro.models import io as jio

from repro_torch.configs import common as tcommon
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs import shapes as tshapes
from repro_torch.models import io as tio

ARCHS = ("whisper-medium", "internvl2-1b", "llama3.1-8b")
KINDS = ("SMOKE_TRAIN", "SMOKE_PREFILL", "SMOKE_DECODE")
_TYPES = {jnp.int32: torch.int32, jnp.float32: torch.float32,
          jnp.bfloat16: torch.bfloat16}


def _cells(kind):
    return getattr(jcommon, kind), getattr(tcommon, kind)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_make_batch_draws_the_reference_arrays(arch, kind, dtype):
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" \
        else (jnp.float32, torch.float32)
    jcfg = jax_get_smoke_config(arch).scaled(compute_dtype=jdt)
    tcfg = get_smoke_config(arch).scaled(compute_dtype=tdt)
    jshape, tshape = _cells(kind)
    want = jio.make_batch(jcfg, jshape, seed=7)
    got = tio.make_batch(tcfg, tshape, seed=7)
    assert list(got) == list(want)
    for name, t in got.items():
        w = np.asarray(want[name])
        assert tuple(t.shape) == w.shape and t.dtype == _TYPES[w.dtype.type]
        if t.dtype == torch.bfloat16:  # the same bits
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          w.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), w)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_the_reference(arch, kind):
    jshape, tshape = _cells(kind)
    for jget, tget in ((jax_get_config, get_config),
                       (jax_get_smoke_config, get_smoke_config)):
        jcfg, tcfg = jget(arch), tget(arch)
        want = jio.input_specs(jcfg, jshape)
        got = tio.input_specs(tcfg, tshape)
        assert list(got) == list(want)
        for name, (shp, dt) in got.items():
            assert shp == want[name].shape
            assert dt == _TYPES[want[name].dtype.type]


def test_draw_continues_one_stream():
    """``draw`` from one generator gives the arrays of ``make_batch`` with
    that seed first, then the next request's from the same stream."""
    cfg = get_smoke_config("internvl2-1b")
    shape = tshapes.ShapeSpec("request", cfg.n_patches + 6, 3, "prefill")
    rng = np.random.default_rng(4)
    first, second = tio.draw(cfg, shape, rng), tio.draw(cfg, shape, rng)
    batch = tio.make_batch(cfg, shape, seed=4)
    assert first["tokens"].shape == (3, 6)
    assert first["patches"].shape == (3, cfg.n_patches, cfg.d_model)
    assert torch.equal(batch["tokens"], torch.from_numpy(first["tokens"]))
    assert torch.equal(batch["patches"],
                       torch.from_numpy(first["patches"]).to(torch.bfloat16))
    assert not np.array_equal(first["patches"], second["patches"])


def test_shape_grid_copies_the_reference():
    assert [dataclasses.asdict(s) for s in tshapes.SHAPES] == \
        [dataclasses.asdict(s) for s in jshapes.SHAPES]
    for s in jshapes.SHAPES:
        assert dataclasses.asdict(tshapes.get_shape(s.name)) == \
            dataclasses.asdict(s)
        for arch in ARCHS + ("xlstm-125m",):
            assert tshapes.cell_applicable(get_config(arch), s) == \
                jshapes.cell_applicable(jax_get_config(arch), s)
    with pytest.raises(KeyError):
        tshapes.get_shape("nope")
    for kind in KINDS:
        j, t = _cells(kind)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
