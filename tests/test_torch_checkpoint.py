"""Ports of the reference's checkpoint tests (``tests/test_fault_
tolerance.py``): round trip (bf16 leaves stored as float32 and cast
back), atomic commit and garbage collection, a shape mismatch refused;
and the on-disk layout, which is the reference's (``step_XXXXXXXX/
leaf_NNNNN.npy`` and ``manifest.json``): a checkpoint the reference wrote
restores into the port's tree."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import checkpoint as jckpt

from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import adamw_init


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b.c": torch.ones((2,), dtype=torch.bfloat16),
            "b.d.0": torch.zeros((5,)), "b.d.1": torch.full((1,), 7)}
    ckpt.save_checkpoint(tmp_path, 3, tree)
    restored = ckpt.restore_checkpoint(tmp_path, tree)
    assert list(restored) == list(tree)
    for name, x in tree.items():
        y = restored[name]
        assert y.dtype == x.dtype and y.shape == x.shape
        np.testing.assert_array_equal(x.float().numpy(), y.float().numpy())
    meta = json.loads((tmp_path / "step_00000003" / "manifest.json")
                      .read_text())
    assert meta["names"] == list(tree) and meta["n_leaves"] == 4
    assert [l["dtype"] for l in meta["leaves"]] == [
        "float32", "bfloat16", "float32", "int64"]
    assert np.load(tmp_path / "step_00000003" / "leaf_00001.npy").dtype \
        == np.float32


def test_checkpoint_atomic_and_gc(tmp_path):
    tree = {"w": torch.ones((4,))}
    for s in (1, 2, 3, 4, 5):
        ckpt.save_checkpoint(tmp_path, s, tree, keep=2)
    steps = sorted(p.name for p in tmp_path.glob("step_*"))
    assert steps == ["step_00000004", "step_00000005"]
    assert ckpt.latest_step(tmp_path) == 5
    assert not list(tmp_path.glob(".tmp*")), "staging dir left behind"


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    ckpt.save_checkpoint(tmp_path, 1, {"w": torch.ones((4,))})
    with pytest.raises(ValueError, match="leaf 0"):
        ckpt.restore_checkpoint(tmp_path, {"w": torch.ones((5,))})
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore_checkpoint(tmp_path, {"w": torch.ones((4,)),
                                           "v": torch.ones((4,))})
    with pytest.raises(ValueError, match="not the expected"):
        ckpt.restore_checkpoint(tmp_path, {"v": torch.ones((4,))})
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(tmp_path / "none", {"w": torch.ones((4,))})


def test_restore_onto_a_device_and_dtype(tmp_path):
    ckpt.save_checkpoint(tmp_path, 2, {"w": torch.arange(4.0)})
    like = {"w": torch.zeros(4, dtype=torch.bfloat16)}
    out = ckpt.restore_checkpoint(tmp_path, like, device="cpu")
    assert out["w"].dtype == torch.bfloat16 and out["w"].device.type == "cpu"
    assert out["w"].tolist() == [0.0, 1.0, 2.0, 3.0]


def test_a_reference_checkpoint_restores_into_the_port(tmp_path):
    """The same layout: the reference's leaves in its pytree order (dict
    keys sorted) read into a port tree named in that order."""
    jtree = {"a": jnp.arange(6.0).reshape(2, 3),
             "b": jnp.ones((4,), jnp.bfloat16)}
    jckpt.save_checkpoint(tmp_path, 9, jtree)
    like = {"a": torch.zeros(2, 3), "b": torch.zeros(4, dtype=torch.bfloat16)}
    meta = json.loads((tmp_path / "step_00000009" / "manifest.json")
                      .read_text())
    meta["names"] = list(like)   # the reference records no names
    (tmp_path / "step_00000009" / "manifest.json").write_text(
        json.dumps(meta))
    out = ckpt.restore_checkpoint(tmp_path, like)
    assert out["a"].tolist() == [[0, 1, 2], [3, 4, 5]]
    assert out["b"].dtype == torch.bfloat16 and out["b"].tolist() == [1] * 4


def test_optimizer_state_flattens_and_restores(tmp_path):
    params = {"x": torch.ones(3), "y": torch.ones(2, 2)}
    opt = adamw_init(params)
    opt = opt._replace(step=opt.step + 4,
                       m={k: t + 1 for k, t in opt.m.items()})
    flat = ckpt.flatten_opt(opt)
    assert list(flat) == ["step", "m.x", "m.y", "v.x", "v.y"]
    ckpt.save_checkpoint(tmp_path, 4, flat)
    back = ckpt.unflatten_opt(ckpt.restore_checkpoint(
        tmp_path, ckpt.flatten_opt(adamw_init(params))))
    assert int(back.step) == 4 and back.step.dtype == torch.int32
    assert list(back.m) == ["x", "y"]
    assert back.m["y"].tolist() == [[1, 1], [1, 1]]
    assert back.v["x"].tolist() == [0, 0, 0]
