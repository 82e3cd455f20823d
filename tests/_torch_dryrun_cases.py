"""Shared by ``tests/test_torch_dryrun_cells*.py``:
``launch/dryrun.py::run_cell`` over an arch's smoke config (reached by
monkeypatching the module's ``get_config``) at the four shapes, their
sequences cut to 64 (512 for ``long_500k``; the full shapes are the
sweep's, ``python -m repro_torch.launch.dryrun --all``), as rank 0 of a
fake group: status ok (``long_500k`` skipped for full-attention archs,
as the reference skips it), positive counts, the reference's record
keys, no process group left, and every ``.launches`` counter at its
value: the kernels ran as shape-only ops."""
import dataclasses

import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.configs.shapes import SHAPES, get_shape
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_host_mesh

COUNTERS = (rms_ops.rmsnorm, rms_ops.add_rmsnorm, rms_ops.rmsnorm_bwd,
            fa_ops.flash_attention, fa_ops.flash_attention_bwd,
            da_ops.decode_attention)
CUT = {"train_4k": 64, "prefill_32k": 64, "decode_32k": 64,
       "long_500k": 512}


def _cut_shape(name):
    return dataclasses.replace(get_shape(name), seq_len=CUT[name])


def _small_world(monkeypatch):
    """run_cell's production mesh replaced by a (2, 4) one over 8 ranks."""
    world = D.fake_world
    monkeypatch.setattr(D, "fake_world", lambda n: world(8))
    monkeypatch.setattr(D, "make_production_mesh",
                        lambda multi_pod, device_type: make_host_mesh(
                            4, device_type))


def check_smoke_cells(monkeypatch, arch, mesh):
    """The four shapes of ``arch``'s smoke config on ``mesh`` ("16x16" or
    "2x4"), one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _check(monkeypatch, arch, mesh)
    finally:
        torch.set_num_threads(threads)


def _check(monkeypatch, arch, mesh):
    monkeypatch.setattr(D, "get_config", get_smoke_config)
    monkeypatch.setattr(D, "get_shape", _cut_shape)
    if mesh == "2x4":
        _small_world(monkeypatch)
    before = [c.launches for c in COUNTERS]
    cfg = get_smoke_config(arch)
    for shape in SHAPES:
        rec = D.run_cell(arch, shape.name, save=False)
        if shape.name == "long_500k" and not cfg.subquadratic:
            assert rec["status"] == "skipped"
            continue
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
        mem = rec["memory"]
        assert mem["argument_size_in_bytes"] > 0
        assert mem["temp_size_in_bytes"] >= 0
        assert set(rec) >= {"arch", "shape", "mesh", "unroll_periods",
                            "policy", "lower_s", "compile_s", "flops",
                            "bytes_accessed", "memory", "collectives",
                            "method"}
    assert not dist.is_initialized()
    assert [c.launches for c in COUNTERS] == before


