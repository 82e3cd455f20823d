"""Real wall-clock benchmarking of the port's serving engine.

The paper's "custom inference benchmarking framework": sweep (ii, oo, bb),
run each combination ``reps`` times, record tokens/sec.  On the GPU it
measures the model it is given (``chip_smoke.py`` passes llama3.1-8b at
full width); with ``device="cpu"`` it runs the smoke-size model.  Output
rows feed the same ALA pipeline as the cached datasets — ALA is agnostic
to where thpt came from.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.dataset import Dataset
from repro_torch.device import resolve_device
from repro_torch.inference.engine import ServingEngine
from repro_torch.models.transformer import Model
from repro_torch.perfmodel.hardware import PROFILES

CPU_GRID_II = (16, 32, 64)
CPU_GRID_OO = (8, 16)
CPU_GRID_BB = (1, 2, 4, 8, 16)
H100 = "gpu-h100-sxm"
PRECISIONS = {torch.bfloat16: "bf16", torch.float16: "fp16",
              torch.float32: "fp32"}


def accelerator_name(device: torch.device) -> str:
    """The hardware profile name a row carries: a registered profile's
    for an H100 (``perfmodel/hardware.py``, which Alg 4's transfer reads),
    else what the device says."""
    if device.type == "cpu":
        return "cpu-host"
    name = torch.cuda.get_device_name(device)
    if "H100" not in name:
        return f"gpu-{name}"
    if H100 not in PROFILES:
        raise KeyError(f"{H100!r} is not a registered hardware profile")
    return H100


def measure_arch(arch: str, grid_ii: Optional[Sequence[int]] = None,
                 grid_oo: Optional[Sequence[int]] = None,
                 grid_bb: Optional[Sequence[int]] = None,
                 reps: int = 2, seed: int = 0, device=None,
                 model: Optional[Model] = None) -> Dataset:
    """Sweep the engine over a grid on ``device`` (None: the GPU).

    ``model`` serves as given (already on ``device``); without it the
    smoke-size ``arch`` is built from ``seed``.  A model with a stub
    frontend (whisper's frames, internvl2's patches) gets them drawn
    seeded with each request's prompts (``measure_throughput``); ``ii``
    counts the prompt's tokens, not the patches before them.  ``None`` grids fall back
    to the CPU smoke defaults.  Rows carry the registry's schema: ``acc``
    names the hardware, ``back="repro-torch"``, ``prec`` the compute type.
    """
    dev = resolve_device(device)
    grid_ii = CPU_GRID_II if grid_ii is None else tuple(grid_ii)
    grid_oo = CPU_GRID_OO if grid_oo is None else tuple(grid_oo)
    grid_bb = CPU_GRID_BB if grid_bb is None else tuple(grid_bb)
    if model is None:
        model = Model(get_smoke_config(arch)).init(
            torch.Generator(dev).manual_seed(seed))
    engine = ServingEngine(model, device=dev)
    acc = accelerator_name(dev)
    prec = PRECISIONS[model.cfg.compute_dtype]
    rows: List[Dict] = []
    for ii, oo, bb in itertools.product(grid_ii, grid_oo, grid_bb):
        for r in engine.measure_throughput(ii, oo, bb, reps=reps,
                                           seed=seed):
            rows.append(dict(model=arch, acc=acc, acc_count=1,
                             back="repro-torch", prec=prec, mode="serve",
                             ii=r["ii"], oo=r["oo"], bb=r["bb"],
                             thpt=r["thpt"]))
    return Dataset.from_rows(rows)
