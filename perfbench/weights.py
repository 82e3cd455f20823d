"""Weights drawn from the run's seed, on the device, in the type they are
served in, in a few large calls.

The scale is a frozen copy of the port's init scheme (``models/layers.py::
dense_init``): each matrix N(0, 1 / fan_in) cut at 2 sigma, the fan-in
axis of each kind of matrix named in the configuration file's ``init``.
Two departures, so that the check covers them: biases are drawn (the port
draws zeros), and norm scales are drawn about 1 (the port sets ones).
Every matrix of one scale lies in one flat buffer, drawn in chunks; each
parameter is a view of it, so ``Model.load`` takes them without a copy.
The reference reads the same tensors, so ``digest`` and ``changed`` show
whether the program wrote to them.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

CHUNK = 1 << 28   # elements drawn a call: 512 MB in bf16
SAMPLES = 1024    # elements a tensor's digest keeps


def seed64(seed: int) -> int:
    """The run's seed as a 64-bit generator seed (any whole number)."""
    return seed % (1 << 64)


def _kind(name: str, shape, rules: dict) -> Tuple[str, float]:
    key = name.rpartition(".")[2]
    if key in rules["scales"]:
        return "scale", rules["scale_std"]
    if key in rules["biases"]:
        return "bias", rules["bias_std"]
    axes = rules["fan_in_axis"]
    if key not in axes:
        raise KeyError(f"{name}: no init rule for {key!r} in the "
                       f"configuration file")
    return "matrix", 1.0 / math.sqrt(max(shape[axes[key]], 1))


def draw(structs: Dict[str, Tuple[tuple, torch.dtype]], rules: dict,
         seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter of ``structs`` (name -> (shape, dtype)) drawn from
    ``seed`` on ``device``: matrices std * clip(N(0, 1), +-clip), biases
    bias_std * the same, norm scales 1 + scale_std * the same."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed64(seed))
    groups: Dict[tuple, list] = {}
    for name in sorted(structs):
        shape, dtype = structs[name]
        kind, std = _kind(name, shape, rules)
        groups.setdefault((kind, std, dtype), []).append((name, shape))
    clip = rules["clip"]
    out = {}
    for (kind, std, dtype), members in sorted(
            groups.items(), key=lambda kv: (kv[0][0], kv[0][1],
                                            str(kv[0][2]))):
        total = sum(math.prod(shape) for _, shape in members)
        flat = torch.empty(total, dtype=dtype, device=device)
        for i in range(0, total, CHUNK):
            part = flat[i:i + CHUNK]
            part.normal_(generator=gen).clamp_(-clip, clip).mul_(std)
            if kind == "scale":
                part.add_(1.0)
        at = 0
        for name, shape in members:
            n = math.prod(shape)
            out[name] = flat[at:at + n].view(shape)
            at += n
    return out


def digest(weights: Dict[str, torch.Tensor]) -> Dict[str, tuple]:
    """A cheap fingerprint of each tensor: its float32 sum and SAMPLES of
    its elements spread evenly over it."""
    out = {}
    for name, t in weights.items():
        flat = t.reshape(-1)
        step = max(1, flat.numel() // SAMPLES)
        out[name] = (flat.sum(dtype=torch.float32), flat[::step].clone())
    return out


def changed(weights: Dict[str, torch.Tensor], before: Dict[str, tuple]
            ) -> int:
    """How many tensors of ``weights`` no longer match ``before``."""
    now = digest(weights)
    return sum(not (torch.equal(now[n][0], s) and torch.equal(now[n][1], p))
               for n, (s, p) in before.items())
