"""Assigned input-shape grid. Each shape names the step it lowers.

A copy of the reference package's ``configs/shapes.py``: the port keeps
its own because it imports nothing of the reference."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
)


def get_shape(name: str) -> ShapeSpec:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def cell_applicable(cfg, shape: ShapeSpec) -> Tuple[bool, str]:
    """(runs?, reason). long_500k only for sub-quadratic decoders."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "full-attention arch: 512k dense-KV decode skipped per assignment"
    return True, ""
