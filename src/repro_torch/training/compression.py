"""Gradient compression for the slow (cross-pod) axis.

int8 quantization with per-leaf scales and *error feedback* [Seide et al.,
1-bit SGD; Karimireddy et al. EF-SGD]: the quantization residual is carried
into the next step so compression error doesn't bias convergence.  The
reference applies it only to the pod-axis all-reduce in multi-pod
training, which the port does not run yet (ROADMAP item 18); the functions
are here, expression for expression, for that path.

Trees are dicts of tensors keyed by parameter name, as the trainer holds
gradients.  The arithmetic is the reference's IEEE fp32 division and
round-half-to-even, so the int8 values and scales are its bits.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch


class EFState(NamedTuple):
    residual: Dict[str, torch.Tensor]   # like grads, float32


def init_ef_state(grads_like: Dict[str, torch.Tensor]) -> EFState:
    return EFState(residual={k: torch.zeros_like(g, dtype=torch.float32)
                             for k, g in grads_like.items()})


def quantize_int8(x) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    scale = torch.clamp_min(xf.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def compress_with_feedback(grads: Dict[str, torch.Tensor], ef: EFState):
    """Returns ({name: (q, scale)}, new EFState)."""
    corrected = {k: g.float() + ef.residual[k] for k, g in grads.items()}
    q_tree = {k: quantize_int8(c) for k, c in corrected.items()}
    new_resid = {k: c - dequantize_int8(*q_tree[k])
                 for k, c in corrected.items()}
    return q_tree, EFState(residual=new_resid)


def decompress(q_tree):
    return {k: dequantize_int8(*qs) for k, qs in q_tree.items()}
