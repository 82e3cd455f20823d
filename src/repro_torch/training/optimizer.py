"""Hand-rolled AdamW and its schedule, expression for expression as the
reference package's ``training/optimizer.py``.

The reference computes these in jnp outside any kernel; here they are
plain tensor code.  Parameters, gradients and the moments are dicts keyed
by parameter name (``Model.named_parameters()``); the moments are float32
whatever the parameters' dtype.  ``adamw_update`` writes the parameters
in place (the reference donates their buffers to its jitted step) and
returns new moment tensors; it is a profiler range (``adamw_update``),
which a traced training step reads to attribute its device time.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor              # int32 scalar, on the parameters' device
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def adamw_init(params: Dict[str, torch.Tensor]) -> AdamWState:
    device = next(iter(params.values())).device
    zeros = {k: torch.zeros_like(p, dtype=torch.float32)
             for k, p in params.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=zeros,
                      v={k: torch.zeros_like(z) for k, z in zeros.items()})


def lr_schedule(cfg: AdamWConfig, step):
    """Linear warm-up, then a cosine down to ``min_lr_ratio``; float32 as
    the reference computes it."""
    step = step.float()
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree: Dict[str, torch.Tensor]):
    """sqrt of the sum over leaves (in the dict's order) of each leaf's sum
    of squares in float32."""
    sq = [torch.sum(torch.square(g.float())) for g in tree.values()]
    total = sq[0]
    for s in sq[1:]:
        total = total + s
    return torch.sqrt(total)


@torch.no_grad()
@torch.profiler.record_function("adamw_update")
def adamw_update(cfg: AdamWConfig, params: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor], state: AdamWState):
    """One AdamW step with global-norm clipping.  Writes each parameter in
    place (rounded back to its dtype) and returns (params, new state,
    {"grad_norm", "lr"})."""
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    new_m, new_v = {}, {}
    for k, p in params.items():
        g = grads[k].float() * scale
        m2 = cfg.b1 * state.m[k] + (1 - cfg.b1) * g
        v2 = cfg.b2 * state.v[k] + (1 - cfg.b2) * g * g
        delta = (m2 / b1c) / (torch.sqrt(v2 / b2c) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        new_m[k], new_v[k] = m2, v2
    return params, AdamWState(step=step, m=new_m, v=new_v), {
        "grad_norm": gnorm, "lr": lr}
