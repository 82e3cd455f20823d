"""Conversion of JAX-package parameters into the torch model's.

The input is the JAX ``Model.init`` pytree with numpy leaves
(``jax.tree.map(np.asarray, params)``): nested dicts, with ``blocks`` a
tuple over period positions whose leaves carry a leading ``n_periods``
axis.  The output names each tensor as ``Model.load`` expects, so both
packages compute with the same weights.  Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import flatten_params


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)  # a writable copy: JAX hands out read-only buffers
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, unknown to torch
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree, cfg: ModelConfig, device) -> Dict[str, torch.Tensor]:
    """JAX param pytree (numpy leaves) -> ``{name: tensor}`` on ``device``."""
    extra = set(tree) - {"embed", "final_norm", "blocks"}
    if extra:
        raise NotImplementedError(f"parameters {sorted(extra)} belong to "
                                  f"paths the torch model does not run")
    if len(tree["blocks"]) != len(cfg.period):
        raise ValueError(f"{len(tree['blocks'])} period positions in the "
                         f"tree, {len(cfg.period)} in {cfg.name}")
    out = {name: _tensor(a, device) for name, a in flatten_params(
        "", {"embed": tree["embed"], "final_norm": tree["final_norm"]}).items()}
    for i, block in enumerate(tree["blocks"]):
        for name, a in flatten_params("", block).items():
            if a.shape[0] != cfg.n_periods:
                raise ValueError(f"blocks[{i}].{name}: leading axis "
                                 f"{a.shape[0]} != n_periods {cfg.n_periods}")
            for p in range(cfg.n_periods):
                out[f"blocks.{p}.{i}.{name}"] = _tensor(a[p], device)
    return out
