"""Fault-tolerant checkpoints, in the reference package's on-disk layout.

Format: one directory per step, ``step_XXXXXXXX/``, holding one
``leaf_NNNNN.npy`` per tensor and a JSON manifest (step, leaf count, each
leaf's shape and dtype, and here the leaves' names in order).  Writes go
to a ``.tmp_step_XXXXXXXX`` staging directory that is renamed on
completion, so a crashed save can never corrupt the latest checkpoint;
only the newest ``keep`` steps stay.  bf16 leaves are stored as float32
(numpy has no bf16) and cast back on restore.

A tree is a dict of tensors keyed by name, in the order the leaves are
written (``Model.named_parameters()`` order; ``flatten_opt`` for the
optimizer state).  Restore reads into the names, shapes and dtypes of a
``like`` dict, onto a given device.
"""
from __future__ import annotations

import json
import pathlib
import shutil
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.training.optimizer import AdamWState

MANIFEST = "manifest.json"


def save_checkpoint(ckpt_dir, step: int, tree: Dict[str, torch.Tensor],
                    keep: int = 3) -> pathlib.Path:
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    meta = {"step": step, "n_leaves": len(tree), "names": list(tree),
            "leaves": []}
    for i, leaf in enumerate(tree.values()):
        t = leaf.detach()
        orig_dtype = str(t.dtype).replace("torch.", "")
        if not t.dtype.is_floating_point or t.dtype in (torch.float32,
                                                        torch.float64):
            arr = t.cpu().numpy()
        else:  # bf16, fp16, ...: persist as f32
            arr = t.float().cpu().numpy()
        np.save(tmp / f"leaf_{i:05d}.npy", arr)
        meta["leaves"].append({"shape": list(arr.shape),
                               "dtype": orig_dtype})
    (tmp / MANIFEST).write_text(json.dumps(meta))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                     # atomic commit
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: pathlib.Path, keep: int) -> None:
    steps = sorted(p for p in ckpt_dir.glob("step_*") if p.is_dir())
    for p in steps[:-keep]:
        shutil.rmtree(p)


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = pathlib.Path(ckpt_dir)
    steps = sorted(ckpt_dir.glob("step_*"))
    if not steps:
        return None
    return int(steps[-1].name.split("_")[1])


def restore_checkpoint(ckpt_dir, like: Dict[str, torch.Tensor],
                       step: Optional[int] = None,
                       device=None) -> Dict[str, torch.Tensor]:
    """The checkpoint at ``step`` (default the latest) as a dict with
    ``like``'s names, shapes and dtypes, on ``device`` (default each
    ``like`` tensor's own).  Raises if the names or a shape differ."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    meta = json.loads((d / MANIFEST).read_text())
    if meta["n_leaves"] != len(like):
        raise ValueError(f"checkpoint has {meta['n_leaves']} leaves, model "
                         f"expects {len(like)}")
    if meta["names"] != list(like):
        raise ValueError(f"checkpoint leaves {meta['names'][:4]}... are not "
                         f"the expected {list(like)[:4]}...")
    out = {}
    for i, (name, ref) in enumerate(like.items()):
        arr = np.load(d / f"leaf_{i:05d}.npy")
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {i} ({name}): ckpt {arr.shape} vs model "
                             f"{tuple(ref.shape)}")
        out[name] = torch.from_numpy(arr).to(
            device=ref.device if device is None else device, dtype=ref.dtype)
    return out


def flatten_opt(opt: AdamWState) -> Dict[str, torch.Tensor]:
    """An AdamW state as one tree: ``step``, then ``m.<name>`` and
    ``v.<name>`` in parameter order."""
    return {"step": opt.step, **{f"m.{k}": t for k, t in opt.m.items()},
            **{f"v.{k}": t for k, t in opt.v.items()}}


def unflatten_opt(tree: Dict[str, torch.Tensor]) -> AdamWState:
    return AdamWState(
        step=tree["step"],
        m={k[2:]: t for k, t in tree.items() if k.startswith("m.")},
        v={k[2:]: t for k, t in tree.items() if k.startswith("v.")})
