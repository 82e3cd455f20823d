"""Trainer: an eager step (loss, backward, AdamW) plus checkpoint/restart
and straggler accounting, as the reference package's
``training/train_loop.py``.

Fault tolerance drill: kill the process at any step, rerun the same
command — the trainer resumes from the latest atomic checkpoint and the
deterministic pipeline replays the exact batch stream.

The step is eager: ``model.train_loss(batch).backward()`` through the
model's kernels and their backward kernels, then ``adamw_update`` on the
float32 parameters in place (``launch/steps.py::train_step_fn``).  With a
``ShardingPolicy`` it is the reference's multi-device step
(``launch/steps.py::build_train_step``): parameters and the ZeRO-1
optimizer state are DTensors placed by ``tree_shardings``, each step
runs under the policy, and checkpoints hold the full tensors.
"""
from __future__ import annotations

import dataclasses
import pathlib
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.device import resolve_device
from repro_torch.distributed.compat import DTensor
from repro_torch.launch.steps import (build_train_step, place, sharded_step,
                                      train_step_fn)
from repro_torch.models.transformer import Model
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_init)
from repro_torch.training.straggler import StragglerMonitor


@dataclasses.dataclass
class TrainConfig:
    total_steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = "checkpoints"
    log_every: int = 10
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


def _host(t) -> float:
    """A replicated scalar's value on the host."""
    return float(t.to_local() if isinstance(t, DTensor) else t)


class Trainer:
    """``Trainer(model, shape, policy, tcfg).run()`` trains ``model`` (a
    ``Model`` whose parameters ``init_state`` draws) on ``pipeline``'s
    batches (default: ``SyntheticPipeline(model.cfg, shape)``) on
    ``device`` (None: the GPU, which must be there); ``policy`` None runs
    one device, a ``ShardingPolicy`` its mesh, from an initialised process
    group (every rank runs the same command)."""

    def __init__(self, model: Model, shape: ShapeSpec, policy, tcfg:
                 TrainConfig, pipeline: Optional[SyntheticPipeline] = None,
                 device=None):
        self.device = resolve_device(device)
        self.model = model
        self.shape = shape
        self.policy = policy
        self.tcfg = tcfg
        self.pipeline = pipeline or SyntheticPipeline(model.cfg, shape)
        self.monitor = StragglerMonitor()
        self.history: list = []
        if policy is not None:
            step, in_sh, out_sh, _ = build_train_step(model, policy, shape,
                                                      tcfg.opt)
            self._p_shard, self._o_shard = in_sh[0], in_sh[1]
            self._step = sharded_step(policy, step, in_sh, out_sh)
        else:
            self._p_shard = self._o_shard = None
            self._step = train_step_fn(model, tcfg.opt)

    # -- state ----------------------------------------------------------------
    def init_state(self, seed: int = 0):
        """(params, AdamW state): the model's parameters drawn from a
        generator seeded with ``seed`` on the trainer's device, float32,
        as a name -> tensor dict; placed by the policy, if any."""
        gen = torch.Generator(self.device).manual_seed(seed)
        self.model.init(gen, train=True)
        params = dict(self.model.named_parameters())
        return self.place(params, adamw_init(params))

    def place(self, params, opt: AdamWState):
        """``(params, opt)`` at the policy's placements (parameters by
        ``tree_shardings``, the moments by its ZeRO-1 variant), each the
        same on every rank before; as they are without a policy."""
        if self.policy is None:
            return params, opt
        return place(params, self._p_shard), place(opt, self._o_shard)

    def _adopt(self, params: Dict[str, torch.Tensor]):
        """Makes ``params`` the model's trainable parameters; returns them
        as the model holds them."""
        held = dict(self.model.named_parameters())
        if not self.model.trainable or any(held.get(k) is not t
                                           for k, t in params.items()):
            self.model.load(params, train=True)
        return dict(self.model.named_parameters())

    def try_restore(self, params, opt: AdamWState):
        last = ckpt.latest_step(self.tcfg.ckpt_dir)
        if last is None:
            return params, opt, 0
        params = ckpt.restore_checkpoint(self.tcfg.ckpt_dir, params,
                                         device=self.device,
                                         shardings=self._p_shard)
        opt = ckpt.unflatten_opt(ckpt.restore_checkpoint(
            pathlib.Path(self.tcfg.ckpt_dir) / "opt", ckpt.flatten_opt(opt),
            device=self.device, shardings=None if self._o_shard is None
            else ckpt.flatten_opt(self._o_shard)))
        return params, opt, last

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """The pipeline's batch of ``step`` as tensors on the device."""
        out = {}
        for k, v in self.pipeline.batch_at(step).items():
            t = torch.from_numpy(v)
            out[k] = (t.long() if k in ("tokens", "labels") else t).to(
                self.device)
        return out

    def step(self, params, opt: AdamWState, batch):
        """One training step on the model's parameters ``params``: returns
        (params, opt, loss, metrics).  Each parameter's ``.grad`` holds
        this step's gradient until the next step clears it."""
        return self._step(params, opt, batch)

    # -- loop -------------------------------------------------------------------
    def run(self, seed: int = 0,
            on_step: Optional[Callable[[int, float], None]] = None):
        params, opt = self.init_state(seed)
        params, opt, start = self.try_restore(params, opt)
        params = self._adopt(params)
        for step_i in range(start, self.tcfg.total_steps):
            batch = self.batch(step_i)
            t0 = time.perf_counter()
            params, opt, loss, metrics = self.step(params, opt, batch)
            loss = _host(loss)          # waits for the step's device work
            dt = time.perf_counter() - t0
            self.monitor.record(0, dt)
            self.history.append(
                dict(step=step_i, loss=loss, sec=dt,
                     grad_norm=_host(metrics["grad_norm"])))
            if on_step:
                on_step(step_i, loss)
            if (step_i + 1) % self.tcfg.log_every == 0:
                print(f"[train] step={step_i + 1} loss={loss:.4f} "
                      f"({dt:.2f}s/step)")
            if (step_i + 1) % self.tcfg.ckpt_every == 0 or \
                    step_i + 1 == self.tcfg.total_steps:
                ckpt.save_checkpoint(self.tcfg.ckpt_dir, step_i + 1, params)
                ckpt.save_checkpoint(
                    pathlib.Path(self.tcfg.ckpt_dir) / "opt", step_i + 1,
                    ckpt.flatten_opt(opt))
        return params, opt
