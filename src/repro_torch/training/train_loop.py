"""Trainer: an eager step (loss, backward, AdamW) plus checkpoint/restart
and straggler accounting, as the reference package's
``training/train_loop.py`` runs without a sharding policy.

Fault tolerance drill: kill the process at any step, rerun the same
command — the trainer resumes from the latest atomic checkpoint and the
deterministic pipeline replays the exact batch stream.

The step is eager: ``model.train_loss(batch).backward()`` through the
model's kernels and their backward kernels, then ``adamw_update`` on the
float32 parameters in place.  A ``ShardingPolicy`` (the reference's
multi-device step, ``launch/steps.py::build_train_step``) is not ported
yet (ROADMAP item 18).
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
from repro_torch.models.transformer import Model
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_init, adamw_update)
from repro_torch.training.straggler import StragglerMonitor


@dataclasses.dataclass
class TrainConfig:
    total_steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = "checkpoints"
    log_every: int = 10
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


class Trainer:
    """``Trainer(model, shape, None, tcfg).run()`` trains ``model`` (a
    ``Model`` whose parameters ``init_state`` draws) on ``pipeline``'s
    batches (default: ``SyntheticPipeline(model.cfg, shape)``) on
    ``device`` (None: the GPU, which must be there)."""

    def __init__(self, model: Model, shape: ShapeSpec, policy, tcfg:
                 TrainConfig, pipeline: Optional[SyntheticPipeline] = None,
                 device=None):
        if policy is not None:
            raise NotImplementedError(
                "the torch Trainer runs one device; a ShardingPolicy (the "
                "reference's launch/steps.py::build_train_step) is ROADMAP "
                "item 18")
        self.device = resolve_device(device)
        self.model = model
        self.shape = shape
        self.tcfg = tcfg
        self.pipeline = pipeline or SyntheticPipeline(model.cfg, shape)
        self.monitor = StragglerMonitor()
        self.history: list = []

    # -- state ----------------------------------------------------------------
    def init_state(self, seed: int = 0):
        """(params, AdamW state): the model's parameters drawn from a
        generator seeded with ``seed`` on the trainer's device, float32,
        as a name -> tensor dict."""
        gen = torch.Generator(self.device).manual_seed(seed)
        self.model.init(gen, train=True)
        params = dict(self.model.named_parameters())
        return params, adamw_init(params)

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
                                         device=self.device)
        opt = ckpt.unflatten_opt(ckpt.restore_checkpoint(
            pathlib.Path(self.tcfg.ckpt_dir) / "opt", ckpt.flatten_opt(opt),
            device=self.device))
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
        for p in params.values():
            p.grad = None
        loss = self.model.train_loss(batch)
        loss.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        params, opt, metrics = adamw_update(self.tcfg.opt, params, grads, opt)
        return params, opt, loss.detach(), metrics

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
            loss = float(loss)          # waits for the step's device work
            dt = time.perf_counter() - t0
            self.monitor.record(0, dt)
            self.history.append(
                dict(step=step_i, loss=loss, sec=dt,
                     grad_norm=float(metrics["grad_norm"])))
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
