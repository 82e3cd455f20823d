"""Step builders shared by the trainer and the server, the reference
package's ``launch/steps.py`` on ``torch.distributed``.

Each builder returns ``(step_fn, in_shardings, out_shardings,
arg_structs)``: the step, the ``NamedSharding`` trees of its arguments
and of its results, and its arguments' shapes and dtypes as meta tensors,
which allocate nothing (the reference's ``jax.eval_shape``).
``sharded_step(policy, step, in_shardings, out_shardings)`` is the
counterpart of ``jax.jit(step, in_shardings=..., out_shardings=...)``:
an eager call with its arguments placed before it, its results placed
after it, and the policy set while it runs.

A step runs on the model's own parameters: ``params`` is
``dict(model.named_parameters())``, and a step given other tensors loads
them into the model first.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.distributed.compat import DTensor, distribute_tensor
from repro_torch.distributed.sharding import (NamedSharding, P,
                                              ShardingPolicy, tree_shardings,
                                              use_policy)
from repro_torch.distributed.staterules import decode_cache_shardings
from repro_torch.models.io import input_specs
from repro_torch.models.transformer import Model, init_cache, param_structs
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_update)


def _structs(specs) -> dict:
    """``input_specs``' ``{name: (shape, dtype)}`` as meta tensors."""
    return {name: torch.empty(shape, dtype=dtype, device="meta")
            for name, (shape, dtype) in specs.items()}


def batch_shardings(policy: ShardingPolicy, specs) -> dict:
    """Tokens/labels shard over data on dim0; frontend embeds likewise."""
    return {name: policy.named("act_btd", s.shape)
            for name, s in specs.items()}


def _place(x, sharding: NamedSharding):
    """``x`` at ``sharding``: itself where it is already there, a DTensor
    redistributed, a plain tensor (the whole, alike on every rank)
    distributed."""
    pl = sharding.placements
    if isinstance(x, DTensor):
        if x.device_mesh == sharding.mesh and tuple(x.placements) == pl:
            return x
        return x.redistribute(sharding.mesh, pl)
    return distribute_tensor(x, sharding.mesh, pl)


def place(tree, shardings):
    """Each tensor of ``tree`` (dicts, tuples and named tuples of them)
    at its ``NamedSharding`` in the ``shardings`` tree; a leaf that is not
    a tensor (a host position, None) is kept."""
    if isinstance(shardings, NamedSharding):
        return _place(tree, shardings)
    if isinstance(tree, dict):
        return {k: place(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(place(v, s) for v, s in zip(tree, shardings)))
    if isinstance(tree, tuple):
        return tuple(place(v, s) for v, s in zip(tree, shardings))
    return tree


def sharded_step(policy: ShardingPolicy, step, in_shardings, out_shardings):
    """``step`` with each argument placed at ``in_shardings`` and each
    result at ``out_shardings``, run under ``policy``."""
    def run(*args):
        with use_policy(policy):
            return place(step(*place(args, tuple(in_shardings))),
                         out_shardings)
    return run


def _hold(model: Model, params: dict) -> dict:
    """Makes ``params`` the model's parameters unless they are; returns
    the model's parameters."""
    held = dict(model.named_parameters())
    if any(held.get(k) is not t for k, t in params.items()):
        model.load(params, train=model.trainable)
        held = dict(model.named_parameters())
    return held


def _placed_like(grad, param):
    """A DTensor gradient at its parameter's placements (a sum left
    pending by the backward reduced), as GSPMD gives a gradient its
    parameter's sharding; a plain one as it is."""
    if isinstance(grad, DTensor) and \
            tuple(grad.placements) != tuple(param.placements):
        return grad.redistribute(param.device_mesh, param.placements)
    return grad


def train_step_fn(model: Model, opt_cfg: AdamWConfig,
                  constrain_update=None):
    """The step ``(params, opt_state, batch) -> (params, opt_state, loss,
    metrics)``: the loss and its gradients by autograd through the
    model's kernels, then ``adamw_update`` in place.  Each parameter's
    ``.grad`` holds the step's gradient until the next step clears it."""
    def train_step(params, opt_state: AdamWState, batch):
        params = _hold(model, params)
        for p in params.values():
            p.grad = None
        loss = model.train_loss(batch)
        loss.backward()
        grads = {k: _placed_like(p.grad, p) if p.grad is not None
                 else torch.zeros_like(p) for k, p in params.items()}
        params, opt_state, metrics = adamw_update(
            opt_cfg, params, grads, opt_state,
            constrain_update=constrain_update)
        return params, opt_state, loss.detach(), metrics
    return train_step


def build_train_step(model: Model, policy: ShardingPolicy, shape: ShapeSpec,
                     opt_cfg: Optional[AdamWConfig] = None):
    opt_cfg = opt_cfg or AdamWConfig()
    cfg = model.cfg
    params_s = param_structs(cfg, train=True)
    mv_s = {k: torch.empty_like(t, dtype=torch.float32)
            for k, t in params_s.items()}
    opt_s = AdamWState(step=torch.empty((), dtype=torch.int32,
                                        device="meta"), m=mv_s, v=dict(mv_s))
    in_specs = _structs(input_specs(cfg, shape))

    p_shard = tree_shardings(params_s, policy)
    mv_shard = tree_shardings(params_s, policy, for_opt_state=True)

    def constrain_update(name, delta):
        # keep the fused Adam delta in the ZeRO layout -> one gather
        return _place(delta, mv_shard[name])

    replicated = NamedSharding(policy.mesh, P())
    o_shard = AdamWState(step=replicated, m=mv_shard, v=mv_shard)
    b_shard = batch_shardings(policy, in_specs)
    metric_shard = {"grad_norm": replicated, "lr": replicated}
    in_shardings = (p_shard, o_shard, b_shard)
    out_shardings = (p_shard, o_shard, replicated, metric_shard)
    args = (params_s, opt_s, in_specs)
    return (train_step_fn(model, opt_cfg, constrain_update), in_shardings,
            out_shardings, args)


def _logits_sharding(policy: ShardingPolicy, cfg, shape: ShapeSpec):
    return NamedSharding(policy.mesh, policy.resolve_logits(
        (shape.global_batch, 1, cfg.padded_vocab)))


def build_prefill_step(model: Model, policy: ShardingPolicy,
                       shape: ShapeSpec):
    cfg = model.cfg

    def prefill_step(params, batch):
        _hold(model, params)
        return model.prefill(batch["tokens"], max_len=shape.seq_len,
                             frames=batch.get("frames"),
                             patches=batch.get("patches"))

    params_s = param_structs(cfg)
    in_specs = _structs(input_specs(cfg, shape))
    p_shard = tree_shardings(params_s, policy)
    b_shard = batch_shardings(policy, in_specs)
    cache_s = init_cache(cfg, shape.global_batch, shape.seq_len, None,
                         "meta")
    c_shard = decode_cache_shardings(policy, cache_s)
    in_shardings = (p_shard, b_shard)
    out_shardings = (_logits_sharding(policy, cfg, shape), c_shard)
    args = (params_s, in_specs)
    return prefill_step, in_shardings, out_shardings, args


def build_serve_step(model: Model, policy: ShardingPolicy,
                     shape: ShapeSpec):
    """One-token decode against a seq_len-deep cache (the shape's
    ``decode_*`` semantics: one new token, KV cache of seq_len)."""
    cfg = model.cfg

    def serve_step(params, cache, tokens):
        _hold(model, params)
        return model.decode_step(cache, tokens)

    params_s = param_structs(cfg)
    cache_s = init_cache(cfg, shape.global_batch, shape.seq_len,
                         shape.seq_len - 1, "meta")
    tok_s = torch.empty((shape.global_batch, 1), dtype=torch.int32,
                        device="meta")

    p_shard = tree_shardings(params_s, policy)
    c_shard = decode_cache_shardings(policy, cache_s)
    t_shard = policy.named("act_btd", tok_s.shape)
    in_shardings = (p_shard, c_shard, t_shard)
    out_shardings = (_logits_sharding(policy, cfg, shape), c_shard)
    args = (params_s, cache_s, tok_s)
    return serve_step, in_shardings, out_shardings, args


def build_step(model: Model, policy: ShardingPolicy, shape: ShapeSpec):
    if shape.kind == "train":
        return build_train_step(model, policy, shape)
    if shape.kind == "prefill":
        return build_prefill_step(model, policy, shape)
    if shape.kind == "decode":
        return build_serve_step(model, policy, shape)
    raise ValueError(shape.kind)
