"""Rank functions of the port's multi-process tests
(``test_torch_distributed.py``, ``test_torch_train_policy.py``): eight
gloo ranks on a (data 2, model 4) mesh, one intra-op thread each, a
``FileStore`` in the test's directory.

Run as ``python tests/_torch_dist_cases.py CASE DIR``: the ranks read
their inputs from DIR (written by the test) and rank 0 writes
``DIR/<CASE>.npz``.  Each case holds the port's sharded call to its local
call on the same inputs; the test compares the arrays.  Imports no JAX.
"""
import os
import shutil
import sys
import warnings

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD, MODEL = 8, 4
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(t) -> np.ndarray:
    from repro_torch.distributed.compat import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().float().numpy()


def _filled_cache(model, batch, max_len, filled, arrays):
    """A plain cache of the model's with each KV state from ``arrays``
    (``k<i>``, ``v<i>`` a period position)."""
    cache = model.init_cache(batch, max_len, filled=filled)
    for i, st in enumerate(cache.blocks):
        st.k.copy_(torch.from_numpy(arrays[f"k{i}"]))
        st.v.copy_(torch.from_numpy(arrays[f"v{i}"]))
    return cache


def serve(mesh, d):
    """qwen2.5-32b's smoke serve step (B 8, T 64) through
    ``build_serve_step`` under serving, TP-only weights: logits and the
    written cache, sharded and local, in fp32 and bf16."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.distributed.sharding import ShardingPolicy
    from repro_torch.launch.steps import build_serve_step, sharded_step
    from repro_torch.models.transformer import Model

    params = torch.load(os.path.join(d, "serve_params.pt"))
    arrays = np.load(os.path.join(d, "serve_inputs.npz"))
    toks = torch.from_numpy(arrays["tokens"]).long()
    policy = ShardingPolicy(mesh, data_axes=("data",), serving=True,
                            serving_2d=False)
    shape = ShapeSpec("d", seq_len=64, global_batch=8, kind="decode")
    out = {}
    for name, dtype in DTYPES.items():
        cfg = get_smoke_config("qwen2.5-32b").scaled(compute_dtype=dtype)
        local = Model(cfg).load(params)
        cache = _filled_cache(local, 8, 64, 63, arrays)
        logits, cache = local.decode_step(cache, toks)
        model = Model(cfg).load(params)
        step, in_sh, out_sh, _ = build_serve_step(model, policy, shape)
        run = sharded_step(policy, step, in_sh, out_sh)
        sh_logits, sh_cache = run(dict(model.named_parameters()),
                                  _filled_cache(local, 8, 64, 63, arrays),
                                  toks)
        out[f"{name}_local"] = _np(logits)
        out[f"{name}_sharded"] = _np(sh_logits)
        out[f"{name}_cache_local"] = _np(cache.blocks[0].k)
        out[f"{name}_cache_sharded"] = _np(sh_cache.blocks[0].k)
        out[f"{name}_pos"] = _np(sh_cache.pos_t)
    out["cache_shard_dims"] = np.array(  # -1: replicated
        [getattr(p, "dim", -1) for p in sh_cache.blocks[0].k.placements])
    return out


def cp_prefill(mesh, d):
    """llama3.2-3b's smoke model at 6/2 heads, context-parallel prefill
    (``cp_replicate_weights``, ``serving_2d=False``; B 4, S 64) through
    ``build_step``: last-token logits and the cache, sharded and local."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.distributed.sharding import ShardingPolicy
    from repro_torch.launch.steps import build_step, sharded_step
    from repro_torch.models.transformer import Model

    params = torch.load(os.path.join(d, "cp_params.pt"))
    toks = torch.from_numpy(np.load(os.path.join(d, "cp_inputs.npz"))[
        "tokens"]).long()
    policy = ShardingPolicy(mesh, data_axes=("data",), serving=True,
                            serving_2d=False, cp_replicate_weights=True)
    shape = ShapeSpec("p", seq_len=64, global_batch=4, kind="prefill")
    out = {}
    for name, dtype in DTYPES.items():
        cfg = get_smoke_config("llama3.2-3b").scaled(
            n_heads=6, n_kv_heads=2, compute_dtype=dtype)
        logits, cache = Model(cfg).load(params).prefill(toks, max_len=64)
        model = Model(cfg).load(params)
        step, in_sh, out_sh, _ = build_step(model, policy, shape)
        sh_logits, sh_cache = sharded_step(policy, step, in_sh, out_sh)(
            dict(model.named_parameters()), {"tokens": toks})
        out[f"{name}_local"] = _np(logits)
        out[f"{name}_sharded"] = _np(sh_logits)
        out[f"{name}_cache_local"] = _np(cache.blocks[0].v)
        out[f"{name}_cache_sharded"] = _np(sh_cache.blocks[0].v)
    return out


def ep_moe(mesh, d):
    """``moe_ffn_ep`` on phi3.5-moe's smoke config at capacity factor 8
    (no token dropped), x (4, 16, d_model): output and aux loss, expert
    parallel and local; and ``moe_ffn`` under the policy, which hands
    over to it."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.ep_moe import ep_available, moe_ffn_ep
    from repro_torch.distributed.sharding import ShardingPolicy, use_policy
    from repro_torch.models import moe as moe_mod

    arrays = np.load(os.path.join(d, "moe_inputs.npz"))
    policy = ShardingPolicy(mesh, data_axes=("data",), model_axes=("model",))
    out = {}
    for name, dtype in DTYPES.items():
        cfg = get_smoke_config("phi3.5-moe-42b-a6.6b").scaled(
            capacity_factor=8.0, compute_dtype=dtype)
        assert ep_available(cfg, policy)
        params = {"router": torch.from_numpy(arrays["router"]).to(dtype),
                  "experts": {k: torch.from_numpy(arrays[k]).to(dtype)
                              for k in ("w_gate", "w_up", "w_down")}}
        x = torch.from_numpy(arrays["x"]).to(dtype)
        ref, aux_ref = moe_mod.moe_ffn(cfg, params, x)
        with use_policy(policy):
            y, aux = moe_ffn_ep(cfg, params, x, policy)
            y2, aux2 = moe_mod.moe_ffn(cfg, params, x)
        out[f"{name}_local"], out[f"{name}_aux_local"] = _np(ref), _np(aux_ref)
        out[f"{name}_ep"], out[f"{name}_aux_ep"] = _np(y), _np(aux)
        out[f"{name}_handoff"] = _np(y2)
        out[f"{name}_aux_handoff"] = _np(aux2)
    # fp32 gradients of (y * c).sum() + aux: the expert-parallel backward
    # sums each input's share over the ranks that leave it whole
    cfg = get_smoke_config("phi3.5-moe-42b-a6.6b").scaled(
        capacity_factor=8.0, compute_dtype=torch.float32)
    c = torch.from_numpy(arrays["x"]).flip(0)
    for tag, pol in (("local", None), ("ep", policy)):
        leaves = {k: torch.from_numpy(arrays[k]).requires_grad_()
                  for k in ("x", "router", "w_gate", "w_up", "w_down")}
        params = {"router": leaves["router"],
                  "experts": {k: leaves[k]
                              for k in ("w_gate", "w_up", "w_down")}}
        with use_policy(pol):
            y, aux = moe_mod.moe_ffn(cfg, params, leaves["x"])
            ((y * c).sum() + aux).backward()
        for k, t in leaves.items():
            out[f"grad_{k}_{tag}"] = _np(t.grad)
    return out


def hybrid(mesh, d):
    """jamba's smoke model (Mamba, attention, MoE blocks) in fp32 at
    capacity factor 8 under a serving policy (2D weights): a prefill (B 8,
    S 64) and a decode step through the launch steps, against the local
    calls; its MoE blocks take the expert-parallel path."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.distributed.sharding import ShardingPolicy
    from repro_torch.launch.steps import (build_prefill_step,
                                          build_serve_step, sharded_step)
    from repro_torch.models.transformer import Model

    cfg = get_smoke_config("jamba-1.5-large-398b").scaled(
        compute_dtype=torch.float32, capacity_factor=8.0)
    gen = torch.Generator().manual_seed(5)
    model = Model(cfg).init(gen)
    toks = torch.randint(0, cfg.vocab_size, (8, 64), generator=gen)
    nxt = torch.randint(0, cfg.vocab_size, (8, 1), generator=gen)
    logits, cache = model.prefill(toks, max_len=80)
    step_logits, _ = model.decode_step(cache, nxt)
    policy = ShardingPolicy(mesh, serving=True)
    pre, pre_in, pre_out, _ = build_prefill_step(
        model, policy, ShapeSpec("p", 64, 8, "prefill"))
    sh_logits, _ = sharded_step(policy, pre, pre_in, pre_out)(
        dict(model.named_parameters()), {"tokens": toks})
    srv, srv_in, srv_out, _ = build_serve_step(
        model, policy, ShapeSpec("d", 80, 8, "decode"))
    plain = Model(cfg).init(torch.Generator().manual_seed(5))
    _, filled = plain.prefill(toks, max_len=80)
    sh_step, _ = sharded_step(policy, srv, srv_in, srv_out)(
        dict(model.named_parameters()), filled, nxt)
    return {"local": _np(logits), "sharded": _np(sh_logits),
            "step_local": _np(step_logits), "step_sharded": _np(sh_step)}


def serving(mesh, d):
    return {f"{case.__name__}_{k}": v
            for case in (serve, cp_prefill, ep_moe, hybrid)
            for k, v in case(mesh, d).items()}


def train_policy(mesh, d):
    """qwen3-0.6b's smoke config in fp32: 3 AdamW steps of a Trainer under
    a ZeRO-1 policy and of a policy-free one from the same parameters and
    batches; then a policy Trainer restarted from the first one's
    checkpoints with ``shardings=``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.distributed.compat import DTensor
    from repro_torch.distributed.sharding import ShardingPolicy
    from repro_torch.models.transformer import Model
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_loop import TrainConfig, Trainer

    cfg = get_smoke_config("qwen3-0.6b").scaled(compute_dtype=torch.float32)
    shape = ShapeSpec("t", seq_len=16, global_batch=4, kind="train")
    policy = ShardingPolicy(mesh, data_axes=("data",))
    params = torch.load(os.path.join(d, "train_params.pt"))
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=3)
    if dist.get_rank() == 0:  # checkpoints of an earlier run
        for where in os.listdir(d):
            if where.startswith(("plain", "sharded", "step3", "optstep3")):
                shutil.rmtree(os.path.join(d, where))
    dist.barrier()

    def trainer(pol, where, total, ckpt_every=1000):
        t = Trainer(Model(cfg), shape, pol,
                    TrainConfig(total_steps=total, ckpt_every=ckpt_every,
                                ckpt_dir=os.path.join(d, where),
                                log_every=1000, opt=opt), device="cpu")
        t.init_state = lambda seed=0: t.place(
            {k: v.clone() for k, v in params.items()},
            adamw_init(params))
        return t

    plain = trainer(None, f"plain{dist.get_rank()}", 3)
    p_plain, _ = plain.run()
    sharded = trainer(policy, "sharded", 3, ckpt_every=2)
    p_sh, opt_sh = sharded.run()
    out = {"loss_plain": np.array([h["loss"] for h in plain.history]),
           "loss_sharded": np.array([h["loss"] for h in sharded.history]),
           "gnorm_plain": np.array([h["grad_norm"] for h in plain.history]),
           "gnorm_sharded": np.array([h["grad_norm"]
                                      for h in sharded.history])}
    names = sorted(p_plain)
    out["names"] = np.array(names)
    for i, k in enumerate(names):
        out[f"plain_{i}"], out[f"sharded_{i}"] = _np(p_plain[k]), _np(p_sh[k])
    out["all_dtensor"] = np.array(all(isinstance(t, DTensor)
                                      for t in p_sh.values()))
    out["m_shard_dims"] = np.array(
        [[getattr(p, "dim", -1) for p in opt_sh.m[k].placements]
         for k in names])
    out["p_shard_dims"] = np.array(
        [[getattr(p, "dim", -1) for p in p_sh[k].placements] for k in names])
    # restart from the step-2 checkpoint, placed by ``shardings=``
    resumed = trainer(policy, "sharded", 3)
    if dist.get_rank() == 0:
        for where in ("", "opt"):
            os.rename(os.path.join(d, "sharded", where, "step_00000003"),
                      os.path.join(d, f"{where}step3"))
    dist.barrier()
    p_re, _ = resumed.run()
    out["resumed_steps"] = np.array([h["step"] for h in resumed.history])
    for i, k in enumerate(names):
        out[f"resumed_{i}"] = _np(p_re[k])
    return out


CASES = {"serving": serving, "train_policy": train_policy}


def _rank(rank, case, d):
    torch.set_num_threads(1)
    warnings.filterwarnings("ignore")
    dist.init_process_group("gloo", rank=rank, world_size=WORLD,
                            store=dist.FileStore(os.path.join(d, "store"),
                                                 WORLD))
    try:
        from repro_torch.launch.mesh import make_host_mesh
        out = CASES[case](make_host_mesh(MODEL), d)
        if rank == 0:
            np.savez(os.path.join(d, f"{case}.npz"), **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    case, where = sys.argv[1:3]
    store = os.path.join(where, "store")
    if os.path.exists(store):  # a store is good for one group only
        os.remove(store)
    mp.start_processes(_rank, args=(case, where), nprocs=WORLD,
                       start_method="spawn")
