"""Analytical LLM-serving performance simulator (roofline step-time model).

Plays the role of the paper's H100+vLLM benchmarking rig: given a model
config, an accelerator profile, a TP degree and a workload (ii, oo, bb),
it produces throughput samples with realistic saturation behaviour and
measurement noise.  The step-time terms mirror the three roofline terms of
EXPERIMENTS.md §Roofline:

  prefill:  compute-bound   2·N_active·ii·bb / (chips·peak·mfu) + attn O(ii²)
  decode:   bandwidth-bound (weights-read + KV-read)/HBM, compute, ICI
  request:  t = t_prefill + oo · t_decode;  thpt = bb·oo / t

The weights-read term amortizes over the batch — exactly the mechanism
behind the paper's saturating thpt(bb) = c − a·e^(−b·bb) observation.
MoE reads only the experts a batch activates; SSM/hybrid models replace
KV reads with O(1) state reads, giving much flatter curves.

A copy of the reference package's ``perfmodel/simulator.py``, expression
for expression, so that seeded samples (the ``bench/datasets.py`` grids)
come out bit for bit the same.  It reads the port's ``ModelConfig``,
whose ``param_count`` keeps the reference's xLSTM term.  The one change
is ``decode_time_fn``'s second namespace: ``torch`` (float64 tensors on
any device) where the reference offers ``jax.numpy``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.models.config import (FFN_MOE, MIXER_ATTN, MIXER_MAMBA,
                                       MIXER_MLSTM, MIXER_SLSTM, ModelConfig)
from repro_torch.perfmodel.hardware import HardwareProfile


@dataclasses.dataclass(frozen=True)
class ServingSetup:
    cfg: ModelConfig
    hw: HardwareProfile
    chips: int = 4            # TP degree
    framework_eff: float = 1.0  # serving-framework efficiency multiplier
    dtype_bytes: int = 2


def _per_layer_counts(cfg: ModelConfig):
    """(attn_layers, mamba_layers, slstm, mlstm, dense_ffn, moe_ffn)."""
    reps = cfg.n_periods
    attn = sum(b.mixer == MIXER_ATTN for b in cfg.period) * reps
    mamba = sum(b.mixer == MIXER_MAMBA for b in cfg.period) * reps
    sl = sum(b.mixer == MIXER_SLSTM for b in cfg.period) * reps
    ml = sum(b.mixer == MIXER_MLSTM for b in cfg.period) * reps
    dense = sum(b.ffn == "dense" for b in cfg.period) * reps
    moe = sum(b.ffn == FFN_MOE for b in cfg.period) * reps
    return attn, mamba, sl, ml, dense, moe


def kv_bytes_per_token(cfg: ModelConfig, dtype_bytes: int = 2) -> float:
    attn, *_ = _per_layer_counts(cfg)
    return attn * 2 * cfg.n_kv_heads * cfg.d_head * dtype_bytes


def state_bytes(cfg: ModelConfig, dtype_bytes: int = 2) -> float:
    """Recurrent state bytes per sequence (mamba/xlstm)."""
    _, mamba, sl, ml, _, _ = _per_layer_counts(cfg)
    di, ds = cfg.mamba_d_inner, cfg.mamba_d_state
    dp = int(cfg.xlstm_proj_factor * cfg.d_model)
    dk = dp // max(cfg.n_heads, 1)
    return (mamba * (di * ds * 4 + (cfg.mamba_d_conv - 1) * di * dtype_bytes)
            + sl * 3 * dp * 4
            + ml * (cfg.n_heads * dk * dk + cfg.n_heads * dk) * 4)


def weights_read_bytes(cfg: ModelConfig, bb: float,
                       dtype_bytes: int = 2) -> float:
    """Bytes of weights actually touched per decode step at batch bb.

    Dense layers: all weights.  MoE layers: min(E, bb·topk expected hits)
    experts (coupon-collector expectation)."""
    n_dense_equiv = cfg.param_count(active_only=False)
    attn, mamba, sl, ml, dense, moe = _per_layer_counts(cfg)
    if moe == 0:
        return n_dense_equiv * dtype_bytes
    e, k = cfg.n_experts, cfg.top_k
    expert_params = 3 * cfg.d_model * cfg.expert_d_ff
    # expected distinct experts hit by bb·k draws (uniform approx)
    draws = bb * k
    hit = e * (1 - (1 - 1 / e) ** draws)
    moe_total = moe * e * expert_params
    moe_read = moe * hit * expert_params
    return (n_dense_equiv - moe_total + moe_read) * dtype_bytes


def weight_bytes_total(setup: ServingSetup) -> float:
    """Resident parameter bytes across the whole TP group."""
    return setup.cfg.param_count(active_only=False) * setup.dtype_bytes


def kv_capacity_tokens(setup: ServingSetup) -> float:
    """KV-cache token budget: HBM across the TP group minus weights.

    Attention-free models (kv bytes/token == 0) report an effectively
    unbounded budget — their per-sequence state is O(1) and tiny."""
    budget = setup.hw.hbm_bytes * setup.chips - weight_bytes_total(setup)
    per_tok = kv_bytes_per_token(setup.cfg, setup.dtype_bytes)
    if per_tok <= 0.0:
        return float("inf")
    return max(budget, 0.0) / per_tok


def decode_step_time_group(setup: ServingSetup, contexts) -> float:
    """One decode iteration over a heterogeneous running batch.

    ``contexts`` holds each sequence's current context length (prompt +
    generated so far).  Equal contexts reduce exactly to the classic
    ``decode_step_time(setup, bb, context)``."""
    contexts = np.asarray(contexts, np.float64)
    bb = len(contexts)
    if bb == 0:
        return 0.0
    ctx_sum = float(contexts.sum())
    cfg, hw, chips = setup.cfg, setup.hw, setup.chips
    attn, mamba, sl, ml, dense, moe = _per_layer_counts(cfg)
    n_active = cfg.param_count(active_only=True)
    # compute: 2 FLOPs/param/token + attention dot products over context
    flops = 2 * n_active * bb
    flops += 2 * 2 * attn * cfg.n_heads * cfg.d_head * ctx_sum
    t_compute = flops / (chips * hw.flops_at(setup.dtype_bytes)
                         * hw.mfu_prefill)
    # memory: weights touched once + KV/state per sequence
    mem = weights_read_bytes(cfg, bb, setup.dtype_bytes)
    mem += ctx_sum * kv_bytes_per_token(cfg, setup.dtype_bytes)
    mem += bb * state_bytes(cfg, setup.dtype_bytes)
    t_mem = mem / (chips * hw.hbm_bw * hw.mfu_decode)
    # ICI: 2 all-reduces (attn+ffn) of (bb, d_model) per layer, ring cost
    coll_bytes = (2 * cfg.n_layers * bb * cfg.d_model * setup.dtype_bytes
                  * 2 * (chips - 1) / max(chips, 1))
    t_ici = coll_bytes / (hw.ici_bw * hw.ici_eff) if chips > 1 else 0.0
    # moe all-to-all
    if moe:
        t_ici += (2 * moe * bb * cfg.d_model * setup.dtype_bytes
                  / (hw.ici_bw * hw.ici_eff)) if chips > 1 else 0.0
    return max(t_compute, t_mem, t_ici) / setup.framework_eff


def decode_step_time(setup: ServingSetup, bb: float, context: float) -> float:
    return decode_step_time_group(setup, np.full(int(round(bb)), context))


def decode_time_fn(setup: ServingSetup, xp=np):
    """Vectorized closure for ``decode_step_time_group``.

    The group step time depends on the batch only through ``bb`` (its
    size) and ``ctx_sum`` (summed context lengths) — every term above is
    linear in one of the two.  The returned ``f(bb, ctx_sum)`` evaluates
    the identical expression over arrays, so for integer-valued inputs it
    matches the scalar reference to ~1 ulp (float64 sums of integers
    below 2**53 are exact).  Entries with ``bb == 0`` cost 0.

    ``xp`` selects the array namespace: the default ``numpy``, or
    ``torch`` (the fleet engine's ``traj_backend="torch"``), which
    evaluates it on float64 tensors wherever they lie.  Each operation
    is a separate eager kernel, correctly rounded, none fused into an
    FMA, so dense configs give numpy's bits; the MoE term's ``decay **
    (bb * k)`` goes through the device's ``pow``.
    """
    cfg, hw, chips = setup.cfg, setup.hw, setup.chips
    attn, mamba, sl, ml, dense, moe = _per_layer_counts(cfg)
    # float constants: exact below 2**53, and Python floats keep a
    # float64 tensor in float64
    n_active = float(cfg.param_count(active_only=True))
    kv_tok = float(kv_bytes_per_token(cfg, setup.dtype_bytes))
    st = float(state_bytes(cfg, setup.dtype_bytes))
    c_flops = 1.0 / (chips * hw.flops_at(setup.dtype_bytes)
                     * hw.mfu_prefill)
    c_mem = 1.0 / (chips * hw.hbm_bw * hw.mfu_decode)
    attn_flops = float(2 * 2 * attn * cfg.n_heads * cfg.d_head)
    coll_per_bb = (2 * cfg.n_layers * cfg.d_model * setup.dtype_bytes
                   * 2 * (chips - 1) / max(chips, 1))
    moe_per_bb = float(2 * moe * cfg.d_model * setup.dtype_bytes)
    eff = setup.framework_eff
    # weights_read_bytes, with the model constants hoisted out of the
    # closure (the fleet engine calls f thousands of times); the FP
    # expression order matches the scalar reference exactly
    n_dense_equiv = cfg.param_count(active_only=False)
    if moe == 0:
        wread_const = float(n_dense_equiv * setup.dtype_bytes)

        def wread(bb):
            return wread_const
    else:
        e, k = float(cfg.n_experts), float(cfg.top_k)
        expert_params = 3 * cfg.d_model * cfg.expert_d_ff
        moe_fixed = float(n_dense_equiv - moe * cfg.n_experts
                          * expert_params)
        moe_read_coeff = float(moe * expert_params)
        decay = 1 - 1 / e

        def wread(bb):
            hit = e * (1 - decay ** (bb * k))
            moe_read = hit * moe_read_coeff
            return (moe_fixed + moe_read) * setup.dtype_bytes

    def f(bb, ctx_sum):
        bb = xp.asarray(bb)
        ctx_sum = xp.asarray(ctx_sum)
        t_compute = (2 * n_active * bb + attn_flops * ctx_sum) * c_flops
        mem = (wread(bb) + ctx_sum * kv_tok + bb * st)
        t_mem = mem * c_mem
        if chips > 1:
            t_ici = coll_per_bb * bb / (hw.ici_bw * hw.ici_eff)
            if moe:
                t_ici = t_ici + moe_per_bb * bb / (hw.ici_bw * hw.ici_eff)
        else:
            t_ici = xp.zeros_like(t_compute)
        out = xp.maximum(xp.maximum(t_compute, t_mem), t_ici) / eff
        return xp.where(bb > 0, out, 0.0)

    return f


def prefill_step_time(setup: ServingSetup, prompt_lens) -> float:
    """One prefill iteration over a group of prompts of given lengths.

    Equal lengths reduce exactly to ``prefill_time(setup, ii, bb)``."""
    prompt_lens = np.asarray(prompt_lens, np.float64)
    if len(prompt_lens) == 0:
        return 0.0
    tok_sum = float(prompt_lens.sum())
    sq_sum = float((prompt_lens * prompt_lens).sum())
    cfg, hw, chips = setup.cfg, setup.hw, setup.chips
    attn, *_ = _per_layer_counts(cfg)
    n_active = cfg.param_count(active_only=True)
    flops = 2 * n_active * tok_sum
    flops += 2 * 2 * attn * cfg.n_heads * cfg.d_head * sq_sum / 2
    t_compute = flops / (chips * hw.flops_at(setup.dtype_bytes)
                         * hw.mfu_prefill)
    mem = (weights_read_bytes(cfg, 1e9, setup.dtype_bytes)
           + tok_sum * kv_bytes_per_token(cfg, setup.dtype_bytes))
    t_mem = mem / (chips * hw.hbm_bw * hw.mfu_decode)
    return max(t_compute, t_mem) / setup.framework_eff


def prefill_time(setup: ServingSetup, ii: float, bb: float) -> float:
    return prefill_step_time(setup, np.full(int(round(bb)), ii))


def prefill_time_fn(setup: ServingSetup):
    """Vectorized closure for ``prefill_step_time``.

    The group prefill time depends only on ``tok_sum`` (summed prompt
    lengths) and ``sq_sum`` (summed squared prompt lengths); the returned
    ``f(tok_sum, sq_sum)`` evaluates the scalar reference's expression
    over arrays (bit-exact for integer-valued sums).  Entries with
    ``tok_sum == 0`` cost 0.
    """
    cfg, hw, chips = setup.cfg, setup.hw, setup.chips
    attn, *_ = _per_layer_counts(cfg)
    n_active = cfg.param_count(active_only=True)
    kv_tok = kv_bytes_per_token(cfg, setup.dtype_bytes)
    wread = weights_read_bytes(cfg, 1e9, setup.dtype_bytes)
    c_flops = 1.0 / (chips * hw.flops_at(setup.dtype_bytes)
                     * hw.mfu_prefill)
    c_mem = 1.0 / (chips * hw.hbm_bw * hw.mfu_decode)
    attn_flops = 2 * 2 * attn * cfg.n_heads * cfg.d_head
    eff = setup.framework_eff

    def f(tok_sum, sq_sum):
        if isinstance(tok_sum, float):
            # scalar fast path: identical IEEE-double expression, no
            # array round-trip (hot in the fleet engine's prefill starts)
            if tok_sum <= 0:
                return 0.0
            t_compute = (2 * n_active * tok_sum
                         + attn_flops * sq_sum / 2) * c_flops
            t_mem = (wread + tok_sum * kv_tok) * c_mem
            return max(t_compute, t_mem) / eff
        tok_sum = np.asarray(tok_sum, np.float64)
        sq_sum = np.asarray(sq_sum, np.float64)
        t_compute = (2 * n_active * tok_sum
                     + attn_flops * sq_sum / 2) * c_flops
        t_mem = (wread + tok_sum * kv_tok) * c_mem
        out = np.maximum(t_compute, t_mem) / eff
        return np.where(tok_sum > 0, out, 0.0)

    return f


def throughput(setup: ServingSetup, ii: float, oo: float, bb: float) -> float:
    """Output tokens/sec for a batch of bb requests of (ii -> oo) tokens."""
    t_pre = prefill_time(setup, ii, bb)
    ctx = ii + oo / 2.0
    t_dec = decode_step_time(setup, bb, ctx)
    total = t_pre + oo * t_dec
    return bb * oo / total


def throughput_batch(setup: ServingSetup, ii, oo, bb) -> np.ndarray:
    """Vectorized ``throughput`` over row arrays (built on the
    ``*_time_fn`` closures, so it is a pure function of the hardware
    descriptor like everything else here).

    The analytic cross-hardware transfer scaler (paper RQ4 / the
    AMD-style hardware-agnostic model) is the ratio
    ``throughput_batch(setup_to, ...) / throughput_batch(setup_from, ...)``
    applied to a fit benchmarked on ``setup_from``'s hardware."""
    ii = np.asarray(ii, np.float64)
    oo = np.asarray(oo, np.float64)
    bb = np.asarray(bb, np.float64)
    dec = decode_time_fn(setup)
    pre = prefill_time_fn(setup)
    t_pre = pre(ii * bb, ii * ii * bb)
    ctx = ii + oo / 2.0
    t_dec = dec(bb, ctx * bb)
    return bb * oo / (t_pre + oo * t_dec)


def sample_throughput(setup: ServingSetup, ii, oo, bb, reps: int,
                      rng: np.random.Generator,
                      noise_sigma: float = 0.05,
                      straggler_p: float = 0.02) -> np.ndarray:
    """reps noisy measurements (lognormal noise + rare straggler dips)."""
    base = throughput(setup, ii, oo, bb)
    noise = rng.lognormal(mean=0.0, sigma=noise_sigma, size=reps)
    stragglers = np.where(rng.random(reps) < straggler_p,
                          rng.uniform(0.6, 0.9, size=reps), 1.0)
    return base * noise * stragglers
