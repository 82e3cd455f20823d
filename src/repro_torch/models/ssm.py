"""State-space / recurrent mixers: Mamba (selective SSM) and the xLSTM
blocks, as the JAX package computes them.

Mamba runs a *chunked* selective scan: the (B, L, d_inner, d_state) hidden
states of one chunk of ``MAMBA_CHUNK`` positions at a time, carrying the
(B, d_inner, d_state) boundary state from chunk to chunk.  mLSTM is
chunkwise-parallel linear attention with a scalar decay a head (matrix
memory), ``MLSTM_CHUNK`` positions a chunk.  sLSTM is a sequential scan
(the gates couple through h_{t-1}): its prefill is a loop over positions.

Each mixer has a ``*_full`` function (prefill; the state given or zeros,
returns the output and the final state) and a ``*_decode`` function (one
token; returns the output and the new state, which the model copies into
its cache).  On a DTensor input each runs on every rank's batch rows with
its parameters and channels whole (``distributed.local.on_batch``): the
scans' cumulative sums and (batch, head) folds have no sharding rule in
the card's torch, and the reference's ``constrain`` points inside them
meet local tensors there.  They take the mixer's own parameters (``block["mamba"]``,
``block["mlstm"]``, ``block["slstm"]``).  Recurrent states are float32,
Mamba's convolution carry is in the compute dtype; ``A_log``, ``D`` and
``dt_bias`` are read in float32, as the reference reads them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.local import is_sharded, on_batch
from repro_torch.distributed.sharding import constrain
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init

MAMBA_CHUNK = 16
MLSTM_CHUNK = 64


def _chunks(s: int, chunk: int, what: str) -> int:
    if s % chunk:
        raise ValueError(f"{what}: sequence {s} is not a multiple of its "
                         f"chunk {chunk}")
    return s // chunk


# ===========================================================================
# Mamba
# ===========================================================================

class MambaState(NamedTuple):
    conv: torch.Tensor  # (B, d_conv-1, d_inner) trailing inputs
    ssm: torch.Tensor   # (B, d_inner, d_state)


def init_mamba(cfg: ModelConfig, generator: torch.Generator):
    d, di, ds = cfg.d_model, cfg.mamba_d_inner, cfg.mamba_d_state
    dtr, dc = cfg.dt_rank, cfg.mamba_d_conv
    dtype, fp, dev = cfg.compute_dtype, cfg.param_dtype, generator.device
    A = torch.arange(1, ds + 1, dtype=torch.float32,
                     device=dev)[None, :].repeat(di, 1)
    return {
        "in_proj": dense_init(generator, (d, 2 * di), dtype),
        "conv_w": dense_init(generator, (di, dc), dtype, in_axis=1),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": dense_init(generator, (di, dtr + 2 * ds), dtype),
        "dt_proj": dense_init(generator, (dtr, di), dtype),
        "dt_bias": torch.full((di,), -4.6, dtype=fp, device=dev),
        "A_log": torch.log(A).to(fp),
        "D": torch.ones((di,), dtype=fp, device=dev),
        "out_proj": dense_init(generator, (di, d), dtype),
    }


def _causal_conv(cfg, p, x, carry=None):
    """Depthwise causal conv over seq. x: (B,S,di); carry: (B,dc-1,di)."""
    dc = cfg.mamba_d_conv
    if carry is None:
        carry = x.new_zeros((x.shape[0], dc - 1, x.shape[2]))
    xp = torch.cat([carry.to(x.dtype), x], dim=1)  # (B, S+dc-1, di)
    w = p["conv_w"]                                 # (di, dc)
    out = sum(xp[:, i:i + x.shape[1], :] * w[:, i] for i in range(dc))
    out = out + p["conv_b"]
    new_carry = xp[:, -(dc - 1):, :] if dc > 1 else carry
    return F.silu(out), new_carry


def _ssm_params(cfg, p, x):
    """dt, B, C from x (B,S,di), in float32."""
    ds, dtr = cfg.mamba_d_state, cfg.dt_rank
    dt, Bc, Cc = torch.split(x @ p["x_proj"], [dtr, ds, ds], dim=-1)
    dt = F.softplus((dt @ p["dt_proj"]).float() + p["dt_bias"].float())
    return dt, Bc.float(), Cc.float()


def mamba_full(cfg: ModelConfig, p, xz, state: MambaState = None):
    """Train/prefill path. Returns (y, final MambaState)."""
    if is_sharded(xz):
        return on_batch(lambda x, q, st: mamba_full(cfg, q, x, st), xz, p,
                        state)
    b, s, _ = xz.shape
    dtype = cfg.compute_dtype
    n_chunks = _chunks(s, MAMBA_CHUNK, "mamba")
    x, z = (xz @ p["in_proj"]).chunk(2, dim=-1)
    x, conv_out = _causal_conv(cfg, p, x, None if state is None
                               else state.conv)
    x = constrain(x, "act_bsi")
    dt, Bc, Cc = _ssm_params(cfg, p, x)
    A = -torch.exp(p["A_log"].float())                   # (di, ds)
    xf = x.float()
    h = (xf.new_zeros((b, cfg.mamba_d_inner, cfg.mamba_d_state))
         if state is None else state.ssm.float())
    ys = []
    for c in range(n_chunks):
        t = slice(c * MAMBA_CHUNK, (c + 1) * MAMBA_CHUNK)
        dtk, Bk, Ck, xk = dt[:, t], Bc[:, t], Cc[:, t], xf[:, t]
        dA = torch.exp(dtk[..., None] * A)                   # (B,L,di,ds)
        dBx = (dtk * xk)[..., None] * Bk[:, :, None, :]      # (B,L,di,ds)
        # inclusive cumulative: h_t = dA_t h_{t-1} + dBx_t
        cum = torch.exp(torch.cumsum(torch.log(dA.clamp_min(1e-20)), dim=1))
        scaled = dBx / cum.clamp_min(1e-20)
        hs = cum * (torch.cumsum(scaled, dim=1) + h[:, None])
        ys.append(torch.einsum("blis,bls->bli", hs, Ck))
        h = hs[:, -1]
    y = torch.cat(ys, dim=1) + xf * p["D"].float()
    out = (y.to(dtype) * F.silu(z)) @ p["out_proj"]
    return out, MambaState(conv=conv_out, ssm=h)


def mamba_decode(cfg: ModelConfig, p, xz, state: MambaState):
    """One-token step. xz: (B, 1, d_model)."""
    if is_sharded(xz):
        return on_batch(lambda x, q, st: mamba_decode(cfg, q, x, st), xz, p,
                        state)
    dtype = cfg.compute_dtype
    dc = cfg.mamba_d_conv
    x, z = (xz @ p["in_proj"]).chunk(2, dim=-1)
    # conv over carry + current token
    xp = torch.cat([state.conv.to(x.dtype), x], dim=1)
    w = p["conv_w"]
    xc = sum(xp[:, -dc + i, :] * w[:, i] for i in range(dc))
    xc = F.silu(xc + p["conv_b"])[:, None, :]
    new_conv = xp[:, -(dc - 1):, :]
    dt, Bc, Cc = _ssm_params(cfg, p, xc)
    A = -torch.exp(p["A_log"].float())
    dt0, B0, C0, x0 = dt[:, 0], Bc[:, 0], Cc[:, 0], xc[:, 0].float()
    dA = torch.exp(dt0[..., None] * A)                        # (B,di,ds)
    h = dA * state.ssm + (dt0 * x0)[..., None] * B0[:, None, :]
    h = constrain(h, "mamba_state")
    y = torch.einsum("bis,bs->bi", h, C0) + x0 * p["D"].float()
    out = (y.to(dtype)[:, None, :] * F.silu(z)) @ p["out_proj"]
    return out, MambaState(conv=new_conv, ssm=h)


def init_mamba_state(cfg: ModelConfig, batch: int, device,
                     lead=()) -> MambaState:
    """Zero state, with ``lead`` axes (the model's n_periods) in front."""
    return MambaState(
        conv=torch.zeros((*lead, batch, cfg.mamba_d_conv - 1,
                          cfg.mamba_d_inner), dtype=cfg.compute_dtype,
                         device=device),
        ssm=torch.zeros((*lead, batch, cfg.mamba_d_inner, cfg.mamba_d_state),
                        dtype=torch.float32, device=device))


# ===========================================================================
# xLSTM — mLSTM (matrix memory, chunk-parallel)
# ===========================================================================

class MLSTMState(NamedTuple):
    C: torch.Tensor  # (B, H, Dk, Dv)
    n: torch.Tensor  # (B, H, Dk)


def _xlstm_width(cfg: ModelConfig) -> int:
    return int(cfg.xlstm_proj_factor * cfg.d_model)


def init_mlstm(cfg: ModelConfig, generator: torch.Generator):
    d, dp, h = cfg.d_model, _xlstm_width(cfg), cfg.n_heads
    dk = dp // h
    dtype = cfg.compute_dtype
    return {
        "up_proj": dense_init(generator, (d, 2 * dp), dtype),
        "wqk": dense_init(generator, (dp, 2 * h * dk), dtype),
        "wv2": dense_init(generator, (dp, h * dk), dtype),
        "w_gates": dense_init(generator, (dp, 2 * h), dtype),
        "down_proj": dense_init(generator, (dp, d), dtype),
    }


def _mlstm_qkv(cfg, p, xin):
    b, s, dp = xin.shape
    h = cfg.n_heads
    dk = dp // h
    q, k = (xin @ p["wqk"]).view(b, s, 2 * h, dk).chunk(2, dim=2)
    v = (xin @ p["wv2"]).view(b, s, h, dk)
    ig, fg = (xin @ p["w_gates"]).float().chunk(2, dim=-1)  # (B,S,H)
    i = torch.exp(ig.clamp(max=10.0))     # stabilized exp input gate
    f = torch.sigmoid(fg)
    return q, k, v, i, f, dk


def mlstm_full(cfg: ModelConfig, p, x, state: MLSTMState = None):
    if is_sharded(x):
        return on_batch(lambda y, q, st: mlstm_full(cfg, q, y, st), x, p,
                        state)
    dtype = cfg.compute_dtype
    b, s, _ = x.shape
    hn = cfg.n_heads
    xin, z = (x @ p["up_proj"]).chunk(2, dim=-1)
    q, k, v, i, f, dk = _mlstm_qkv(cfg, p, xin)
    scale = 1.0 / (dk ** 0.5)
    L = min(MLSTM_CHUNK, s)
    n_chunks = _chunks(s, L, "mlstm")
    C = (x.new_zeros((b, hn, dk, dk), dtype=torch.float32) if state is None
         else state.C)
    n = (x.new_zeros((b, hn, dk), dtype=torch.float32) if state is None
         else state.n)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=x.device))
    ys = []
    for c in range(n_chunks):
        t = slice(c * L, (c + 1) * L)
        qf, kf, vf = q[:, t].float(), k[:, t].float(), v[:, t].float()
        ik, fk = i[:, t], f[:, t]
        Fc = torch.cumsum(torch.log(fk.clamp_min(1e-20)), dim=1)  # (B,L,H)
        # intra-chunk "attention" with decay exp(F_t - F_s) i_s, causal
        scores = torch.einsum("bthk,bshk->bhts", qf, kf) * scale
        Fh = Fc.transpose(1, 2)                               # (B,H,L)
        dmat = Fh[:, :, :, None] - Fh[:, :, None, :]          # F_t - F_s
        w = torch.where(causal, torch.exp(dmat), 0.0)
        w = w * ik.transpose(1, 2)[:, :, None, :]
        intra = torch.einsum("bhts,bshk->bthk", scores * w, vf)
        # inter-chunk: carry contribution
        decay = torch.exp(Fc)                                 # (B,T,H)
        qs = qf * scale
        inter = torch.einsum("bthk,bhkv->bthv", qs, C) * decay[..., None]
        nq = torch.einsum("bthk,bhk->bth", qs, n) * decay
        # normalizer: intra part
        n_intra = torch.einsum("bhts,bshk->bthk", w, kf)
        denom_intra = torch.einsum("bthk,bthk->bth", qs, n_intra)
        denom = (nq + denom_intra).abs().clamp_min(1.0)[..., None]
        ys.append(((intra + inter) / denom).to(dtype))
        # update carry
        tot_decay = torch.exp(Fc[:, -1])                      # (B,H)
        rev = torch.exp(Fc[:, -1][:, None, :] - Fc)           # (B,L,H)
        kw = kf * (rev * ik)[..., None]
        C = C * tot_decay[..., None, None] + \
            torch.einsum("bshk,bshv->bhkv", kw, vf)
        n = n * tot_decay[..., None] + kw.sum(1)
    y = torch.cat(ys, dim=1).reshape(b, s, -1) * F.silu(z)
    return y @ p["down_proj"], MLSTMState(C=C, n=n)


def mlstm_decode(cfg: ModelConfig, p, x, state: MLSTMState):
    if is_sharded(x):
        return on_batch(lambda y, q, st: mlstm_decode(cfg, q, y, st), x, p,
                        state)
    dtype = cfg.compute_dtype
    b = x.shape[0]
    xin, z = (x @ p["up_proj"]).chunk(2, dim=-1)
    q, k, v, i, f, dk = _mlstm_qkv(cfg, p, xin)
    scale = 1.0 / (dk ** 0.5)
    qf, kf, vf = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()
    i0, f0 = i[:, 0], f[:, 0]                  # (B,H)
    C = state.C * f0[..., None, None] + \
        (kf * i0[..., None])[..., :, None] * vf[..., None, :]
    C = constrain(C, "mlstm_state")
    n = state.n * f0[..., None] + kf * i0[..., None]
    qs = qf * scale
    num = torch.einsum("bhk,bhkv->bhv", qs, C)
    den = torch.einsum("bhk,bhk->bh", qs, n).abs().clamp_min(1.0)[..., None]
    y = (num / den).reshape(b, 1, -1).to(dtype) * F.silu(z)
    return y @ p["down_proj"], MLSTMState(C=C, n=n)


def init_mlstm_state(cfg: ModelConfig, batch: int, device,
                     lead=()) -> MLSTMState:
    dk = _xlstm_width(cfg) // cfg.n_heads
    shape = (*lead, batch, cfg.n_heads, dk)
    return MLSTMState(
        C=torch.zeros((*shape, dk), dtype=torch.float32, device=device),
        n=torch.zeros(shape, dtype=torch.float32, device=device))


# ===========================================================================
# xLSTM — sLSTM (scalar memory, sequential)
# ===========================================================================

class SLSTMState(NamedTuple):
    c: torch.Tensor  # (B, Dp)
    n: torch.Tensor  # (B, Dp)
    h: torch.Tensor  # (B, Dp)


def init_slstm(cfg: ModelConfig, generator: torch.Generator):
    d, dp, dtype = cfg.d_model, _xlstm_width(cfg), cfg.compute_dtype
    return {
        "up_proj": dense_init(generator, (d, 4 * dp), dtype),
        "r_proj": dense_init(generator, (dp, 4 * dp), dtype),
        "down_proj": dense_init(generator, (dp, d), dtype),
    }


def _slstm_step(r, carry: SLSTMState, wx_t) -> SLSTMState:
    """One position. ``r`` is r_proj widened to float32: the reference's
    einsum of the float32 h with r_proj in the compute dtype promotes to
    float32, so the recurrent product is a float32 one."""
    c, n, h = carry
    z, i, f, o = (wx_t + h @ r).chunk(4, dim=-1)
    z = torch.tanh(z)
    i = torch.exp(i.clamp(max=10.0))
    f = torch.sigmoid(f)
    o = torch.sigmoid(o)
    c2 = f * c + i * z
    n2 = f * n + i
    return SLSTMState(c=c2, n=n2, h=o * (c2 / n2.clamp_min(1.0)))


def slstm_full(cfg: ModelConfig, p, x, state: SLSTMState = None):
    if is_sharded(x):
        return on_batch(lambda y, q, st: slstm_full(cfg, q, y, st), x, p,
                        state)
    dtype = cfg.compute_dtype
    b, s, _ = x.shape
    wx = (x @ p["up_proj"]).float()
    r = p["r_proj"].float()
    if state is None:
        state = init_slstm_state(cfg, b, x.device)
    hs = []
    for t in range(s):
        state = _slstm_step(r, state, wx[:, t])
        hs.append(state.h)
    y = torch.stack(hs, dim=1).to(dtype)
    return y @ p["down_proj"], state


def slstm_decode(cfg: ModelConfig, p, x, state: SLSTMState):
    if is_sharded(x):
        return on_batch(lambda y, q, st: slstm_decode(cfg, q, y, st), x, p,
                        state)
    wx = (x @ p["up_proj"]).float()
    state = _slstm_step(p["r_proj"].float(), state, wx[:, 0])
    return (state.h.to(cfg.compute_dtype) @ p["down_proj"])[:, None], state


def init_slstm_state(cfg: ModelConfig, batch: int, device,
                     lead=()) -> SLSTMState:
    shape = (*lead, batch, _xlstm_width(cfg))
    return SLSTMState(*(torch.zeros(shape, dtype=torch.float32, device=device)
                        for _ in range(3)))
