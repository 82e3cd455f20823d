"""Expert-parallel MoE through ``shard_map``, the reference package's
``distributed/ep_moe.py`` on ``torch.distributed``.

Sharding propagation cannot partition a scatter whose indices cross
shards: the plain path replicates the (E, C, D) dispatch buffer on every
rank.  This implementation makes the dispatch *local by construction*:

  rank (i, j) holds tokens of data-shard i and experts of model-shard j
    1. route locally (router weights are replicated),
    2. keep only assignments to the local expert block [j*E_loc, ...),
    3. local stable sort -> rank -> capacity-bucketed local scatter,
    4. local expert FFN (weights already sharded over ``model`` on E),
    5. local combine back to token order, weighted by gate values,
    6. one all-reduce over ``model`` sums each token's expert
       contributions.

Collectives per layer: a single (T_loc, D) all-reduce (plus the aux
loss's means over the data axes).  Capacity semantics are per data shard
(capacity_factor applies within each shard), the standard
distributed-capacity variant.

Inside ``shard_map`` the collectives are DTensor redistributions of a
pending sum, so autograd gives each rank's share its gradient once.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.compat import Partial, Replicate, shard_map
from repro_torch.distributed.local import as_dtensor, wrap
from repro_torch.distributed.sharding import P
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import route
from repro_torch.phases import phase


def _axis_sizes(policy):
    n_model = 1
    for a in policy.model_axes:
        n_model *= policy.mesh.shape[policy.mesh.mesh_dim_names.index(a)]
    n_data = 1
    for a in policy.data_axes:
        n_data *= policy.mesh.shape[policy.mesh.mesh_dim_names.index(a)]
    return n_data, n_model


def ep_available(cfg: ModelConfig, policy, batch: int = 0,
                 seq: int = 0) -> bool:
    if policy is None:
        return False
    n_data, n_model = _axis_sizes(policy)
    if cfg.n_experts % n_model or n_model <= 1:
        return False
    if batch and seq:
        # tokens must shard over data on either the batch or seq dim
        return batch % n_data == 0 or seq % n_data == 0
    return True


def _psum(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of ``t`` over the mesh axes ``axes``, on every rank."""
    names = mesh.mesh_dim_names
    pending = tuple(Partial() if n in axes else Replicate() for n in names)
    return wrap(t, mesh, pending, t.shape).redistribute(
        mesh, (Replicate(),) * mesh.ndim).to_local()


def moe_ffn_ep(cfg: ModelConfig, params, x, policy):
    """x: (B, S, D) -> (out, aux).  Drop-in for moe.moe_ffn."""
    mesh = policy.mesh
    data_axes = tuple(policy.data_axes)
    model_ax = policy.model_axes[0]
    n_data, n_model = _axis_sizes(policy)
    e, k = cfg.n_experts, cfg.top_k
    e_loc = e // n_model
    d = cfg.d_model
    dtype = cfg.compute_dtype

    b, s, _ = x.shape
    t_loc = (b * s) // n_data
    cap = max(8, int(cfg.capacity_factor * k * t_loc / e) + 1)
    cap = ((cap + 7) // 8) * 8

    def local_fn(x_loc, router_w, wg, wu, wd):
        bl, sl, _ = x_loc.shape
        t = bl * sl
        dev = x_loc.device
        xt = x_loc.reshape(t, d)
        with phase("moe.route"):
            probs, gate_vals, gate_idx = route(cfg, router_w, xt)
            # aux loss from global stats (means over the data shards);
            # every model rank computes it alike, so only the first passes
            # its gradient on (shard_map sums the inputs' over model)
            j = mesh.get_local_rank(model_ax)
            me = _psum(probs.mean(0), mesh, data_axes) / n_data
            if j:
                me = me.detach()
            ce = torch.zeros(e, dtype=torch.float32, device=dev).index_add_(
                0, gate_idx[:, 0], torch.ones_like(probs[:, 0])) / t
            ce = _psum(ce, mesh, data_axes) / n_data
            aux = e * (me * ce).sum()

        with phase("moe.dispatch"):
            # local expert block
            e_start = j * e_loc
            flat_e = gate_idx.reshape(-1)
            flat_g = gate_vals.reshape(-1)
            flat_t = torch.arange(t, device=dev).repeat_interleave(k)
            local = (flat_e >= e_start) & (flat_e < e_start + e_loc)
            le = torch.where(local, flat_e - e_start, e_loc)  # e_loc: dropped
            order = torch.argsort(le, stable=True)
            se, st, sg = le[order], flat_t[order], flat_g[order]
            starts = torch.searchsorted(
                se, torch.arange(e_loc, device=dev, dtype=se.dtype))
            rank = torch.arange(se.shape[0], device=dev) - \
                starts[se.clamp(0, e_loc - 1)]
            keep = (se < e_loc) & (rank < cap)
            slot = torch.where(keep, se * cap + rank, 0)

            gathered = xt.index_select(0, st) * keep[:, None].to(dtype)
            buf = torch.zeros((e_loc * cap, d), dtype=dtype, device=dev)
            buf = buf.index_add(0, slot, gathered).view(e_loc, cap, d)

        with phase("moe.experts"):
            h = F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
            out_buf = torch.bmm(h, wd).view(e_loc * cap, d)

        with phase("moe.combine"):
            contrib = out_buf.index_select(0, slot) * \
                (sg * keep).to(dtype)[:, None]
            yt = torch.zeros_like(xt).index_add(0, st, contrib)
            # sum each token's expert contributions across model shards
            yt = _psum(yt, mesh, (model_ax,))
        return yt.reshape(bl, sl, d), aux

    w = params["experts"]
    args = (x, params["router"], w["w_gate"], w["w_up"], w["w_down"])
    batch_spec = data_axes if len(data_axes) > 1 else data_axes[0]
    if b % n_data == 0:
        x_spec = P(batch_spec, None, None)
    else:
        # small-batch serving (e.g. long-context bb=1): shard tokens on seq
        x_spec = P(None, batch_spec, None)
    out, aux = shard_map(
        local_fn, mesh=mesh,
        in_specs=(x_spec, P(), P(model_ax), P(model_ax), P(model_ax)),
        out_specs=(x_spec, P()),
        check_vma=False,
    )(*(as_dtensor(t, mesh) for t in args))
    return out, aux
