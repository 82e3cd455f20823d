"""PartitionSpecs for decode caches / recurrent state (period-stacked), the
reference package's ``distributed/staterules.py`` over the port's
``DecodeCache``, which keeps the same layout: one state a period position
with a leading ``n_periods`` axis, and the encoder's K/V in ``cross``.
The device-held positions ``pos_t`` and ``cross_pos_t`` are replicated;
the host's ``pos`` and ``max_len`` are carried as they are."""
from __future__ import annotations

import torch

from repro_torch.distributed.compat import (DTensor, distribute_tensor,
                                            local_shape_and_offset)
from repro_torch.distributed.local import wrap
from repro_torch.distributed.sharding import (NamedSharding, P,
                                              PartitionSpec, ShardingPolicy)
from repro_torch.models.attention import KVCache
from repro_torch.models.ssm import MambaState, MLSTMState, SLSTMState


def _prepend_none(spec: PartitionSpec) -> PartitionSpec:
    return P(None, *spec)


def _state_spec(policy: ShardingPolicy, st, stacked: bool):
    """Spec tuple for one block state (shapes possibly period-stacked)."""
    off = 1 if stacked else 0

    def shp(t):
        return t.shape[off:]

    if isinstance(st, KVCache):
        s = policy.resolve("kv_cache", shp(st.k))
        s = _prepend_none(s) if stacked else s
        return KVCache(k=s, v=s)
    if isinstance(st, MambaState):
        conv = policy.resolve("mamba_conv", shp(st.conv))
        ssm = policy.resolve("mamba_state", shp(st.ssm))
        if stacked:
            conv, ssm = _prepend_none(conv), _prepend_none(ssm)
        return MambaState(conv=conv, ssm=ssm)
    if isinstance(st, MLSTMState):
        c = policy.resolve("mlstm_state", shp(st.C))
        n = policy.resolve("mlstm_n", shp(st.n))
        if stacked:
            c, n = _prepend_none(c), _prepend_none(n)
        return MLSTMState(C=c, n=n)
    if isinstance(st, SLSTMState):
        s = policy.resolve("slstm_state", shp(st.c))
        s = _prepend_none(s) if stacked else s
        return SLSTMState(c=s, n=s, h=s)
    if st is None:
        return None
    raise TypeError(type(st))


def decode_cache_specs(policy: ShardingPolicy, cache):
    """A ``DecodeCache`` (``models.transformer``) of specs: ``blocks`` and
    ``cross`` a spec a tensor, ``pos_t`` and ``cross_pos_t`` ``P()``."""
    blocks = tuple(_state_spec(policy, st, stacked=True)
                   for st in cache.blocks)
    cross = None
    if cache.cross is not None:
        cross = tuple(_state_spec(policy, kv, stacked=True)
                      for kv in cache.cross)
    return cache._replace(blocks=blocks, cross=cross, pos_t=P(),
                          cross_pos_t=None if cache.cross_pos_t is None
                          else P())


def decode_cache_shardings(policy: ShardingPolicy, cache):
    """``decode_cache_specs`` as ``NamedSharding``s over ``policy.mesh``."""
    specs = decode_cache_specs(policy, cache)

    def named(state):
        return None if state is None else type(state)(
            *(NamedSharding(policy.mesh, s) for s in state))

    return specs._replace(
        blocks=tuple(named(st) for st in specs.blocks),
        cross=None if specs.cross is None else tuple(
            named(st) for st in specs.cross),
        pos_t=NamedSharding(policy.mesh, specs.pos_t),
        cross_pos_t=None if specs.cross_pos_t is None
        else NamedSharding(policy.mesh, specs.cross_pos_t))


def _zeros(shape, dtype, mesh, placements, device) -> DTensor:
    """``torch.distributed.tensor.zeros`` on ``device``: this rank's shard
    of a zeroed tensor of ``shape``."""
    local, _ = local_shape_and_offset(shape, mesh, placements)
    return wrap(torch.zeros(local, dtype=dtype, device=device), mesh,
                placements, shape)


def sharded_zeros(policy: ShardingPolicy, cache, device=None):
    """A zeroed cache of ``cache``'s shapes (meta tensors will do) as
    DTensors at ``decode_cache_shardings``: each rank allocates its own
    shards only, on ``device`` (default: the mesh's device type; "meta"
    for a trace); ``pos_t`` and ``cross_pos_t`` replicated, with their
    values."""
    mesh = policy.mesh
    pl = decode_cache_shardings(policy, cache)
    device = torch.device(device or mesh.device_type)

    def zeros(state, state_pl):
        return None if state is None else type(state)(*(
            _zeros(t.shape, t.dtype, mesh, n.placements, device)
            for t, n in zip(state, state_pl)))

    pos_t = distribute_tensor(torch.full((1,), cache.pos, dtype=torch.int64,
                                         device=device), mesh,
                              pl.pos_t.placements)
    cross_pos_t = None
    if cache.cross is not None:
        t_enc = cache.cross[0].k.shape[2]
        cross_pos_t = distribute_tensor(
            torch.full((1,), t_enc - 1, dtype=torch.int64, device=device),
            mesh, pl.cross_pos_t.placements)
    return cache._replace(
        blocks=tuple(zeros(st, p) for st, p in zip(cache.blocks, pl.blocks)),
        cross=None if cache.cross is None else tuple(
            zeros(st, p) for st, p in zip(cache.cross, pl.cross)),
        pos_t=pos_t, cross_pos_t=cross_pos_t)
