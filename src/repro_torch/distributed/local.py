"""Rank-local work on DTensors where sharding propagation has no rule, or
the wrong one: the kernels (K1-K3 run on each rank's local tensors), the
recurrent mixers (each rank's batch rows), the decode cache's writes (an
``index_copy_`` at a device-held position, a prompt's prefix, a recurrent
state's copy), and the views and products of cut dims that torch 2.11's
DTensor refuses (``gathered``, ``split_ready``, ``matmul``).

Each function states the placements it needs and redistributes to them;
none catches an error.  A tensor that is not a DTensor takes the
single-device path unchanged, so nothing here runs without a policy.
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed.compat import (DTensor, Partial, Replicate,
                                            Shard,
                                            local_shape_and_offset)


def is_sharded(*tensors) -> bool:
    return any(isinstance(t, DTensor) for t in tensors)


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def wrap(t: torch.Tensor, mesh, placements, shape) -> DTensor:
    """A rank's local result ``t`` as a DTensor of global ``shape`` (which
    uneven shards do not imply), laid out contiguously as the global
    strides it is given say (the plain attentions return head-major
    views)."""
    return DTensor.from_local(t.contiguous(), mesh, placements,
                              run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def as_dtensor(x, mesh) -> DTensor:
    """``x`` itself if a DTensor, else the whole of it, replicated."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def local(x, mesh, placements, grad_placements=None) -> torch.Tensor:
    """``x``'s local tensor at ``placements``; a plain tensor is taken as
    the whole tensor, replicated."""
    if not isinstance(x, DTensor):
        if all(isinstance(p, Replicate) for p in placements):
            return x
        x = as_dtensor(x, mesh)
    return x.redistribute(mesh, placements).to_local(
        grad_placements=grad_placements)


def gathered(x, dims):
    """``x`` with no shard on ``dims`` (a DTensor redistributed; a plain
    tensor as it is): what a view that merges or cuts those dims needs,
    since a DTensor view cannot move data."""
    if not isinstance(x, DTensor):
        return x
    dims = {d % x.ndim for d in dims}
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim % x.ndim in dims
               else p for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(
        x.device_mesh, pl)


def split_ready(x, dim: int, lead: int):
    """``x`` ready for a view that splits its dim ``dim`` into (``lead``,
    rest): a shard of that dim is kept only where the mesh dims cutting
    it divide ``lead`` (each rank's part then splits alike), else
    gathered."""
    if not isinstance(x, DTensor):
        return x
    cuts = math.prod(x.device_mesh.size(m) for m, p in
                     enumerate(x.placements)
                     if isinstance(p, Shard) and p.dim % x.ndim == dim)
    return x if lead % cuts == 0 else gathered(x, (dim,))


def matmul(x, w):
    """``x @ w`` for x (B, S, K) and w (K, N).  A DTensor ``x`` cut on S
    is multiplied as a batch of B matrices: the plain product folds (B,
    S) into one dim by a view, which a DTensor cut on S cannot take."""
    if isinstance(x, DTensor) and x.ndim == 3 and any(
            isinstance(p, Shard) and p.dim % 3 == 1 for p in x.placements):
        return torch.bmm(x, w.unsqueeze(0).expand(x.shape[0], *w.shape))
    return x @ w


def row_placements(x: DTensor) -> tuple:
    """K1's placements for ``x``: every shard of a dim but the last kept,
    the last dim (the norm's) and any pending sum made whole."""
    return tuple(Shard(p.dim) if isinstance(p, Shard) and
                 p.dim % x.ndim != x.ndim - 1 else Replicate()
                 for p in x.placements)


def partial_over_shards(placements) -> tuple:
    """A rank's sum over its own shard: pending over the mesh dims that
    shard (``placements``), whole over the others."""
    return tuple(Partial() if isinstance(p, Shard) else Replicate()
                 for p in placements)


def on_rows(fn, xs, scale, eps):
    """``fn(*xs, scale, eps)`` (a K1 wrapper) on each rank's rows: each of
    ``xs`` (of one shape) at the first DTensor's ``row_placements``,
    ``scale`` whole.  A rank's dscale covers its own rows, so its gradient
    is a pending sum over the mesh dims that shard them.  Returns the
    result (or each of a tuple) at those placements."""
    x = next(t for t in xs if isinstance(t, DTensor))
    mesh, pl = x.device_mesh, row_placements(x)
    out = fn(*(local(t, mesh, pl) for t in xs),
             local(scale, mesh, (Replicate(),) * mesh.ndim,
                   partial_over_shards(pl)), eps)
    if isinstance(out, tuple):
        return tuple(wrap(t, mesh, pl, x.shape) for t in out)
    return wrap(out, mesh, pl, x.shape)


def on_heads(fn, q, k, v, *args, **kwargs):
    """``fn(q, k, v, ...)`` (K2 or K3) on each rank's batch rows and
    heads: q (B, [S,] H, Dh) and k, v (B, T, KV, Dh) with batch and heads
    kept where k's placements (or q's) shard them and the sequence
    gathered (``head_placements``); the result at q's."""
    qh = q.dim() - 2                        # q's heads dim
    if isinstance(k, DTensor):
        mesh = k.device_mesh
        kpl = head_placements(mesh, k.placements, 2,
                              (q.shape[qh], k.shape[2]))
    else:
        mesh = q.device_mesh
        kpl = renumber(head_placements(mesh, q.placements, qh,
                                       (q.shape[qh], k.shape[2])),
                       {0: 0, qh: 2})
    qpl = renumber(kpl, {0: 0, 2: qh})
    rep = (Replicate(),) * mesh.ndim
    out = fn(local(q, mesh, qpl), local(k, mesh, kpl), local(v, mesh, kpl),
             *(local(a, mesh, rep) if isinstance(a, torch.Tensor) else a
               for a in args), **kwargs)
    return wrap(out, mesh, qpl, q.shape)


def on_batch(fn, x, params, state=None):
    """``fn(x, params, state)`` (a recurrent mixer) on each rank's batch
    rows: ``x`` (B, ...) and each tensor of ``state`` (B leading, or
    None) at x's shards of the batch dim, every other dim whole (a scan
    runs over the whole sequence and every channel); ``params`` (a
    mapping of tensors) whole, its gradient a pending sum over the mesh
    dims that cut the batch.  Returns ``(out, state)`` with each tensor
    (B leading) at those placements."""
    mesh = x.device_mesh
    pl = tuple(Shard(0) if isinstance(p, Shard) and p.dim == 0
               else Replicate() for p in x.placements)
    whole = (Replicate(),) * mesh.ndim
    grad_pl = partial_over_shards(pl)
    out, new = fn(local(x, mesh, pl),
                  {k: local(v, mesh, whole, grad_pl)
                   for k, v in params.items()},
                  None if state is None else type(state)(
                      *(local(t, mesh, pl) for t in state)))

    def back(t):
        return wrap(t, mesh, pl, (x.shape[0], *t.shape[1:]))

    return back(out), type(new)(*(back(t) for t in new))


def head_placements(mesh, placements, heads_dim: int, batch_heads) -> tuple:
    """The placements K2 and K3 run at, from ``placements`` of the tensor
    they follow: a shard of the batch (dim 0) kept, a shard of
    ``heads_dim`` kept while the mesh dims keeping it divide every head
    count of ``batch_heads`` (query and KV heads: both must split
    alike), all else gathered."""
    out, heads_split = [], 1
    for m, p in enumerate(placements):
        size = mesh.size(m)
        if isinstance(p, Shard) and p.dim == 0:
            out.append(Shard(0))
        elif (isinstance(p, Shard) and p.dim == heads_dim
              and all(h % (heads_split * size) == 0 for h in batch_heads)):
            heads_split *= size
            out.append(Shard(heads_dim))
        else:
            out.append(Replicate())
    return tuple(out)


def renumber(placements, dims: dict) -> tuple:
    """``placements`` with each ``Shard(d)`` moved to ``Shard(dims[d])``."""
    return tuple(Shard(dims[p.dim]) if isinstance(p, Shard) else p
                 for p in placements)


def _t_range(buf: DTensor, dim: int):
    """This rank's [lo, lo + n) of ``buf``'s dim ``dim``."""
    shape, offset = local_shape_and_offset(buf.shape, buf.device_mesh,
                                           buf.placements)
    return offset[dim], shape[dim]


def write_at(buf, pos_t, new) -> None:
    """``buf[:, pos] = new[:, 0]`` in place (``buf`` (B, T, ...), ``new``
    (B, 1, ...), ``pos_t`` a one-element int64 tensor, all on the device).
    A DTensor ``buf`` is written on its own shards: ``new`` at buf's
    placements with T gathered, each rank writing the position if its
    shard of T holds it (``index_copy_`` of a select where it does not),
    so no host value is read."""
    if not isinstance(buf, DTensor):
        buf.index_copy_(1, pos_t, new)
        return
    mesh = buf.device_mesh
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p
               for p in buf.placements)
    lo, n = _t_range(buf, 1)
    if n == 0:
        return
    pos = local(pos_t, mesh, (Replicate(),) * mesh.ndim)
    here = pos - lo
    inside = (here >= 0) & (here < n)
    idx = here.clamp(0, n - 1)
    buf_l = buf.to_local()
    new_l = local(new, mesh, pl)
    view = (-1,) + (1,) * (new_l.dim() - 1)
    buf_l.index_copy_(1, idx, torch.where(
        inside.view(view), new_l, buf_l.index_select(1, idx)))


def write_prefix(buf, src) -> None:
    """``buf[:, :S] = src`` in place (``buf`` (B, T, ...), ``src`` (B, S,
    ...)).  A DTensor ``buf`` is written on its own shards: ``src`` at
    buf's placements with S gathered, each rank copying the positions its
    shard of T holds."""
    s = src.shape[1]
    if not isinstance(buf, DTensor):
        buf[:, :s] = src
        return
    mesh = buf.device_mesh
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p
               for p in buf.placements)
    lo, n = _t_range(buf, 1)
    n = max(0, min(n, s - lo))
    if n:
        buf.to_local()[:, :n] = local(src, mesh, pl)[:, lo:lo + n]


def assign(dst, src) -> None:
    """``dst.copy_(src)``; a DTensor ``dst`` keeps its placements, ``src``
    redistributed to them."""
    if not isinstance(dst, DTensor):
        dst.copy_(src)
        return
    dst.to_local().copy_(local(src, dst.device_mesh, dst.placements))
