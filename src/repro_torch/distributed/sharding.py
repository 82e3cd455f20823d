"""Sharding policy: logical activation rules + parameter partition specs,
the reference package's ``distributed/sharding.py`` on
``torch.distributed``.

Design
------
* A :class:`ShardingPolicy` binds a mesh (a ``DeviceMesh``, or any object
  whose ``shape`` maps axis names to sizes) to *logical rules*.  Model
  code calls ``constrain(x, "act_qkv")`` at the reference's points;
  outside a policy context, or on a tensor that is not a DTensor, it
  returns ``x`` itself, so single-device code never touches it.  Inside
  one it redistributes the DTensor to the rule's placements, the
  counterpart of ``with_sharding_constraint``; DTensor's sharding
  propagation between those points is the counterpart of GSPMD's.
* Every rule is a priority list of ``(dim, axes)`` preferences, applied
  greedily iff the dim size is divisible by the mesh axes' product and
  the axes are not already used, expression for expression as the
  reference.
* Parameter specs are derived from (path, shape) as the reference derives
  them from its pytree: ``tree_param_specs`` rebuilds each block leaf's
  period-stacked shape ``(n_periods, ...)`` from the port's per-period
  tensors (``blocks.<period>.<position>.<key>``), so its tuples equal the
  reference's.  ``tree_shardings`` places the per-period tensors: an axis
  the reference put on the stack dim goes to the first free dim of the
  per-period tensor that its size divides (the reference's own fallback
  order), so each rank holds the same share of the bytes; where no dim
  divides, the leaf stays replicated over that axis
  (``period_stack_placements`` reports it).
* A spec becomes DTensor placements (``placements``): for each mesh dim,
  ``Shard(d)`` on the tensor dim whose entry names that axis, else
  ``Replicate()``; an entry naming several axes, such as ``("pod",
  "data")``, shards its dim over them in mesh order, as JAX does.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import threading
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from repro_torch.distributed.compat import (DTensor, Replicate, Shard,
                                            implicit_replication)

_STATE = threading.local()


class PartitionSpec(tuple):
    """One entry a tensor dim: None (replicated), an axis name, or a tuple
    of axis names; ``P("data", None)`` as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}" if len(self) != 1 else \
            f"P({self[0]!r})"


P = PartitionSpec


def _mesh_size(mesh, axis: str) -> int:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return int(mesh.shape[names.index(axis)])
    return int(mesh.shape[axis])


def _axes_size(mesh, axes: Tuple[str, ...]) -> int:
    return int(np.prod([_mesh_size(mesh, a) for a in axes]))


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(mesh, spec: Sequence) -> tuple:
    """The DTensor placements of ``spec`` over ``mesh``'s dims (see the
    module's docstring)."""
    names = tuple(mesh.mesh_dim_names)
    out = []
    for axis in names:
        dims = [d for d, e in enumerate(spec) if axis in _entry_axes(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    for e in spec:
        axes = _entry_axes(e)
        if sorted(axes, key=names.index) != list(axes):
            raise ValueError(f"spec entry {e} is not in the mesh's axis "
                             f"order {names}")
    return tuple(out)


class NamedSharding(NamedTuple):
    """A spec over a mesh, as ``jax.sharding.NamedSharding``;
    ``placements`` are its DTensor placements."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


@dataclasses.dataclass
class ShardingPolicy:
    mesh: object
    data_axes: Tuple[str, ...] = ("data",)
    model_axes: Tuple[str, ...] = ("model",)
    # rule name -> priority list of (dim, "data"|"model")
    rules: Optional[dict] = None
    # hillclimb knobs
    seq_parallel_attn: bool = True      # allow CP fallback on seq dims
    zero1: bool = True                   # shard optimizer state over data
    shard_scores_dhead: bool = False     # last-resort d_head sharding
    # serving: weights are read-only -> shard them over data too (2D weight
    # sharding across the whole slice, vLLM-style full TP).  serving_2d
    # False keeps weights TP-only (replicated over data): no per-step
    # weight all-gathers.
    serving: bool = False
    serving_2d: bool = True
    # context-parallel prefill: when attention heads don't divide the TP
    # width, replicate block weights over ``model`` and shard the sequence
    # end-to-end instead of bouncing between seq- and head-sharding per
    # layer.
    cp_replicate_weights: bool = False
    # expert-parallel MoE (``distributed/ep_moe.py``): local dispatch + one
    # all-reduce instead of a replicated dispatch buffer.
    ep_moe: bool = True

    def __post_init__(self):
        if self.rules is None:
            self.rules = dict(DEFAULT_RULES)

    def resolve(self, name: str, shape: Sequence[int]) -> PartitionSpec:
        prefs = self.rules.get(name)
        if self.cp_replicate_weights and name == "act_btd" and \
                len(shape) >= 2:
            prefs = [(0, "data"), (1, "model")]
        if prefs is None:
            return P()
        spec = [None] * len(shape)
        used: set = set()
        for dim, group in prefs:
            if dim >= len(shape) or spec[dim] is not None:
                continue
            axes = self.data_axes if group == "data" else self.model_axes
            if any(a in used for a in axes):
                continue
            if not self.seq_parallel_attn and name.startswith("act") and \
                    dim in (1,) and group == "model":
                continue
            if shape[dim] % _axes_size(self.mesh, axes) == 0:
                spec[dim] = axes if len(axes) > 1 else axes[0]
                used.update(axes)
        return P(*spec)

    def resolve_logits(self, shape) -> PartitionSpec:
        spec = [None] * len(shape)
        if shape[0] % _axes_size(self.mesh, self.data_axes) == 0:
            spec[0] = (self.data_axes if len(self.data_axes) > 1
                       else self.data_axes[0])
        if shape[-1] % _axes_size(self.mesh, self.model_axes) == 0:
            spec[-1] = (self.model_axes if len(self.model_axes) > 1
                        else self.model_axes[0])
        return P(*spec)

    def named(self, name: str, shape) -> NamedSharding:
        return NamedSharding(self.mesh, self.resolve(name, shape))


# Activation rules. dims refer to the logical layout noted per rule.
DEFAULT_RULES = {
    # (B, S, D)
    "act_btd": [(0, "data"), (1, "data")],
    # (B, S, H, Dh) query/out projections
    "act_qkv": [(0, "data"), (2, "model"), (1, "model"), (1, "data")],
    # (B, S, KV, Dh)
    "act_kv": [(0, "data"), (2, "model"), (1, "model"), (1, "data")],
    # (B, T, KV, Dh) decode-time cache — prefer sharding the long T axis
    # over model when KV heads don't divide (distributed flash-decoding).
    "kv_cache": [(0, "data"), (2, "model"), (1, "model"), (1, "data")],
    # (E, C, D) MoE expert-major buffers
    "moe_ecd": [(0, "model"), (1, "data")],
    # (B, S, F) mlp hidden
    "act_bsf": [(0, "data"), (2, "model"), (1, "model")],
    # (B, L, d_inner, d_state) mamba scan states (chunk-local)
    "mamba_h": [(0, "data"), (2, "model"), (1, "data")],
    # (B, d_inner, d_state) mamba decode state
    "mamba_state": [(0, "data"), (1, "model")],
    # (B, S, d_inner)
    "act_bsi": [(0, "data"), (2, "model"), (1, "model")],
    # (B, H, Dq, Dv) mlstm matrix state
    "mlstm_state": [(0, "data"), (1, "model"), (2, "model")],
    # (B, H, Dk) mlstm normalizer
    "mlstm_n": [(0, "data"), (1, "model")],
    # (B, Dp) slstm scalar state
    "slstm_state": [(0, "data"), (1, "model")],
    # (B, dc-1, d_inner) mamba conv carry
    "mamba_conv": [(0, "data"), (2, "model")],
    # (B, V) / (B, S, V) logits
    "logits": [(0, "data"), (-1, "model")],
}


@contextlib.contextmanager
def use_policy(policy: Optional[ShardingPolicy]):
    """Sets the policy that ``constrain`` and the model read.  Under a
    policy a plain tensor that meets a DTensor (an ``arange`` of
    positions, RoPE's frequencies) is taken as the whole tensor,
    replicated: each rank computes it alike."""
    prev = getattr(_STATE, "policy", None)
    _STATE.policy = policy
    try:
        if policy is None:
            yield policy
        else:
            with implicit_replication():
                yield policy
    finally:
        _STATE.policy = prev


def get_policy() -> Optional[ShardingPolicy]:
    return getattr(_STATE, "policy", None)


def constrain(x, rule: str):
    """``x`` redistributed to rule ``rule``'s placements under a policy;
    ``x`` itself, untouched, without one or when it is not a DTensor."""
    policy = get_policy()
    if policy is None or not isinstance(x, DTensor):
        return x
    if rule == "logits":
        # negative-dim rules resolved against concrete rank
        spec = policy.resolve_logits(x.shape)
    else:
        spec = policy.resolve(rule, x.shape)
    y = x.redistribute(x.device_mesh, placements(x.device_mesh, spec))
    if y.to_local().is_contiguous():
        return y
    # a shard cut from a replica is a strided view, which views of the
    # global shape (reshape to (B, S, H*Dh)) cannot take
    return DTensor.from_local(y.to_local().contiguous(), y.device_mesh,
                              y.placements, run_check=False, shape=y.shape,
                              stride=y.stride())


# ---------------------------------------------------------------------------
# Parameter partition specs
# ---------------------------------------------------------------------------

# (path regex, preferences) — dims are *after* stripping any leading
# period-stack dim (handled by param_spec). "model"/"data" groups as above.
_PARAM_RULES = [
    (r"tok_embed$", [(0, "model")]),
    (r"lm_head$", [(1, "model")]),
    (r"(wq|wk|wv)$", [(1, "model"), (2, "model"), (0, "model")]),
    (r"wo$", [(0, "model"), (1, "model"), (2, "model")]),
    (r"(w_gate|w_up)$", [(1, "model")]),
    (r"w_down$", [(0, "model")]),
    # MoE experts: (E, D, F) — expert parallelism on E.
    (r"experts/.*$", [(0, "model")]),
    (r"router.*$", []),
    # Mamba: shard d_inner wherever it appears.
    (r"mamba/in_proj$", [(1, "model")]),
    (r"mamba/(conv_w|conv_b|A_log|D|dt_bias)$", [(0, "model")]),
    (r"mamba/x_proj$", [(0, "model")]),
    (r"mamba/dt_proj$", [(1, "model")]),
    (r"mamba/out_proj$", [(0, "model")]),
    # xLSTM inner projections
    (r"(up_proj|gate_proj)$", [(1, "model")]),
    (r"down_proj$", [(0, "model")]),
    (r"(wqk|wv2)$", [(1, "model")]),
    (r"conv1d.*$", [(0, "model")]),
]


def param_spec(path: str, shape: Sequence[int], policy: ShardingPolicy,
               stacked: bool = False,
               for_opt_state: bool = False) -> PartitionSpec:
    """PartitionSpec for a parameter leaf at the reference's ``path``
    (``blocks/0/attn/wq``) and ``shape``.

    ``stacked`` marks per-period scan stacks whose dim0 is the period count.
    Optimizer-state variants (ZeRO-1) add ``data`` on the first free
    divisible dim.
    """
    offset = 1 if stacked else 0
    spec = [None] * len(shape)
    if policy.cp_replicate_weights and stacked:
        # context-parallel mode: block weights replicated over model;
        # only the (huge) embedding / lm_head stay model-sharded.
        if policy.serving and policy.serving_2d:
            for d in range(offset, len(shape)):
                if shape[d] % _axes_size(policy.mesh, policy.data_axes) == 0:
                    spec[d] = (policy.data_axes if len(policy.data_axes) > 1
                               else policy.data_axes[0])
                    break
        return P(*spec)
    for pat, prefs in _PARAM_RULES:
        if re.search(pat, path):
            used = set()
            for dim, group in prefs:
                d = dim + offset
                if d >= len(shape) or spec[d] is not None:
                    continue
                axes = (policy.model_axes if group == "model"
                        else policy.data_axes)
                if any(a in used for a in axes):
                    continue
                if shape[d] % _axes_size(policy.mesh, axes) == 0:
                    spec[d] = axes if len(axes) > 1 else axes[0]
                    used.update(axes)
            break
    if (for_opt_state and policy.zero1) or \
            (policy.serving and policy.serving_2d):
        used_names = {a for s in spec if s is not None
                      for a in (s if isinstance(s, tuple) else (s,))}
        if not any(a in used_names for a in policy.data_axes):
            for d in range(len(shape)):
                if spec[d] is None and shape[d] % _axes_size(
                        policy.mesh, policy.data_axes) == 0:
                    spec[d] = (policy.data_axes if len(policy.data_axes) > 1
                               else policy.data_axes[0])
                    break
    return P(*spec)


_STACKED = re.compile(r"^(blocks)\.(\d+)\.(\d+)\.(.+)$|^(enc_blocks)\.(\d+)"
                      r"\.(.+)$")


def reference_path(name: str) -> Tuple[str, Optional[str], Optional[int]]:
    """A port parameter name -> (the reference's pytree path, the path's
    stack key or None, the leaf's index in the stack): ``blocks.3.1.attn.
    wq`` is period 3 of ``blocks/1/attn/wq``, ``enc_blocks.5.mlp.w_up``
    layer 5 of ``enc_blocks/mlp/w_up``, ``embed.tok_embed`` is
    ``embed/tok_embed``, unstacked."""
    m = _STACKED.match(name)
    if m is None:
        return name.replace(".", "/"), None, None
    if m.group(1):
        path = f"blocks/{m.group(3)}/{m.group(4).replace('.', '/')}"
        return path, path, int(m.group(2))
    path = f"enc_blocks/{m.group(7).replace('.', '/')}"
    return path, path, int(m.group(6))


def _stacks(params) -> Dict[str, int]:
    """Each stacked reference path -> its stack depth (periods, encoder
    layers), counted from the port's per-period names."""
    depth: Dict[str, int] = {}
    for name in params:
        _, key, i = reference_path(name)
        if key is not None:
            depth[key] = max(depth.get(key, 0), i + 1)
    return depth


def tree_param_specs(params, policy: ShardingPolicy,
                     for_opt_state: bool = False) -> Dict[str, PartitionSpec]:
    """``{name: spec}`` for the port's ``{name: tensor}`` parameters (any
    objects with ``.shape``): each block leaf's spec is the reference's for
    its period stack, ``(n_periods, *shape)``, as ``tree_param_specs``
    there gives it (period stacks under any path containing 'blocks' get
    their leading dim skipped by the rules)."""
    depth = _stacks(params)
    specs = {}
    for name, leaf in params.items():
        path, key, _ = reference_path(name)
        shape = tuple(leaf.shape)
        if key is not None:
            shape = (depth[key], *shape)
        specs[name] = param_spec(path, shape, policy, stacked="blocks" in path,
                                 for_opt_state=for_opt_state)
    return specs


def period_spec(spec: PartitionSpec, shape: Sequence[int],
                mesh) -> Tuple[PartitionSpec, Tuple[str, ...]]:
    """A stacked spec placed on one per-period tensor of ``shape``: (its
    spec, the axes left replicated).  The stack dim's axes move to the
    first free dim whose size they divide; with none, they are left."""
    lead, rest = spec[0], list(spec[1:])
    if lead is None:
        return P(*rest), ()
    for d, size in enumerate(shape):
        if rest[d] is None and size % _axes_size(mesh,
                                                 _entry_axes(lead)) == 0:
            rest[d] = lead
            return P(*rest), ()
    return P(*rest), _entry_axes(lead)


def period_stack_placements(params, policy: ShardingPolicy,
                            for_opt_state: bool = False):
    """``({name: per-tensor spec}, {name: axes left replicated})`` for the
    port's parameters: ``tree_param_specs`` with each stacked spec placed
    by ``period_spec``."""
    depth = _stacks(params)
    specs, replicated = {}, {}
    for name, spec in tree_param_specs(params, policy,
                                       for_opt_state).items():
        shape = tuple(params[name].shape)
        if reference_path(name)[1] in depth:
            spec, left = period_spec(spec, shape, policy.mesh)
            if left:
                replicated[name] = left
        specs[name] = spec
    return specs, replicated


def tree_shardings(params, policy: ShardingPolicy,
                   for_opt_state: bool = False) -> Dict[str, NamedSharding]:
    """``{name: NamedSharding}`` over ``policy.mesh`` for the port's
    parameters, each per-period tensor placed by
    ``period_stack_placements``."""
    specs, _ = period_stack_placements(params, policy, for_opt_state)
    return {name: NamedSharding(policy.mesh, s) for name, s in specs.items()}
