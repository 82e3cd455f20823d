"""One rank's cost of a step, counted op by op as the step runs: the
counterpart of the reference's ``compiled.cost_analysis()`` and
``memory_analysis()`` for the port's eager steps.

``StepCost`` is a ``TorchDispatchMode``.  It counts the local ops a rank
runs, never the DTensor-level op above them: it hands every op with a
DTensor argument back to DTensor (``NotImplemented``), whose local ops
then come through the mode, and it skips the ops of DTensor's sharding
propagation, which run on ``FakeTensor``s of the global shapes.  A
replicated placement's work is counted on the rank, as every rank runs
it.  Per op:

- ``flops``: ``torch.utils.flop_counter``'s formulas (products,
  convolutions, attention, and the ``repro_torch`` kernels' own), as
  ``FlopCounterMode`` counts them;
- ``bytes_accessed``: the bytes of every tensor operand and result of
  an op that moves data (views, ``as_strided`` and metadata ops count
  zero); eager and unfused, an upper bound on the HBM traffic;
- memory: the bytes of live storages, from the arguments' (``hold``) and
  each new result's storage to its release, and their peak;
- ``collectives``: each ``c10d`` collective by kind with the bytes of
  its result (an all-gather's gathered destination).

It runs alike over meta tensors (a trace: nothing is computed or
allocated) and over a real call on the card.
"""
from __future__ import annotations

import re
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed.compat import DTensor

_aten = torch.ops.aten
# ops that move no data: metadata, allocation and the waits of collectives
_NO_DATA = {
    _aten.detach.default, _aten._unsafe_view.default, _aten.alias.default,
    _aten.lift_fresh.default, _aten.empty.memory_format,
    _aten.empty_strided.default, _aten.empty_like.default,
    _aten.new_empty.default, _aten.new_empty_strided.default,
    torch.ops.prim.device.default,
    torch.ops._c10d_functional.wait_tensor.default,
}
_KINDS = ((r"all_?gather", "all-gather"), (r"reduce_scatter", "reduce-scatter"),
          (r"all_?reduce", "all-reduce"), (r"all_?to_?all", "all-to-all"),
          (r"broadcast", "broadcast"), (r"send|recv|permute",
                                        "collective-permute"))


def collective_kind(func) -> str | None:
    """The reference's name for ``func``'s collective (``"all-gather"``,
    ...), or None for an op that is not one."""
    ns, _, name = func._overloadpacket._qualified_op_name.partition("::")
    if ns not in ("_c10d_functional", "c10d"):
        return None
    return next((kind for pat, kind in _KINDS if re.search(pat, name)), None)


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def collective_stats(events) -> dict:
    """``{kind: {"count": n, "bytes": b}}`` over ``(kind, bytes)`` events,
    as the reference's ``collective_stats`` sums an HLO's collectives."""
    stats: dict = {}
    for kind, nbytes in events:
        e = stats.setdefault(kind, {"count": 0, "bytes": 0})
        e["count"] += 1
        e["bytes"] += int(nbytes)
    return stats


def _locals(tree):
    """The local tensors of every tensor leaf of ``tree`` (dicts, tuples,
    named tuples): a DTensor's local shard, a tensor itself."""
    return [leaf.to_local() if isinstance(leaf, DTensor) else leaf
            for leaf in tree_leaves(tree) if isinstance(leaf, torch.Tensor)]


def storage_bytes(tree) -> dict:
    """``{storage key: bytes}`` of the local tensors of ``tree``."""
    out = {}
    for t in _locals(tree):
        st = t.untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


class StepCost(TorchDispatchMode):
    """Counts one rank's local ops while it is entered (see the module's
    docstring): ``flops``, ``bytes_accessed``, ``events`` (collectives),
    ``live`` and ``peak`` bytes of storage."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.events = []
        self.live = 0
        self.peak = 0
        self._storages = {}

    def hold(self, tree) -> int:
        """Counts the storages of ``tree``'s local tensors as live (a step's
        arguments); returns their bytes.  Called before the mode is
        entered, so that taking a DTensor's local tensor is not an op."""
        held = 0
        for t in _locals(tree):
            held += self._track(t)
        return held

    def _track(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return 0
        nbytes = st.nbytes()
        self._storages[key] = (nbytes, weakref.ref(
            st, lambda _, key=key: self._release(key)))
        self.live += nbytes
        self.peak = max(self.peak, self.live)
        return nbytes

    def _release(self, key) -> None:
        nbytes, _ = self._storages.pop(key, (0, None))
        self.live -= nbytes

    @property
    def collectives(self) -> dict:
        return collective_stats(self.events)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves = tree_leaves((args, kwargs))
        if any(isinstance(t, DTensor) for t in leaves):
            return NotImplemented
        packet = func._overloadpacket
        if packet not in flop_registry and func is not \
                torch.ops.prim.device.default:
            # as FlopCounterMode: an op with a decomposition is counted by
            # the ops it decomposes into
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        ins = [t for t in leaves if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out            # DTensor's sharding propagation
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        kind = collective_kind(func)
        if kind is not None:
            self.events.append((kind, sum(map(tensor_bytes, outs))))
        if not (func.is_view or func in _NO_DATA):
            self.bytes_accessed += sum(map(tensor_bytes, ins + outs))
        for t in outs:
            self._track(t)
        return out
