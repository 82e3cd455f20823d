"""Version shim for the distributed layer: every import of the DTensor API
goes through here.

DTensor moved from ``torch.distributed._tensor`` to the public
``torch.distributed.tensor`` (with ``local_map`` under its
``experimental`` package) in torch 2.5; the port runs on 2.11 on the card
and 2.13 on the CPU, both public.  ``shard_map`` keeps the signature of
the reference package's ``distributed/compat.py::shard_map``, with
``PartitionSpec``s as its specs, and runs over ``local_map``.
"""
from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from torch.distributed.tensor import zeros as dtensor_zeros
from torch.distributed.tensor.experimental import (implicit_replication,
                                                   local_map)

__all__ = ["DTensor", "DeviceMesh", "Partial", "Replicate", "Shard",
           "distribute_tensor", "dtensor_zeros", "implicit_replication",
           "init_device_mesh", "local_map", "local_shape_and_offset",
           "shard_map"]


def local_shape_and_offset(shape, mesh, placements):
    """(this rank's shard shape, its offset in the global tensor) of a
    DTensor of ``shape`` at ``placements`` (a private helper of torch's,
    the same from 2.1 to 2.13)."""
    return compute_local_shape_and_global_offset(tuple(shape), mesh,
                                                 placements)


def _placements_tree(mesh, specs, grad=False):
    """A spec, or a tuple of them, as ``local_map`` placements (None for
    an argument that is not a tensor, as ``local_map`` takes it); with
    ``grad``, the placements of the gradient: a pending sum over each
    mesh dim the spec does not cut."""
    from repro_torch.distributed.sharding import PartitionSpec, placements
    if specs is None:
        return None
    if isinstance(specs, PartitionSpec):
        return tuple(Partial() if grad and isinstance(p, Replicate) else p
                     for p in placements(mesh, specs))
    return tuple(_placements_tree(mesh, s, grad) for s in specs)


def shard_map(f, mesh, in_specs, out_specs, check_vma: bool = True):
    """``f`` run on each rank's local shards: each DTensor argument is
    redistributed to the placements of its spec in ``in_specs`` (a spec a
    positional argument, None for a non-tensor one), ``f`` gets the local
    tensors, and its outputs are wrapped as DTensors with the placements
    of ``out_specs``.  As in JAX, an argument's gradient is summed over
    the mesh dims its spec leaves whole (each rank's local gradient is
    its share), so a term that every rank of such a dim computes alike
    must reach the gradient from one of them only.  ``check_vma`` is the
    reference's replication check; ``local_map`` makes none, so an output
    declared replicated must be the same on every rank by construction (a
    ``psum`` or ``pmean`` inside ``f``)."""
    del check_vma
    return local_map(f, out_placements=_placements_tree(mesh, out_specs),
                     in_placements=_placements_tree(mesh, in_specs),
                     in_grad_placements=_placements_tree(mesh, in_specs,
                                                         grad=True),
                     device_mesh=mesh, redistribute_inputs=True)
