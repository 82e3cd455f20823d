"""Production mesh construction, the reference package's
``launch/mesh.py`` over an initialised ``torch.distributed`` process
group.

A function (not a module-level constant) so importing this module never
touches the process group.  Single pod: 256 ranks as (data=16,
model=16).  Multi-pod: 2 pods x 256 ranks as (pod=2, data=16, model=16);
the ``pod`` axis carries only data-parallel gradient all-reduce.  Each
raises unless the group is there, and of the size the mesh needs.  The
mesh's device type follows the group's backend ("cuda" for NCCL, "cpu"
for gloo) unless ``device_type`` names one: the dry run traces the
card's path, "cuda", over a fake group.
"""
from __future__ import annotations

import torch.distributed as dist

from repro_torch.distributed.compat import init_device_mesh


def _world(what: str) -> int:
    if not dist.is_initialized():
        raise RuntimeError(f"{what} needs an initialised process group "
                           f"(torch.distributed.init_process_group)")
    return dist.get_world_size()


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = _world("make_production_mesh")
    need = 512 if multi_pod else 256
    if n != need:
        raise RuntimeError(f"the production mesh {shape} needs {need} ranks; "
                           f"the process group has {n}")
    return init_device_mesh(device_type or _device_type(), shape,
                            mesh_dim_names=axes)


def make_host_mesh(model: int = 1, device_type: str | None = None):
    """A (world / model, model) mesh of ("data", "model") over the
    initialised group (tests, CPU runs, a dry run's small meshes)."""
    n = _world("make_host_mesh")
    if n % model:
        raise ValueError(f"model axis {model} does not divide the world {n}")
    return init_device_mesh(device_type or _device_type(), (n // model, model),
                            mesh_dim_names=("data", "model"))


def data_axes_of(mesh) -> tuple:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def model_axes_of(mesh) -> tuple:
    return ("model",)
