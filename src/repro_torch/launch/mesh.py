"""Production mesh factories (single-pod 16x16, multi-pod 2x16x16),
PyTorch port of ``repro.launch.mesh``: a ``DeviceMesh`` over the current
default process group, which the caller has set up (a real NCCL or gloo
group, or the dry run's fake one).

Functions, not module-level constants: importing this module touches no
process group.
"""

from __future__ import annotations

from torch.distributed.device_mesh import init_device_mesh

__all__ = ["make_production_mesh", "make_host_mesh", "fsdp_axes", "batch_axes",
           "mesh_shape"]


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1, device_type: str = "cuda"):
    """Small mesh over however many ranks the group has: for tests and one card."""
    return init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))


def mesh_shape(mesh) -> dict[str, int]:
    """Axis name -> size (``jax.sharding.Mesh.shape``).  ``mesh`` is a
    ``DeviceMesh``, or any object with ``mesh_dim_names`` and ``shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def batch_axes(mesh) -> tuple[str, ...]:
    """Axes that carry data parallelism (batch/FSDP sharding)."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def fsdp_axes(mesh) -> tuple[str, ...]:
    return batch_axes(mesh)
