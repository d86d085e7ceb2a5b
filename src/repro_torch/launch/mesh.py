"""Device meshes (the port of ``repro.launch.mesh``) over
``torch.distributed``'s ``DeviceMesh``.

A mesh needs a process group that the caller has initialised (``make_mesh``
raises without one rather than building a world in silence), and importing
this module touches no process-group state. ``dp_axes`` and ``axis_size``
read a mesh through ``axis_names``/``shape_of``: a ``DeviceMesh`` (its
``mesh_dim_names`` and shape tuple) or any stand-in with ``axis_names`` and
a ``shape`` mapping, as the reference's tests use a ``FakeMesh``.
"""
from __future__ import annotations

from typing import Dict, Tuple

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def init_process_group(device: str = "cuda") -> None:
    """Join or start the default process group, for a launcher that asks
    for a mesh: from the environment where a launcher (``torchrun``) set
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``, else one
    rank on a store on 127.0.0.1 at a free port. NCCL for ``cuda`` (each
    rank on the card of its ``LOCAL_RANK``), gloo for ``cpu``. A no-op
    where a group exists."""
    import os
    import socket

    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
        return
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)


def make_mesh(shape, axes, device: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the initialised
    default process group (whose world size is the shape's product)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """16 x 16 = 256 ranks over ``("data", "model")``; with ``multi_pod``
    2 x 16 x 16 = 512 over ``("pod", "data", "model")``."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return make_mesh(shape, axes, device=device)


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def shape_of(mesh) -> Dict[str, int]:
    """{axis name: size}."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(axis_names(mesh), (int(s) for s in shape)))


def dp_axes(mesh) -> tuple:
    """Data-parallel mesh axes (gradient-reduction domain)."""
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def axis_size(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    shape = shape_of(mesh)
    n = 1
    for a in axes:
        n *= shape[a]
    return n
