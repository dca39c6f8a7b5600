"""Mesh factory (port of ``repro.launch.mesh``) over ``torch.distributed``'s
``DeviceMesh``.

A mesh is one rank a device: ``make_mesh`` needs an initialised process
group whose world size is the product of the shape, and raises otherwise (the
port never runs a mesh quietly unsharded).  ``MeshShape`` is the device-free
stand-in: it has the two attributes the rules in ``runtime/sharding.py``
read, so the rules resolve (and are tested) without ranks.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_AXES = ("pod", "data", "model")


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes, without devices."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def axis_names(mesh) -> Tuple[str, ...]:
    """The axis names of a ``MeshShape`` or a ``DeviceMesh``."""
    names = getattr(mesh, "axis_names", None)
    return tuple(names if names is not None else mesh.mesh_dim_names)


def axis_size(mesh, name: str) -> int:
    """The size of axis ``name`` of a ``MeshShape`` or a ``DeviceMesh``."""
    if isinstance(mesh, MeshShape):
        return mesh.shape[name]
    return mesh.size(axis_names(mesh).index(name))


def make_mesh(shape: Tuple[int, ...], axes: Optional[Tuple[str, ...]] = None,
              device: Optional[torch.device] = None):
    """A ``DeviceMesh`` of ``shape`` over the initialised process group, on
    ``device``'s type (default: cuda).  Ranks fill it row-major, as JAX's
    ``make_mesh`` fills its devices."""
    shape = tuple(int(n) for n in shape)
    if axes is None:
        axes = DEFAULT_AXES[-len(shape):]
    n = int(np.prod(shape))
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else None
    if world != n:
        raise ValueError(
            f"mesh {shape} needs an initialised process group of world size {n}, "
            f"have {'none' if world is None else world}"
        )
    from torch.distributed.device_mesh import init_device_mesh

    device_type = torch.device("cuda" if device is None else device).type
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device: Optional[torch.device] = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def parse_shape(spec: str) -> Tuple[int, ...]:
    """'16x16' -> (16, 16); '2x16x16' -> (2, 16, 16)."""
    return tuple(int(x) for x in spec.lower().split("x"))


def parse_mesh(spec: str, device: Optional[torch.device] = None):
    """'16x16' -> (data, model); '2x16x16' -> (pod, data, model)."""
    return make_mesh(parse_shape(spec), device=device)
