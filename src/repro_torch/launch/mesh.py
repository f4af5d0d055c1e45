"""Meshes of the port (counterpart of ``repro.launch.mesh``): single-pod
(16 x 16 = 256 devices) and multi-pod (2 pods x 256 = 512 devices)
production meshes, and small local meshes.

Functions only, never module-level meshes: importing this module touches
no process group. A ``DeviceMesh`` spans the ranks of an initialized
``torch.distributed`` group, one device a rank. The one-device mesh needs
no group: ``OneDeviceMesh`` carries the axis names and sizes (all 1) that
the rules and the parallel paths read, and every parallel path takes its
``n == 1`` branch on it, so nothing is wrapped in a DTensor.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


def production_shape(multi_pod: bool = False) -> Dict[str, int]:
    """{axis: size} of the production mesh."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def mesh_tag(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "16x16"


@dataclasses.dataclass(frozen=True)
class OneDeviceMesh:
    """A mesh of one device, every axis of size 1, without a process
    group; the attributes of a ``DeviceMesh`` that the port reads."""
    device_type: str
    mesh_dim_names: Tuple[str, ...] = ("data", "model")

    @property
    def shape(self) -> Tuple[int, ...]:
        return (1,) * len(self.mesh_dim_names)


def _device_mesh(device_type: str, shape: Tuple[int, ...],
                 names: Tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model"), over an initialized group of 256 / 512 ranks (the dry run's
    fake group, ``launch.dryrun``)."""
    shape = production_shape(multi_pod)
    if not dist.is_initialized() or \
            dist.get_world_size() != int(torch.Size(shape.values()).numel()):
        raise RuntimeError(f"the production mesh {shape} needs an "
                           f"initialized process group of that many ranks")
    return _device_mesh(device_type, tuple(shape.values()), tuple(shape))


def make_local_mesh(data: int = 1, model: int = 1, device=None):
    """A (data, model) mesh on ``device`` (default ``cuda``). With an
    initialized group of data x model ranks it is a ``DeviceMesh`` over
    them; with no group and data x model == 1 it is a ``OneDeviceMesh``;
    anything else raises."""
    dev = resolve_device(device)
    names = ("data", "model")
    if dist.is_initialized():
        if dist.get_world_size() != data * model:
            raise ValueError(f"a ({data}, {model}) mesh on a group of "
                             f"{dist.get_world_size()} ranks")
        return _device_mesh(dev.type, (data, model), names)
    if data * model != 1:
        raise RuntimeError(f"a ({data}, {model}) mesh needs an initialized "
                           f"process group of {data * model} ranks")
    return OneDeviceMesh(dev.type, names)
