"""Process groups and device meshes for multi-device training.

Counterpart of `gaussianeditor_tpu/parallel/mesh.py` (`make_mesh`,
`initialize_distributed`). One process per rank, each on one device
that its caller names: `initialize_distributed` joins the ranks into
the default process group, and a `DeviceMesh` names its dimensions
("data", or "view" and "tile") and hands out each dimension's group.
Parameters are replicated on every rank; the steps of
`parallel/sharded_step.py` and `parallel/mesh2d.py` reduce gradients
across ranks with `torch.distributed.all_reduce`.

Backends: NCCL for ranks on CUDA devices, one device per rank; gloo on
the CPU. Gloo also takes CUDA tensors for `all_reduce` and
`all_gather`, moving them through the host, so ranks that share one
card run under gloo (NCCL refuses two ranks on one device). The mesh's
device type names the backend's transport: "cuda" under NCCL, "cpu"
under gloo, whichever device the tensors are on. Nothing falls back:
a rank asked to run on CUDA where there is none raises.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from gaussianeditor_tpu_torch import resolve_device


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None, *,
                           device="cuda",
                           timeout: Optional[timedelta] = None
                           ) -> torch.device:
    """Join this process to the default process group as one rank on
    `device`; returns the device.

    coordinator: "host:port" of rank 0's store, with `num_processes` and
    `process_id`; without it the group reads torchrun's environment
    (`env://`: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK). backend:
    "nccl" by default when `device` is CUDA (the device becomes this
    process's current one), "gloo" on the CPU. timeout: how long a
    collective waits for the other ranks (the backend's default when
    None)."""
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and "
                             "process_id")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id,
                                timeout=timeout)
    else:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    return dev


def _mesh_device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_devices: Optional[int] = None, axis: str = "data"
              ) -> DeviceMesh:
    """A 1-D mesh named `axis` over every rank of the default group;
    `n_devices`, when given, must be the world size."""
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"need {n_devices} ranks, have {world}")
    return DeviceMesh(_mesh_device_type(), torch.arange(world),
                      mesh_dim_names=(axis,))


def make_mesh_2d(shape: Sequence[int],
                 axes: Sequence[str] = ("view", "tile")) -> DeviceMesh:
    """A 2-D mesh of `shape` (rank r at row r // shape[1], column
    r % shape[1]) over every rank of the default group, its dimensions
    named `axes`."""
    n0, n1 = (int(v) for v in shape)
    world = dist.get_world_size()
    if n0 * n1 != world:
        raise ValueError(f"a {n0}x{n1} mesh needs {n0 * n1} ranks, have "
                         f"{world}")
    return DeviceMesh(_mesh_device_type(),
                      torch.arange(world).reshape(n0, n1),
                      mesh_dim_names=tuple(axes))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along `axis`."""
    return int(mesh.get_local_rank(axis))
