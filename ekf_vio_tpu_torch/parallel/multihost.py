"""Multi-process launch: the ``torch.distributed`` bootstrap, the
host-aware ('data', 'state') mesh and the per-process batch share.

Port of ``ekf_vio_tpu/parallel/multihost.py``.  One process drives one
device.  ``data`` (independent sequences, no per-frame traffic) spans
hosts; ``state`` (the Σ block partition, all-gathers every frame,
``parallel/sharded_filter.py``) stays inside a host, where the devices
share NVLink rather than the network.
"""
from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ekf_vio_tpu_torch.engine import resolve_device
from ekf_vio_tpu_torch.parallel.mesh import AXES


def free_port() -> int:
    """A TCP port on 127.0.0.1 that is free now (for a one-host store)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           platform: str | None = None) -> dict:
    """Bring up the process group from the arguments or the launcher's
    environment (``EKF_VIO_COORDINATOR`` as host:port,
    ``EKF_VIO_NUM_PROCESSES``, ``EKF_VIO_PROCESS_ID``,
    ``EKF_VIO_PLATFORM``), through ``init_process_group`` with
    ``init_method="tcp://<coordinator>"``.

    The backend is NCCL on the card (process i on card i mod the local
    count); gloo only when the platform is "cpu".  Without a card and
    without "cpu" it raises.  One process with no coordinator gets a
    localhost store on a free port.  If the group is already up it is
    left as it is.  Returns the JAX function's dict: process_count,
    process_index, local_devices (one a process), global_devices."""
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("EKF_VIO_COORDINATOR")
    if num_processes is None:
        v = env.get("EKF_VIO_NUM_PROCESSES")
        num_processes = int(v) if v else 1
    if process_id is None:
        v = env.get("EKF_VIO_PROCESS_ID")
        process_id = int(v) if v else 0
    platform = platform or env.get("EKF_VIO_PLATFORM") or "cuda"

    if not dist.is_initialized():
        if platform == "cpu":
            backend = "gloo"
        elif not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; set "
                               "EKF_VIO_PLATFORM=cpu (or pass "
                               "platform='cpu') for gloo on the CPU")
        else:
            backend = "nccl"
            torch.cuda.set_device(process_id % torch.cuda.device_count())
        if coordinator_address is None:
            if num_processes != 1:
                raise ValueError(f"{num_processes} processes need a "
                                 f"coordinator address")
            coordinator_address = f"127.0.0.1:{free_port()}"
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id)
    world = dist.get_world_size()
    return {"process_count": world, "process_index": dist.get_rank(),
            "local_devices": 1, "global_devices": world}


def pod_layout(world: int, n_state: int = 1, n_hosts: int = 1):
    """The rank grid [data, state] of ``make_pod_mesh``: ranks host-major
    (a host's ranks contiguous), ``state`` the fastest-varying axis, so
    every state row lies inside one host.  A pure function of the sizes,
    with the JAX function's divisibility errors."""
    per_host = world // n_hosts
    if per_host * n_hosts != world:
        raise ValueError(f"{world} devices not divisible by {n_hosts} hosts")
    if per_host % n_state != 0:
        raise ValueError(f"state axis {n_state} must divide the per-host "
                         f"device count {per_host} (NVLink locality)")
    return torch.arange(world).reshape(n_hosts * (per_host // n_state),
                                       n_state)


def make_pod_mesh(n_state: int | None = None, world: int | None = None,
                  n_hosts: int | None = None, device="cuda") -> DeviceMesh:
    """The ('data', 'state') mesh over the first ``world`` ranks (default:
    all), ``state`` inside a host.  ``n_hosts`` defaults to the number of
    distinct host names among those ranks (one all_gather_object), which
    torchrun-style launchers number host-major."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed "
                           "first")
    world = dist.get_world_size() if world is None else world
    if n_hosts is None:
        names = [None] * dist.get_world_size()
        dist.all_gather_object(names, socket.gethostname())
        n_hosts = len(set(names[:world]))
    ranks = pod_layout(world, 1 if n_state is None else n_state, n_hosts)
    return DeviceMesh(dev.type, ranks, mesh_dim_names=AXES)


def host_local_batch(global_batch: int,
                     processes: int | None = None) -> int:
    """Per-process share of a batch split over ``processes`` (default:
    the world size, 1 without a process group)."""
    if processes is None:
        processes = dist.get_world_size() if dist.is_initialized() else 1
    if global_batch % processes != 0:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{processes} processes")
    return global_batch // processes
