"""Process-group start-up (port of ``easydgl_tpu.core.runtime``).

One process per rank, one device per process: ``init_distributed`` starts
``torch.distributed`` (NCCL on ``cuda``, gloo on the CPU) from explicit
values (``--coordinator_address/--num_processes/--process_id``), from
torchrun's ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``MASTER_ADDR``/
``MASTER_PORT``, or, with neither, as a world of one on a free local port.
A ``cuda`` rank runs on ``cuda:LOCAL_RANK``; asking for ``cuda`` where
there is none raises, as ``device.resolve_device`` does. A group that is
already up is reused.

``host_shard_info`` gives the loader its shard: the rank's coordinate and
size on the mesh's DATA axis, so that the model-axis ranks of one data
group read the same rows.
"""
from __future__ import annotations

import logging
import os
import socket
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from easydgl_tpu_torch.device import resolve_device

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class HostInfo:
    host_id: int          # the rank
    num_hosts: int        # the world size
    local_rank: int
    device: torch.device


def free_port() -> int:
    """A TCP port free on this machine's loopback interface."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device="cuda") -> HostInfo:
    """Start (or reuse) the process group; returns this rank's place and
    device."""
    dev = resolve_device(device)
    env = os.environ
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        local = (torch.cuda.current_device() if dev.type == "cuda" else 0)
    else:
        if num_processes is not None:
            if num_processes > 1 and (coordinator_address is None
                                      or process_id is None):
                raise ValueError("--num_processes > 1 needs "
                                 "--coordinator_address host:port and "
                                 "--process_id")
            world, rank = num_processes, process_id or 0
            if coordinator_address is None:
                coordinator_address = f"127.0.0.1:{free_port()}"
            init_method = f"tcp://{coordinator_address}"
        elif "WORLD_SIZE" in env:
            world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
            init_method = "env://"
        else:
            world, rank = 1, 0
            init_method = f"tcp://127.0.0.1:{free_port()}"
        local = int(env.get("LOCAL_RANK", rank))
        kw = {}
        if dev.type == "cuda":
            local %= torch.cuda.device_count()
            torch.cuda.set_device(local)
            kw["device_id"] = torch.device("cuda", local)
        else:
            local = 0
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=init_method, rank=rank,
                                world_size=world, **kw)
    if dev.type == "cuda":
        dev = torch.device("cuda", local)
    info = HostInfo(rank, world, local, dev)
    log.info("runtime: rank %d/%d on %s (%s)", rank, world, dev,
             dist.get_backend())
    return info


def host_shard_info(mesh=None) -> Tuple[int, int]:
    """(data coordinate, data size) of this rank; (0, 1) without a mesh."""
    if mesh is None:
        return 0, 1
    from easydgl_tpu_torch.core.mesh import data_index, data_size
    return data_index(mesh), data_size(mesh)
