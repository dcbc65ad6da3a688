"""Device mesh of the distributed layer (port of ``easydgl_tpu.core.mesh``).

JAX runs one process that sees every device and leaves the collectives to
XLA. Here each rank is a process with one device, and the collectives are
written out through ``torch.distributed`` (``dist/comm.py``): NCCL on the
card, gloo on the CPU. The mesh is a ``DeviceMesh`` of dims ``("data",
"model")``, rank r at (r // mp, r % mp): the dense tower is data-parallel
over "data"; the item table's rows and whole attention heads are split over
"model".

A rank asks the mesh four things: its data coordinate and size (which rows
of the batch it holds, ``data_index`` / ``data_size``), its model coordinate
and size (``model_index`` / ``model_size``), the process groups of both
dims, and its slice of a table's rows (``table_rows``).

``use_spmd_mesh`` marks the mesh a step runs under; mesh-agnostic code
(``compute_loss``, the MAU and attention modules, the item embedding, the
tied scoring) reads it with ``spmd_mesh()`` and takes its distributed
branch, as the JAX package's trace-time context does.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Tuple

import torch.distributed as dist

from easydgl_tpu_torch.config import MeshConfig

DATA, MODEL = 0, 1


def resolve_shape(cfg: MeshConfig, world: int) -> Tuple[int, int]:
    """(dp, mp) with -1 resolved as JAX resolves it: both -1 puts every
    rank on the data axis; one -1 takes what the other leaves."""
    if cfg.cp > 1 or cfg.pp > 1:
        raise NotImplementedError(
            f"cp={cfg.cp}, pp={cfg.pp}: context and pipeline parallelism "
            "are not ported yet (ROADMAP A.3)")
    dp, mp = cfg.dp, cfg.mp
    if dp == -1 and mp == -1:
        dp, mp = world, 1
    elif dp == -1:
        if world % mp:
            raise ValueError(f"{world} ranks not divisible by mp={mp}")
        dp = world // mp
    elif mp == -1:
        if world % dp:
            raise ValueError(f"{world} ranks not divisible by dp={dp}")
        mp = world // dp
    if dp * mp != world:
        raise ValueError(f"dp*mp={dp * mp} != {world} ranks")
    return dp, mp


def make_mesh(cfg: MeshConfig = MeshConfig(), device_type: str = "cuda"):
    """The (data, model) ``DeviceMesh`` over every rank of the initialised
    process group (``core/runtime.py::init_distributed``)."""
    from torch.distributed.device_mesh import init_device_mesh
    dp, mp = resolve_shape(cfg, dist.get_world_size())
    return init_device_mesh(device_type, (dp, mp),
                            mesh_dim_names=("data", "model"))


def data_index(mesh) -> int:
    return mesh.get_local_rank(DATA)


def data_size(mesh) -> int:
    return mesh.size(DATA)


def model_index(mesh) -> int:
    return mesh.get_local_rank(MODEL)


def model_size(mesh) -> int:
    return mesh.size(MODEL)


def data_group(mesh):
    return mesh.get_group(DATA)


def model_group(mesh):
    return mesh.get_group(MODEL)


def table_rows(mesh, rows: int) -> Optional[Tuple[int, int]]:
    """[start, stop) of this rank's slice of a ``rows``-row table split
    over the model axis, or None where it stays whole (mp == 1, or mp does
    not divide the rows)."""
    mp = model_size(mesh)
    if mp == 1 or rows % mp:
        return None
    n = rows // mp
    start = model_index(mesh) * n
    return start, start + n


def head_split(mesh, num_heads: int) -> int:
    """How many ways whole heads split over the model axis: mp where it
    divides the head count, else 1 (heads stay whole on every rank)."""
    mp = model_size(mesh)
    return mp if mp > 1 and num_heads % mp == 0 else 1


_SPMD_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "spmd_mesh", default=None)


def spmd_mesh():
    """The mesh a sharded step is running under, or None."""
    return _SPMD_MESH.get()


@contextlib.contextmanager
def use_spmd_mesh(mesh):
    token = _SPMD_MESH.set(mesh)
    try:
        yield
    finally:
        _SPMD_MESH.reset(token)
