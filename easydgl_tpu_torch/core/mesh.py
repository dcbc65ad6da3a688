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

DATA, MODEL, SEQ = "data", "model", "seq"


def resolve_shape(cfg: MeshConfig, world: int) -> Tuple[int, ...]:
    """The mesh's shape, (dp, mp) or (dp, mp, cp), resolved as JAX's
    ``make_mesh`` resolves it (core/mesh.py:32-49): cp must divide the
    world; dp and mp take ``world // cp``, both -1 putting every rank on
    the data axis and one -1 taking what the other leaves; the seq axis
    is appended only when cp > 1."""
    if cfg.pp > 1:
        raise NotImplementedError(
            f"pp={cfg.pp}: pipeline parallelism is not ported yet "
            "(ROADMAP A.3b)")
    cp = cfg.cp
    if cp < 1 or world % cp:
        raise ValueError(f"{world} ranks not divisible by cp={cp}")
    n = world // cp
    dp, mp = cfg.dp, cfg.mp
    if dp == -1 and mp == -1:
        dp, mp = n, 1
    elif dp == -1:
        if n % mp:
            raise ValueError(f"{n} ranks not divisible by mp={mp}")
        dp = n // mp
    elif mp == -1:
        if n % dp:
            raise ValueError(f"{n} ranks not divisible by dp={dp}")
        mp = n // dp
    if dp * mp * cp != world:
        raise ValueError(f"dp*mp*cp={dp * mp * cp} != {world} ranks")
    return (dp, mp, cp) if cp > 1 else (dp, mp)


def make_mesh(cfg: MeshConfig = MeshConfig(), device_type: str = "cuda"):
    """The (data, model[, seq]) ``DeviceMesh`` over every rank of the
    initialised process group (``core/runtime.py::init_distributed``)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = resolve_shape(cfg, dist.get_world_size())
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=(DATA, MODEL, SEQ)[:len(shape)])


def _dim(mesh, name: str) -> Optional[int]:
    names = mesh.mesh_dim_names or ()
    return names.index(name) if name in names else None


def data_index(mesh) -> int:
    return mesh.get_local_rank(DATA)


def data_size(mesh) -> int:
    return mesh.size(_dim(mesh, DATA))


def model_index(mesh) -> int:
    return mesh.get_local_rank(MODEL)


def model_size(mesh) -> int:
    return mesh.size(_dim(mesh, MODEL))


def data_group(mesh):
    return mesh.get_group(DATA)


def model_group(mesh):
    return mesh.get_group(MODEL)


def seq_size(mesh) -> int:
    """Size of the mesh's context-parallel (sequence) axis: 1 without a
    mesh or without a seq axis (JAX ``core/mesh.py:65``,
    ``seq_axis_info``)."""
    if mesh is None:
        return 1
    d = _dim(mesh, SEQ)
    return 1 if d is None else mesh.size(d)


def seq_index(mesh) -> int:
    """This rank's coordinate on the seq axis (0 without one)."""
    return mesh.get_local_rank(SEQ) if seq_size(mesh) > 1 else 0


def seq_group(mesh):
    return mesh.get_group(SEQ)


def replicas(mesh) -> int:
    """How many ranks of one data group hold each replicated leaf: mp cp."""
    return model_size(mesh) * seq_size(mesh)


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
