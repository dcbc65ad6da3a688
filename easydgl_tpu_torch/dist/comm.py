"""Collectives of the distributed layer, with the backward each needs.

XLA's partitioner and ``shard_map``'s transpose inserted these in the JAX
package; here each is written out. Every model-axis rank of a data group
runs the same dense graph on the same rows, so the gradient that reaches a
collective from above is the same on each of them. That fixes the
conjugate pairs:

* ``all_reduce_sum`` (the merge of per-rank parts into a value every rank
  holds: the vocab-sharded lookup, the catalog merge): the backward is the
  identity;
* ``grad_all_reduce`` (a replicated tensor that feeds only this rank's
  part: the hidden rows scored against this rank's vocab slice, the
  intensity weights of this rank's heads): the forward is the identity,
  the backward sums the parts;
* ``split_along`` (this rank's block of a replicated tensor, whole heads):
  the backward all-gathers the blocks' gradients;
* ``gather_along`` (every rank's block, concatenated): the backward is this
  rank's block of the gradient.

``total``, ``all_reduce_max`` and ``all_gather_cat`` carry no gradient;
``data_total`` is ``total`` over the active mesh's data axis (a count of
the global batch: a loss's denominator), and ``x`` itself without one.
``reduce_gradients`` turns a rank's gradients into the ones its optimizer
takes. Every collective runs, also on a group of one rank, so that a
(1, 1) mesh goes through the process group as a larger one does.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from easydgl_tpu_torch.core.mesh import (data_group, data_size, model_size,
                                         spmd_mesh)


def _rank(group) -> int:
    return dist.get_rank(group)


def _size(group) -> int:
    return dist.get_world_size(group)


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    y = x.detach().clone().contiguous()
    dist.all_reduce(y, op=op, group=group)
    return y


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _block(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = x.shape[dim] // _size(group)
    return x.narrow(dim, _rank(group) * n, n)


class _AllReduceSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GradAllReduce(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _SplitAlong(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _block(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _GatherAlong(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.dim, ctx.group).contiguous(), None, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group; backward the identity."""
    return _AllReduceSum.apply(x, group)


def grad_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """x itself; backward the sum of the group's gradients."""
    return _GradAllReduce.apply(x, group)


def split_along(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of ``dim`` (equal blocks in rank order); backward
    the all-gather of the blocks' gradients."""
    return _SplitAlong.apply(x, dim % x.dim(), group)


def gather_along(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order;
    backward this rank's block."""
    return _GatherAlong.apply(x, dim % x.dim(), group)


def total(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group, no gradient."""
    return _all_reduce(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max over the group, no gradient."""
    return _all_reduce(x, group, dist.ReduceOp.MAX)


def all_gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``, no gradient."""
    return _all_gather(x, dim, group)


def all_reduce_tensors(tensors, group):
    """Each tensor summed over the group, as views of one flat buffer (one
    collective for any number of tensors of one dtype)."""
    if not tensors:
        return []
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return out


def reduce_gradients(grads, params, mesh):
    """The gradients a sharded step's optimizer takes (name -> tensor, in
    the order of ``grads``): a row-sharded table's slice (its parameter
    carries ``vocab_rows``) summed over the data axis; every replicated
    leaf summed over the whole world (the mesh spans it,
    ``core/mesh.py::make_mesh``) and divided by mp. The model-axis ranks'
    copies of a replicated gradient are equal in exact arithmetic; summing
    them too makes every rank's copy bit-identical, so that a
    nondeterministic op on one rank (an atomic scatter) cannot make the
    replicated parameters drift apart. One collective for each kind."""
    names = list(grads)
    split = [n for n in names if hasattr(params[n], "vocab_rows")]
    rep = [n for n in names if not hasattr(params[n], "vocab_rows")]
    mp = model_size(mesh)
    out = dict(zip(split, all_reduce_tensors([grads[n] for n in split],
                                             data_group(mesh))))
    summed = all_reduce_tensors([grads[n] for n in rep], dist.group.WORLD)
    out.update((n, g / mp if mp > 1 else g) for n, g in zip(rep, summed))
    return {n: out[n] for n in names}


def data_total(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data axis of the mesh a step runs under
    (``core/mesh.py::use_spmd_mesh``), no gradient; ``x`` without one."""
    mesh = spmd_mesh()
    if mesh is None:
        return x
    return total(x, data_group(mesh))


def data_totals(xs):
    """Each scalar of the dict ``xs`` summed over the active mesh's data
    axis, in one collective; ``xs`` itself without a mesh."""
    if spmd_mesh() is None:
        return xs
    keys = list(xs)
    flat = data_total(torch.stack([xs[k].float() for k in keys]))
    return dict(zip(keys, flat.unbind()))


def data_share(x: torch.Tensor) -> torch.Tensor:
    """``x / dp`` under a mesh: a term that does not depend on the batch
    (a weight penalty), which the data-axis ranks' shares sum back to."""
    mesh = spmd_mesh()
    return x if mesh is None else x / data_size(mesh)
