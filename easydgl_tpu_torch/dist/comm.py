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

The same holds over the seq axis (context parallelism): every seq rank of
a (data, model) coordinate runs the dense graph whole, so ``split_along``
hands the attention its sequence block and ``gather_along`` puts the
blocks back. Inside the attention two more pairs move the blocks between
seq ranks (``dist/context.py``):

* ``ring_shift`` (this rank's block to the next rank of the ring, the
  previous rank's block received; ``lax.ppermute``): the backward is the
  inverse shift;
* ``all_to_all`` (the tiled ``lax.all_to_all``: ``split_dim`` cut into
  one block a rank, the blocks received concatenated along
  ``concat_dim``): the backward is the inverse all-to-all.

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

from easydgl_tpu_torch.core.mesh import (data_group, data_size, replicas,
                                         seq_group, seq_size, spmd_mesh)


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


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Rank r's ``x`` sent to rank (r + step) % n of ``group``; returns the
    one rank (r - step) % n sent."""
    n, r = _size(group), _rank(group)
    x = x.detach().contiguous()
    out = torch.empty_like(x)
    peer = lambda i: dist.get_global_rank(group, i % n)  # noqa: E731
    ops = [dist.P2POp(dist.isend, x, peer(r + step), group),
           dist.P2POp(dist.irecv, out, peer(r - step), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int,
                group) -> torch.Tensor:
    """Block j of ``split_dim`` sent to rank j; the blocks received,
    in rank order, concatenated along ``concat_dim``."""
    n = _size(group)
    send = torch.stack(x.detach().chunk(n, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _RingShift(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


class _AllToAll(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _all_to_all(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (_all_to_all(g, concat_dim, split_dim, ctx.group), None,
                None, None)


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """The ``x`` of the previous rank of the ring, ``x`` itself going to
    the next one; backward the inverse shift."""
    return _RingShift.apply(x, group)


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int,
               group) -> torch.Tensor:
    """The tiled all-to-all; backward the inverse all-to-all."""
    return _AllToAll.apply(x, split_dim % x.dim(), concat_dim % x.dim(),
                           group)


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
    carries ``vocab_rows``) summed over the data axis (and averaged over
    the seq axis, whose ranks hold the same slice); every replicated
    leaf summed over the whole world (the mesh spans it,
    ``core/mesh.py::make_mesh``) and divided by mp cp, the ranks of a data
    group that hold it. Those ranks' copies of a replicated gradient are
    equal in exact arithmetic (each is the whole gradient of the group's
    rows: the collectives' backwards above make it so, the seq split's
    all-gather and the seq gather's block counting each dense part once);
    summing them too makes every rank's copy bit-identical, so that a
    nondeterministic op on one rank (an atomic scatter) cannot make the
    replicated parameters drift apart. One collective for each kind."""
    names = list(grads)
    split = [n for n in names if hasattr(params[n], "vocab_rows")]
    rep = [n for n in names if not hasattr(params[n], "vocab_rows")]
    k = replicas(mesh)
    sums = all_reduce_tensors([grads[n] for n in split], data_group(mesh))
    cp = seq_size(mesh)
    if cp > 1:
        # the seq ranks hold the same slice: one sum, the same bits on each
        sums = [g / cp for g in all_reduce_tensors(sums, seq_group(mesh))]
    out = dict(zip(split, sums))
    summed = all_reduce_tensors([grads[n] for n in rep], dist.group.WORLD)
    out.update((n, g / k if k > 1 else g) for n, g in zip(rep, summed))
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
