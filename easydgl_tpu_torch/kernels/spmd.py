"""The kernels under a (data, model) mesh (port of
``easydgl_tpu.kernels.spmd``).

Each rank is a process holding its data shard's rows, so the data axis
needs nothing here: a kernel runs on the rows it is given. The model axis
splits work in two ways, each a wrapper built from a shard-local step that
runs the hand-written kernels on one shard, and a merge. The wrappers,
the tests and ``chip_smoke.py`` (which runs every shard's step on one card)
call the same steps and merges.

* ``catalog_nll_spmd`` (rows 3-6): rank m scores its vocab slice
  [m V/mp, (m+1) V/mp) with the catalog kernels (``catalog_nll_local``);
  labels outside the slice go to -1, which matches no column, so the slice
  adds no label logit. ``catalog_merge`` merges exactly over model: a
  max-shifted logsumexp (the max carries no gradient; the shift cancels in
  it) and the sum of the label logits. When mp does not divide V the table
  stays whole and no model collective runs.
* ``mau_attention_spmd`` (rows 1-2) and ``flash_attention_spmd`` (rows
  7-9): whole heads over model where mp divides H. The MAU's (B, T, C)
  layout gives head h the channels [h dh, (h+1) dh), so rank m takes the
  contiguous channel block of its H/mp heads; flash's (B, H, T, D) the
  heads themselves. The kernel runs on H/mp heads; the outputs are
  gathered over model. The intensity weights feed only this rank's heads,
  so their gradients are summed over model (``grad_all_reduce``).

Dropout: the seed drawn for the call (equal on every rank of a data group)
is offset by (d + 1) * 104729 on data coordinate d and by (m + 1) *
15485863 on model coordinate m, as in JAX, so no two shards share a
stream; an axis of size 1 (or a model axis the heads do not split over)
adds nothing, so a (1, 1) mesh draws the single-device masks.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from easydgl_tpu_torch.core.mesh import (data_index, data_size, head_split,
                                         model_group, model_index,
                                         table_rows)
from easydgl_tpu_torch.dist.comm import (all_reduce_max, all_reduce_sum,
                                         gather_along, grad_all_reduce,
                                         split_along)
from easydgl_tpu_torch.kernels.flash_attention import flash_attention
from easydgl_tpu_torch.kernels.mau_attention import mau_attention
from easydgl_tpu_torch.kernels.scoring import catalog_nll

DATA_SEED_STRIDE = 104729
MODEL_SEED_STRIDE = 15485863


def shard_seed(seed, di: int = 0, dp: int = 1, mi: int = 0, mp: int = 1):
    """The dropout seed of shard (di, mi) of a (dp, mp) split."""
    if seed is None:
        return None
    if dp > 1:
        seed = seed + (di + 1) * DATA_SEED_STRIDE
    if mp > 1:
        seed = seed + (mi + 1) * MODEL_SEED_STRIDE
    return seed


def head_block(x: torch.Tensor, mi: int, mp: int, dim: int) -> torch.Tensor:
    """Block ``mi`` of ``mp`` equal blocks of ``dim``: shard mi's heads
    (plain slicing, for running a shard's step outside a mesh)."""
    n = x.shape[dim] // mp
    return x.narrow(dim, mi * n, n)


# ---------------------------------------------------------------- catalog


def shard_labels(labels: torch.Tensor, start: int, rows: int
                 ) -> torch.Tensor:
    """GLOBAL label ids -> ids in the slice [start, start + rows), -1
    outside it."""
    local = labels.long() - start
    return torch.where((local >= 0) & (local < rows), local, -1)


def catalog_nll_local(hidden, table, bias, labels, start: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One vocab slice's (lse, label logit), fp32: ``table`` / ``bias``
    are the slice's rows starting at GLOBAL id ``start``, ``labels`` global
    ids. The catalog kernels on the card, the plain version on the CPU."""
    return catalog_nll(hidden, table, bias,
                       shard_labels(labels, start, table.shape[0]))


def catalog_merge(lse, ll, reduce_max: Callable, reduce_sum: Callable):
    """The exact merge of the slices' (lse, label logit): ``reduce_max`` /
    ``reduce_sum`` reduce over the slices (collectives over model, or
    reductions over a stacked leading dim on one device)."""
    m = reduce_max(lse.detach())
    return (m + torch.log(reduce_sum(torch.exp(lse - m))),
            reduce_sum(ll))


def catalog_nll_spmd(hidden, table, bias, labels, mesh):
    """(lse, label logit) of this rank's rows over the whole catalog.
    ``table`` is this rank's slice of the rows, or the whole table (then
    sliced here, its gradient summed over model); ``bias`` the whole (V,)
    bias; labels GLOBAL ids. Where mp does not divide V, the whole table
    on every rank, no model collective."""
    rows = table_rows(mesh, bias.shape[0])
    if rows is None:
        return catalog_nll(hidden, table, bias, labels)
    g = model_group(mesh)
    start, stop = rows
    hidden = grad_all_reduce(hidden, g)
    if table.shape[0] != stop - start:
        table = grad_all_reduce(table, g)[start:stop]
    bias = grad_all_reduce(bias, g)[start:stop]
    lse, ll = catalog_nll_local(hidden, table, bias, labels, start)
    return catalog_merge(lse, ll, lambda x: all_reduce_max(x, g),
                         lambda x: all_reduce_sum(x, g))


# ---------------------------------------------------------------- MAU


def mau_attention_local(q, k, v, t, key_mask, intervals, onehot, wd, bd, w,
                        scaling, seed, causal: bool, diag_reset: bool,
                        dropout_rate: float, num_heads: int,
                        qpos: Optional[torch.Tensor] = None, *, di: int = 0,
                        dp: int = 1, mi: int = 0, mp: int = 1):
    """Shard (di, mi)'s step: q/k/v/t hold the channels of its
    ``num_heads // mp`` heads; the fused MAU kernels on those heads, the
    seed offset by the shard. Returns (out (B, Tq, C/mp), lam (B, H/mp,
    Tq, E))."""
    return mau_attention(q, k, v, t, key_mask, intervals, onehot, wd, bd, w,
                         scaling, causal, diag_reset, dropout_rate,
                         num_heads=num_heads // mp, qpos=qpos,
                         dropout_seed=shard_seed(seed, di, dp, mi, mp))


def mau_attention_spmd(q, k, v, t, key_mask, intervals, onehot, wd, bd, w,
                       scaling, seed, mesh, causal: bool, diag_reset: bool,
                       dropout_rate: float, num_heads: int, qpos=None):
    """The fused MAU of this rank's rows, heads split over model where mp
    divides ``num_heads``: (out (B, Tq, C), lam (B, H, Tq, E)), equal on
    every model-axis rank."""
    mp = head_split(mesh, num_heads)
    di, dp = data_index(mesh), data_size(mesh)
    mi = model_index(mesh) if mp > 1 else 0
    if mp > 1:
        g = model_group(mesh)
        q, k, v, t = (split_along(x, -1, g) for x in (q, k, v, t))
        wd, bd, w, scaling = (grad_all_reduce(p, g)
                              for p in (wd, bd, w, scaling))
    out, lam = mau_attention_local(
        q, k, v, t, key_mask, intervals, onehot, wd, bd, w, scaling, seed,
        causal, diag_reset, dropout_rate, num_heads, qpos, di=di, dp=dp,
        mi=mi, mp=mp)
    if mp > 1:
        out, lam = gather_along(out, -1, g), gather_along(lam, 1, g)
    return out, lam


# ---------------------------------------------------------------- flash


def flash_attention_local(q, k, v, key_mask, seed, *, causal: bool,
                          scale=None, dropout_rate: float = 0.0,
                          di: int = 0, dp: int = 1, mi: int = 0,
                          mp: int = 1):
    """Shard (di, mi)'s step: q/k/v (B, H/mp, T, D) its heads; the flash
    kernels, the seed offset by the shard."""
    return flash_attention(q, k, v, key_mask, causal=causal, scale=scale,
                           dropout_rate=dropout_rate,
                           seed=shard_seed(seed, di, dp, mi, mp))


def flash_attention_spmd(q, k, v, key_mask, mesh, *, causal: bool,
                         scale=None, dropout_rate: float = 0.0, seed=None):
    """Flash attention of this rank's rows, (B, H, T, D) heads split over
    model where mp divides H; (B, H, Tq, Dv), equal on every model-axis
    rank."""
    mp = head_split(mesh, q.shape[1])
    di, dp = data_index(mesh), data_size(mesh)
    mi = model_index(mesh) if mp > 1 else 0
    if mp > 1:
        g = model_group(mesh)
        q, k, v = (split_along(x, 1, g) for x in (q, k, v))
    out = flash_attention_local(q, k, v, key_mask, seed, causal=causal,
                                scale=scale, dropout_rate=dropout_rate,
                                di=di, dp=dp, mi=mi, mp=mp)
    return gather_along(out, 1, g) if mp > 1 else out
