"""Full-catalog top-k and loss over vocab-sharded logits (port of
``easydgl_tpu.dist.topk``).

Each rank holds the (N, V/mp) columns of its slice of the catalog
(``dist/embedding.py::sharded_tied_logits``), rank m the global ids
[m V/mp, (m+1) V/mp):

* ``distributed_top_k``: a local top-k with GLOBAL ids, an all-gather of
  the (values, ids) candidates over model, a final top-k of the mp * k
  candidates. Exact, and it moves O(mp k) numbers a row instead of the
  catalog. Ties rank by ascending id, as ``lax.top_k`` and the port's
  ``eval/metrics.py::label_rank`` rank them: both selections are stable
  sorts, and the candidates arrive in rank order, so ascending id;
* ``distributed_label_nll``: logsumexp from the global max and the sum of
  the shifted exponentials over model, the label logit from the one rank
  whose slice holds it;
* ``distributed_mask_seen``: the -1e30 scatter-add of the seen ids that
  fall in this rank's slice, before the top-k merge.

Eval only: nothing here carries a gradient.
"""
from __future__ import annotations

from typing import Tuple

import torch

from easydgl_tpu_torch.core.mesh import model_group, model_index
from easydgl_tpu_torch.dist.comm import (all_gather_cat, all_reduce_max,
                                         total)
from easydgl_tpu_torch.eval.metrics import NEG_MASK


def stable_top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of each row, equal
    values by ascending index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


@torch.no_grad()
def distributed_top_k(logits: torch.Tensor, k: int, mesh
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits: this rank's (N, V/mp) columns. Returns (values, GLOBAL ids),
    each (N, min(k, V)), equal on every model-axis rank."""
    g = model_group(mesh)
    shard_v = logits.shape[-1]
    k_local = min(k, shard_v)
    vals, idx = stable_top_k(logits, k_local)
    gidx = idx + model_index(mesh) * shard_v
    cat_vals = all_gather_cat(vals, 1, g)
    cat_idx = all_gather_cat(gidx, 1, g)
    fv, fi = stable_top_k(cat_vals, min(k, cat_vals.shape[-1]))
    return fv, torch.take_along_dim(cat_idx, fi, dim=1)


@torch.no_grad()
def distributed_label_nll(logits: torch.Tensor, labels: torch.Tensor,
                          mesh) -> torch.Tensor:
    """Per row lse - label logit over the sharded catalog; labels are
    GLOBAL ids."""
    g = model_group(mesh)
    shard_v = logits.shape[-1]
    gmax = all_reduce_max(logits.max(dim=-1).values, g)
    lse = gmax + torch.log(total(
        torch.exp(logits - gmax[:, None]).sum(-1), g))
    local = labels.long() - model_index(mesh) * shard_v
    inside = (local >= 0) & (local < shard_v)
    picked = torch.take_along_dim(logits, local.clamp(0, shard_v - 1)[:, None],
                                  dim=1)[:, 0]
    return lse - total(torch.where(inside, picked, 0.0), g)


@torch.no_grad()
def distributed_mask_seen(logits: torch.Tensor, seen_ids: torch.Tensor,
                          mesh, neg: float = NEG_MASK) -> torch.Tensor:
    """-1e30 added at each seen GLOBAL id in this rank's slice (a
    duplicate adds again, as ``eval/metrics.py::mask_seen_logits``)."""
    shard_v = logits.shape[-1]
    local = seen_ids.long() - model_index(mesh) * shard_v
    inside = (local >= 0) & (local < shard_v)
    return logits.scatter_add(
        1, torch.where(inside, local, 0),
        torch.where(inside, neg, 0.0).to(logits.dtype))
