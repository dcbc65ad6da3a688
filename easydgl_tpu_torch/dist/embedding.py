"""The vocab-sharded item table (port of ``easydgl_tpu.dist.embedding``).

The item table's rows are split over the model axis (``train/sharded.py``):
rank m holds rows [m V/mp, (m+1) V/mp). Two things read it.

* ``sharded_lookup``, the input embedding. In JAX the partitioner served
  the lookup of a row-sharded table without code (a local clamped gather,
  the rows outside the slice zeroed, one all-reduce of the (B/dp, L+1, C)
  partials over model); here that pattern is written out. The table is
  never gathered. The all-reduce's backward is the identity, so each rank's
  slice gets the gradient of the ids that fall in it.
* ``sharded_tied_logits``, the scoring at eval: (N, C) @ (V/mp, C)^T + the
  bias's slice, the logits column-sharded over model. No collective until
  the top-k (``dist/topk.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from easydgl_tpu_torch.core.mesh import model_group, table_rows
from easydgl_tpu_torch.dist.comm import all_reduce_sum
from easydgl_tpu_torch.nn.layers import mm_fp32acc


def sharded_lookup(table: torch.Tensor, ids: torch.Tensor, start: int,
                   mesh) -> torch.Tensor:
    """Rows ``ids`` (any shape, GLOBAL ids already in [0, V)) of a table of
    which this rank holds rows [start, start + len(table)): (*ids.shape,
    C), equal on every model-axis rank."""
    n, c = table.shape
    local = ids.long() - start
    inside = (local >= 0) & (local < n)
    rows = torch.index_select(table, 0, torch.where(
        inside, local, 0).reshape(-1)).reshape(*ids.shape, c)
    rows = rows * inside[..., None].to(rows.dtype)
    return all_reduce_sum(rows, model_group(mesh))


def sharded_tied_logits(hidden: torch.Tensor, table: torch.Tensor,
                        bias: torch.Tensor, mesh,
                        compute_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """This rank's (N, V/mp) columns of hidden @ table^T + bias, fp32.
    ``table`` is this rank's slice of the rows or the whole table (an
    untied head), ``bias`` the whole (V,) bias."""
    start, stop = table_rows(mesh, bias.shape[0])
    if table.shape[0] != stop - start:
        table = table[start:stop]
    return mm_fp32acc(hidden, table.t(), compute_dtype) + bias[start:stop]
