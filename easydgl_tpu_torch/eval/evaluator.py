"""Distributed full-catalog evaluation over a (data, model) mesh (port of
``easydgl_tpu.eval.evaluator``).

Each rank holds its data shard's rows and its model slice of the catalog:
the model's forward scores the hidden rows against the rank's slice of the
table (``models/base.py::tied_logits`` under the mesh), ``mask_seen`` is a
shard-local scatter, the top-100 an exact distributed merge (a local
top-k, an all-gather of the (values, GLOBAL ids) candidates, a final
top-k), and HR/NDCG come from the merged ids. No rank builds a (B, V) row.
The sums are then added over the data axis, so every rank returns the
global batch's sums (Base.py:150-207 semantics, the single-device step's
tie-break). The seq ranks of a (data, model) coordinate (cp > 1) run the
same forward on the same rows, the attention's sequence split over them
(``dist/context.py``), and return the same sums.
"""
from __future__ import annotations

from typing import Dict

import torch

from easydgl_tpu_torch.core.mesh import model_size, table_rows
from easydgl_tpu_torch.dist.topk import (distributed_mask_seen,
                                         distributed_top_k)
from easydgl_tpu_torch.eval.metrics import MAX_K, TOPK
from easydgl_tpu_torch.models.base import SequentialModel
from easydgl_tpu_torch.train.steps import build_eval_step


def metric_sums_from_topk(top_idx: torch.Tensor, true_items: torch.Tensor,
                          valid: torch.Tensor) -> Dict[str, torch.Tensor]:
    """HR/NDCG sums from top-k GLOBAL ids (B, >= max k); the gain
    1/log2(rank + 2) as ``eval/metrics.py::metric_sums`` forms it."""
    hit = (top_idx == true_items.long()[:, None]).float()
    v = valid.float()
    ranks = torch.arange(top_idx.shape[-1], device=top_idx.device)
    gain = 1.0 / torch.log2(ranks.float() + 2.0)
    out = {"count": v.sum()}
    for k in TOPK:
        kk = min(k, top_idx.shape[-1])
        out[f"H{k}"] = (torch.sign(hit[:, :kk].sum(-1)) * v).sum()
        out[f"N{k}"] = ((hit[:, :kk] * gain[:kk]).sum(-1) * v).sum()
    return out


def build_distributed_eval_step(model: SequentialModel, mesh,
                                mark_table=None):
    """Returns ``step(model, features, labels, valid) -> sums``:
    ``train/steps.py::build_eval_step`` under the mesh (the model is the
    sharded one, the rows this rank's) with the catalog scored
    shard-locally and the top-k merged over the model axis. mp must divide
    the vocab."""
    mask_seen = model.cfg.mask_seen
    vocab = model.vocab_size
    if table_rows(mesh, vocab) is None and model_size(mesh) > 1:
        raise ValueError(f"vocab {vocab} does not split over "
                         f"mp={model_size(mesh)}")
    start, stop = table_rows(mesh, vocab) or (0, vocab)

    def merged(logits, seqs_i, true_items, valid):
        if logits.shape[-1] != stop - start:
            logits = logits[:, start:stop]   # a head scored whole
        if mask_seen:
            logits = distributed_mask_seen(logits, seqs_i, mesh)
        _, idx = distributed_top_k(logits, min(MAX_K, vocab), mesh)
        return metric_sums_from_topk(idx, true_items, valid)

    return build_eval_step(model, mark_table, mesh, rank=merged)
