"""Serving: batched top-k recommendation (port of
``easydgl_tpu.eval.recommender``).

Maps a batch of raw user histories to top-k item ids and scores with the
eval-time semantics the metrics use: the model's eval masking protocol,
mask_seen, the -1000 bias on id 0. Ties rank by ascending id, as
``lax.top_k`` ranks them. ``Recommender.from_checkpoint`` serves the
weights a training run saved (train/checkpoint.py).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from easydgl_tpu_torch.config import Config
from easydgl_tpu_torch.data.masking import make_protocol
from easydgl_tpu_torch.eval.metrics import mask_seen_logits
from easydgl_tpu_torch.models.registry import build_model
from easydgl_tpu_torch.train.steps import TrainState, init_state, to_device


class Recommender:
    """``Recommender(cfg, model_or_params, mark_table, device=...)``.

    ``model_or_params`` is the port's model (used where it lies) or a
    flax-layout param tree, loaded into a model built on ``device``
    (default ``cuda``; raises if there is none)."""

    def __init__(self, cfg: Config, model_or_params,
                 mark_table: Optional[np.ndarray] = None, *, device=None):
        self.cfg = cfg
        if isinstance(model_or_params, nn.Module):
            self.model = model_or_params
        else:
            self.model = build_model(cfg, device=device,
                                     params=model_or_params)
        self.device = next(self.model.parameters()).device
        self.mark_table = mark_table
        self.protocol = make_protocol(self.model.data_mode,
                                      masklen=cfg.masklen,
                                      mask_id=cfg.num_items)

    @torch.no_grad()
    def recommend(self, arrays: Dict[str, np.ndarray], k: int = 50
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """arrays: packed-layout batch (seqs_i (B, L+1), seqs_t, ...).
        Returns (item_ids (B, k), scores (B, k)), scores descending."""
        features, _ = self.protocol(arrays, False, None)
        if self.model.uses_tpp and self.mark_table is not None:
            ids = features["seqs_i"]
            safe = np.where(ids >= self.mark_table.shape[0], 0, ids)
            features["seqs_marks"] = self.mark_table[safe].astype(np.float32)
        feats = to_device(features, self.device)
        logits, _ = self.model(feats, is_training=False)
        if self.cfg.mask_seen:
            logits = mask_seen_logits(logits, feats["seqs_i"])
        # a stable sort keeps equal scores in ascending-id order
        scores, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
        return idx[:, :k].cpu().numpy(), scores[:, :k].cpu().numpy()

    @classmethod
    def from_checkpoint(cls, cfg: Config, ckpt_dir: str,
                        sample_arrays: Dict[str, np.ndarray],
                        mark_table: Optional[np.ndarray] = None, *,
                        device=None) -> "Recommender":
        """The latest checkpoint of ``ckpt_dir``, restored into a model
        built on ``device`` (default ``cuda``). The template matches the
        TRAINING state layout (checkpoints store params + opt state).
        ``sample_arrays`` (a packed-layout batch) keeps the JAX signature:
        the port's model knows its shapes from ``cfg``, so no sample batch
        is traced."""
        from easydgl_tpu_torch.train.checkpoint import Checkpointer
        del sample_arrays
        model = build_model(cfg, device=device)
        Checkpointer(ckpt_dir).restore(init_state_for_restore(model))
        return cls(cfg, model, mark_table)


def init_state_for_restore(model: nn.Module) -> TrainState:
    """A restore template of the TRAINING state layout: the model's own
    parameters, which the restore overwrites in place, and a fresh state of
    its optimizer."""
    return init_state(model)
