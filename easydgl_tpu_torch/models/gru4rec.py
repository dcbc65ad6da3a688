"""GRU4REC: session-based RNN recommendation (ICLR'16). Port of
``easydgl_tpu.models.gru4rec``; parity with reference src/model/GRU4REC.py:
item embedding (zero pad, sqrt(d) scale) -> dropout -> ``num_blocks``-layer
cuDNN-variant GRU (``nn.rnn.CudnnGRU``) -> padding mask -> tied scoring
with a -1000 bias on id 0; the last position's row at eval, every
position's in training (the regressive protocol). The optimizer is the
preset's TF-Adam with beta2 0.98, eps 1e-9 and global-norm clip 5
(GRU4REC.py:60-71). The training forward returns no logits: the loss
scores ``aux[SCORING]`` through the streamed catalog NLL.
"""
from __future__ import annotations

from typing import Optional

import torch

from easydgl_tpu_torch.config import Config
from easydgl_tpu_torch.models.base import (SCORING, OutputBias,
                                           SequentialModel, prediction_rows,
                                           tied_logits)
from easydgl_tpu_torch.nn.coding import Embedding
from easydgl_tpu_torch.nn.layers import dropout
from easydgl_tpu_torch.nn.rnn import CudnnGRU


def gru_layout(init, num_layers: int, in_c: int, c: int) -> dict:
    """The JAX ``CudnnGRU``'s param tree: per-gate orthogonal kernels, zero
    biases."""
    p = {}
    for layer in range(num_layers):
        p[f"w_{layer}"] = init.per_gate_orthogonal(
            in_c if layer == 0 else c, c, 3)
        p[f"r_{layer}"] = init.per_gate_orthogonal(c, c, 3)
        p[f"bw_{layer}"] = init.zeros(3 * c)
        p[f"br_{layer}"] = init.zeros(3 * c)
    return p


class GRU4REC(SequentialModel):
    data_mode = "regressive"

    @classmethod
    def flax_layout(cls, cfg: Config, init) -> dict:
        c, v = cfg.num_units, cfg.num_items
        return {"gru": gru_layout(init, cfg.num_blocks, c, c),
                "item_embs": {"lookup_table": init.glorot(v, c)},
                "out_bias": {"output_bias": init.zeros(v - 1)}}

    def __init__(self, cfg: Config, *, device=None):
        super().__init__(cfg)
        c = cfg.num_units
        self.compute_dtype = cfg.matmul_dtype
        self.item_embs = Embedding(cfg.num_items, c, zero_pad=True,
                                   scale=True, device=device)
        self.gru = CudnnGRU(cfg.num_blocks, c, c,
                            compute_dtype=self.compute_dtype, device=device)
        self.out_bias = OutputBias(cfg.num_items, device=device)

    def forward(self, features, *, is_training: bool = False,
                generator: Optional[torch.Generator] = None):
        """features: seqs_i (B, L) ids. Returns (logits (B, V) fp32, aux) at
        eval and (None, aux) when training; ``generator`` draws the dropout
        mask of a training forward and is required when the rate is
        non-zero."""
        cfg = self.cfg
        if is_training and generator is None and cfg.hidden_dropout_rate:
            raise ValueError("GRU4REC: a training forward with dropout "
                             "needs a torch.Generator")
        gen = generator if is_training else None
        ids = features["seqs_i"].long()
        x = dropout(self.item_embs(ids), cfg.hidden_dropout_rate, gen)
        h, _ = self.gru(x)
        h = h * (ids != 0).to(h.dtype)[:, :, None]
        hidden = prediction_rows(h, is_training)
        bias = self.out_bias()
        table = self.item_embs.table()
        aux = {SCORING: (hidden, table, bias)}
        if is_training:
            return None, aux
        return tied_logits(hidden, table, bias, self.compute_dtype), aux
