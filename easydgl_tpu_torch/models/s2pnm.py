"""S2PNM: dynamic preference via dictionary learning (TKDE'21). Port of
``easydgl_tpu.models.s2pnm``; parity with reference src/model/S2PNM.py:46-66:

* scaled item embeddings (zero pad) -> dropout -> a 1-layer cuDNN-variant
  GRU (``nn.rnn.CudnnGRU``) -> the position codes CONCATENATED (2C wide)
  and the padding mask;
* causal ``MultiHeadAttention(LN(x), x)`` over the 2C-wide keys, its
  residual the LN output's first C channels, then ``FeedForward(LN(x))``;
* the dictionary combine ``LN([g, h, g - h, g * h])`` (g the FFN output,
  h the GRU output), a sigmoid Dense to 2C, a Dense to C;
* a residual with the RAW item embeddings, taken before the dropout;
* tied scoring with a -1000 bias on id 0; the last position's row at eval,
  every position's in training (the regressive protocol).

The optimizer is the preset's TF-Adam with beta2 0.98, eps 1e-9 and
global-norm clip 5 (S2PNM.py:80-90). ``attention_impl`` picks the MHA
core (``nn.attention``), ``"xla"`` in the preset. The training forward
returns no logits: the loss scores ``aux[SCORING]`` through the streamed
catalog NLL.
"""
from __future__ import annotations

from typing import Optional

import torch

from easydgl_tpu_torch.config import Config
from easydgl_tpu_torch.models.base import (SCORING, OutputBias,
                                           SequentialModel, prediction_rows,
                                           tied_logits)
from easydgl_tpu_torch.models.gru4rec import gru_layout
from easydgl_tpu_torch.nn.attention import MultiHeadAttention
from easydgl_tpu_torch.nn.coding import Embedding, PositionCoding
from easydgl_tpu_torch.nn.layers import (ContribLayerNorm, Dense,
                                         FeedForward, dropout)
from easydgl_tpu_torch.nn.rnn import CudnnGRU


class S2PNM(SequentialModel):
    data_mode = "regressive"

    @classmethod
    def flax_layout(cls, cfg: Config, init) -> dict:
        c, v = cfg.num_units, cfg.num_items
        return {
            "attn": {name: init.dense(2 * c, c) for name in ("q", "k", "v")},
            "attn_ln": init.ln(2 * c),
            "dict0": init.dense(4 * c, 2 * c),
            "dict1": init.dense(2 * c, c),
            "dict_ln": init.ln(4 * c),
            "ffn": {"inner": init.dense(c, c), "readout": init.dense(c, c)},
            "ffn_ln": init.ln(c),
            "gru": gru_layout(init, 1, c, c),
            "item_embs": {"lookup_table": init.glorot(v, c)},
            "out_bias": {"output_bias": init.zeros(v - 1)},
            "pcoding": {"pembs": {"lookup_table": init.glorot(cfg.seqslen,
                                                              c)}}}

    def __init__(self, cfg: Config, *, device=None):
        super().__init__(cfg)
        c = cfg.num_units
        cdt = cfg.matmul_dtype
        self.compute_dtype = cdt
        kw = dict(compute_dtype=cdt, device=device)
        self.item_embs = Embedding(cfg.num_items, c, zero_pad=True,
                                   scale=True, device=device)
        self.gru = CudnnGRU(1, c, c, **kw)
        self.pcoding = PositionCoding(cfg.seqslen, c, device=device)
        self.attn_ln = ContribLayerNorm(2 * c, **kw)
        self.attn = MultiHeadAttention(
            2 * c, 2 * c, c, cfg.num_heads, cfg.attention_probs_dropout_rate,
            impl=cfg.attention_impl, cp_impl=cfg.cp_impl, **kw)
        self.ffn_ln = ContribLayerNorm(c, **kw)
        self.ffn = FeedForward(c, (c, c), cfg.hidden_dropout_rate, **kw)
        self.dict_ln = ContribLayerNorm(4 * c, **kw)
        self.dict0 = Dense(4 * c, 2 * c, **kw)
        self.dict1 = Dense(2 * c, c, **kw)
        self.out_bias = OutputBias(cfg.num_items, device=device)

    def forward(self, features, *, is_training: bool = False,
                generator: Optional[torch.Generator] = None):
        """features: seqs_i (B, L) ids. Returns (logits (B, V) fp32, aux) at
        eval and (None, aux) when training; ``generator`` draws every
        dropout mask of a training forward and is required when a dropout
        rate is non-zero."""
        cfg = self.cfg
        if is_training and generator is None and (
                cfg.hidden_dropout_rate or cfg.attention_probs_dropout_rate):
            raise ValueError("S2PNM: a training forward with dropout needs "
                             "a torch.Generator")
        gen = generator if is_training else None
        ids = features["seqs_i"].long()
        inputs = self.item_embs(ids)
        x = dropout(inputs, cfg.hidden_dropout_rate, gen)
        mask = (ids != 0).to(x.dtype)[:, :, None]
        h, _ = self.gru(x)
        x = self.pcoding(h) * mask                             # (B, L, 2C)
        x = self.attn(self.attn_ln(x), x, causality=True, generator=gen)
        g = self.ffn(self.ffn_ln(x), gen)
        d = self.dict_ln(torch.cat([g, h, g - h, g * h], dim=-1))
        d = self.dict1(torch.sigmoid(self.dict0(d)))
        out = d + inputs
        hidden = prediction_rows(out, is_training)
        bias = self.out_bias()
        table = self.item_embs.table()
        aux = {SCORING: (hidden, table, bias)}
        if is_training:
            return None, aux
        return tied_logits(hidden, table, bias, self.compute_dtype), aux
