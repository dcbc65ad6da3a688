"""TGAT: functional time encoding attention (ICLR'20). Port of
``easydgl_tpu.models.tgat``; parity with reference src/model/TGAT.py:

* the pairwise spans ``D[q, k] = (ts[q + 1] - ts[k])+`` of the scaled
  timestamps (TGAT.py:51-54; ``ts`` by ``models.base.scaled_times``) coded
  by the learnable Bochner features ``cos(w D + phi)``
  (``nn.coding.TimeFunctionCoding``) and added to the attention logits
  through ``nn.temporal.TfMultiHeadAttention``;
* item embedding (zero pad, sqrt(d) scale), the K position codes, dropout,
  the padding mask; N pre-LN blocks ``x = TfMHA(LN(x), x, causal)``,
  ``x = FFN(LN(x))``, the re-mask; final LN; tied scoring with a -1000 bias
  on id 0; the last position's row at eval, every position's in training
  (the regressive protocol).

``attention_impl``: ``"xla"`` (the preset's) materialises the (B, L, L, C)
codes; ``"factored"`` takes the per-position factors instead (no such
tensor); ``"flash"`` runs the factored form through the flash kernels
(q and k 4 dh wide, v dh wide; on the CPU their plain version). The
training forward returns no logits: the loss scores ``aux[SCORING]``
through the streamed catalog NLL.
"""
from __future__ import annotations

from typing import Optional

import torch

from easydgl_tpu_torch.config import Config
from easydgl_tpu_torch.kernels.flash_attention import \
    flash_attention_reference
from easydgl_tpu_torch.models.base import (SCORING, OutputBias,
                                           SequentialModel, prediction_rows,
                                           scaled_times, tied_logits)
from easydgl_tpu_torch.nn import attention
from easydgl_tpu_torch.nn.coding import (Embedding, PositionCoding,
                                         TimeFunctionCoding)
from easydgl_tpu_torch.nn.layers import (ContribLayerNorm, FeedForward,
                                         dropout)
from easydgl_tpu_torch.nn.temporal import TfMultiHeadAttention


class TGAT(SequentialModel):
    data_mode = "regressive"
    long_context_engine = (attention, "flash_attention",
                           flash_attention_reference)

    @classmethod
    def flax_layout(cls, cfg: Config, init) -> dict:
        c, v = cfg.num_units, cfg.num_items
        p = {}
        for i in range(cfg.num_blocks):
            p[f"block{i}_attn"] = {name: init.dense(c, c)
                                   for name in ("q", "k", "v")}
            p[f"block{i}_ffn"] = {"inner": init.dense(c, c),
                                  "readout": init.dense(c, c)}
            p[f"block{i}_ln0"] = init.ln(c)
            p[f"block{i}_ln1"] = init.ln(c)
        p["item_embs"] = {"lookup_table": init.glorot(v, c)}
        p["out_bias"] = {"output_bias": init.zeros(v - 1)}
        p["out_ln"] = init.ln(c)
        p["pcoding_k"] = {"pembs": {"lookup_table": init.glorot(cfg.seqslen,
                                                                c)}}
        p["tcoding_k"] = init.time_function(c)
        return p

    def __init__(self, cfg: Config, *, device=None):
        super().__init__(cfg)
        c = cfg.num_units
        cdt = cfg.matmul_dtype
        self.compute_dtype = cdt
        kw = dict(compute_dtype=cdt, device=device)
        self.item_embs = Embedding(cfg.num_items, c, zero_pad=True,
                                   scale=True, device=device)
        self.pcoding_k = PositionCoding(cfg.seqslen, c, device=device)
        self.tcoding_k = TimeFunctionCoding(c, device=device)
        for i in range(cfg.num_blocks):
            self.add_module(f"block{i}_ln0", ContribLayerNorm(c, **kw))
            self.add_module(f"block{i}_attn", TfMultiHeadAttention(
                c, cfg.num_heads, cfg.attention_probs_dropout_rate,
                impl=cfg.attention_impl, cp_impl=cfg.cp_impl, **kw))
            self.add_module(f"block{i}_ln1", ContribLayerNorm(c, **kw))
            self.add_module(f"block{i}_ffn", FeedForward(
                c, (c, c), cfg.hidden_dropout_rate, **kw))
        self.out_ln = ContribLayerNorm(c, **kw)
        self.out_bias = OutputBias(cfg.num_items, device=device)

    def forward(self, features, *, is_training: bool = False,
                generator: Optional[torch.Generator] = None):
        """features: seqs_i (B, L) ids, seqs_t (B, L+1) raw timestamps.
        Returns (logits (B, V) fp32, aux) at eval and (None, aux) when
        training; ``generator`` draws every dropout mask of a training
        forward and is required when a dropout rate is non-zero."""
        cfg = self.cfg
        if is_training and generator is None and (
                cfg.hidden_dropout_rate or cfg.attention_probs_dropout_rate):
            raise ValueError("TGAT: a training forward with dropout needs a "
                             "torch.Generator")
        gen = generator if is_training else None
        ids = features["seqs_i"].long()
        ts = scaled_times(features["seqs_t"], cfg.time_scale)
        x = self.item_embs(ids)
        k_pos = self.pcoding_k.code(x)
        if cfg.attention_impl in ("factored", "flash"):
            k_int = None
            factors = self.tcoding_k.factors(ts[:, 1:], ts[:, :-1])
        else:
            spans = (ts[:, 1:, None] - ts[:, None, :-1]).clamp_min(0.0)
            k_int = self.tcoding_k.code(spans)             # (B, L, L, C)
            factors = None
        x = dropout(x, cfg.hidden_dropout_rate, gen)
        mask = (ids != 0).to(x.dtype)[:, :, None]
        x = x * mask
        for i in range(cfg.num_blocks):
            blk = lambda name: getattr(self, f"block{i}_{name}")  # noqa: E731
            x = blk("attn")(blk("ln0")(x), x, k_pos, k_int, causality=True,
                            generator=gen, time_factors=factors)
            x = blk("ffn")(blk("ln1")(x), gen)
            x = x * mask
        x = self.out_ln(x)
        hidden = prediction_rows(x, is_training)
        bias = self.out_bias()
        table = self.item_embs.table()
        aux = {SCORING: (hidden, table, bias)}
        if is_training:
            return None, aux
        return tied_logits(hidden, table, bias, self.compute_dtype), aux
