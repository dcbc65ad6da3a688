"""SASRec: self-attentive sequential recommendation (ICDM'18). Port of
``easydgl_tpu.models.sasrec``; parity with reference src/model/SASREC.py:

* item embedding (zero pad, sqrt(d) scale) with the position codes
  CONCATENATED, so the first block consumes 2C-wide inputs (SASREC.py:43-44);
* N pre-LN blocks: ``x = MHA(LN(x), x, causal)``, then ``x = FFN(LN(x))``
  and the padding re-mask (SASREC.py:53-60); the LNs normalise over (T, C)
  jointly (Base.py:12-67);
* final LN; the last position's row at eval, every position's at training
  (the regressive protocol); tied scoring with a -1000 bias on id 0.

``attention_impl`` picks the MHA core (``nn.attention``): ``"xla"`` for
the short-context preset, ``"flash"`` for SASREC-LC (L = 2048), whose
kernels run on the card. Training: hidden dropout after the input codes and
in the FFN, attention dropout in the MHA, all drawn from the step's
``torch.Generator``. The training forward returns no logits, as EasyDGL's:
the loss scores ``aux[SCORING]`` through the streamed catalog NLL, so no
(B*T, V) product is built. ``cfg.remat`` recomputes each block in the
backward (``nn.remat`` in the JAX model; ``models.base.remat``).
``SASRECBlock`` (the pipeline stage body) comes with pipeline parallelism.
"""
from __future__ import annotations

from typing import Optional

import torch

from easydgl_tpu_torch.config import Config
from easydgl_tpu_torch.kernels.flash_attention import \
    flash_attention_reference
from easydgl_tpu_torch.models.base import (SCORING, OutputBias,
                                           SequentialModel, prediction_rows,
                                           remat, tied_logits)
from easydgl_tpu_torch.nn import attention
from easydgl_tpu_torch.nn.attention import MultiHeadAttention
from easydgl_tpu_torch.nn.coding import Embedding, PositionCoding
from easydgl_tpu_torch.nn.layers import (ContribLayerNorm, FeedForward,
                                         dropout)


class SASREC(SequentialModel):
    data_mode = "regressive"
    long_context_engine = (attention, "flash_attention",
                           flash_attention_reference)

    @classmethod
    def flax_layout(cls, cfg: Config, init) -> dict:
        """The JAX model's param tree: block 0's attention and its LN take
        the 2C-wide concatenated inputs; the position table has L rows."""
        c, v = cfg.num_units, cfg.num_items
        p = {}
        for i in range(cfg.num_blocks):
            c_in = 2 * c if i == 0 else c
            p[f"block{i}_attn"] = {name: init.dense(c_in, c)
                                   for name in ("q", "k", "v")}
            p[f"block{i}_ffn"] = {"inner": init.dense(c, c),
                                  "readout": init.dense(c, c)}
            p[f"block{i}_ln0"] = init.ln(c_in)
            p[f"block{i}_ln1"] = init.ln(c)
        p["item_embs"] = {"lookup_table": init.glorot(v, c)}
        p["out_bias"] = {"output_bias": init.zeros(v - 1)}
        p["out_ln"] = init.ln(c)
        p["pcoding"] = {"pembs": {"lookup_table": init.glorot(cfg.seqslen, c)}}
        return p

    def __init__(self, cfg: Config, *, device=None):
        super().__init__(cfg)
        c = cfg.num_units
        cdt = cfg.matmul_dtype
        self.compute_dtype = cdt
        self.item_embs = Embedding(cfg.num_items, c, zero_pad=True,
                                   scale=True, device=device)
        self.pcoding = PositionCoding(cfg.seqslen, c, device=device)
        for i in range(cfg.num_blocks):
            c_in = 2 * c if i == 0 else c
            self.add_module(f"block{i}_ln0", ContribLayerNorm(
                c_in, compute_dtype=cdt, device=device))
            self.add_module(f"block{i}_attn", MultiHeadAttention(
                c_in, c_in, c, cfg.num_heads,
                cfg.attention_probs_dropout_rate, impl=cfg.attention_impl,
                cp_impl=cfg.cp_impl, compute_dtype=cdt, device=device))
            self.add_module(f"block{i}_ln1", ContribLayerNorm(
                c, compute_dtype=cdt, device=device))
            self.add_module(f"block{i}_ffn", FeedForward(
                c, (c, c), cfg.hidden_dropout_rate, compute_dtype=cdt,
                device=device))
        self.out_ln = ContribLayerNorm(c, compute_dtype=cdt, device=device)
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
            raise ValueError("SASREC: a training forward with dropout needs "
                             "a torch.Generator")
        gen = generator if is_training else None
        ids = features["seqs_i"].long()
        x = self.pcoding(self.item_embs(ids))                  # (B, L, 2C)
        x = dropout(x, cfg.hidden_dropout_rate, gen)
        mask = (ids != 0).to(x.dtype)[:, :, None]
        x = x * mask
        for i in range(cfg.num_blocks):
            if cfg.remat and torch.is_grad_enabled():
                x = remat(self._block, i, x, mask, gen)
            else:
                x = self._block(i, x, mask, gen)
        x = self.out_ln(x)
        hidden = prediction_rows(x, is_training)
        bias = self.out_bias()
        table = self.item_embs.table()
        aux = {SCORING: (hidden, table, bias)}
        if is_training:
            return None, aux
        return tied_logits(hidden, table, bias, self.compute_dtype), aux

    def _block(self, i: int, x, mask, gen):
        """Block i: ``x = MHA(LN(x), x, causal)``, ``x = FFN(LN(x))``, the
        padding re-mask."""
        blk = lambda name: getattr(self, f"block{i}_{name}")  # noqa: E731
        x = blk("attn")(blk("ln0")(x), x, causality=True, generator=gen)
        x = blk("ffn")(blk("ln1")(x), gen)
        return x * mask

