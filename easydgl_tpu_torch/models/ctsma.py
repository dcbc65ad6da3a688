"""CTSMA: continuous-time self-modulating attention (ICML'21). Port of
``easydgl_tpu.models.ctsma``; parity with reference src/model/CTSMA.py:

* scaled item embeddings (vocab num_items, zero pad) with the position
  codes CONCATENATED, so the first block consumes 2C-wide inputs;
* marks come as ``features['seqs_marks']`` (B, L, E) 0/1 floats (the loader
  or ``train.steps.device_marks``);
* spans = the differences of the scaled timestamps, unclipped: with left
  padding (timestamp 0) the last padding row's span is the first real
  item's whole scaled timestamp (CTSMA.py:50);
* N pre-LN blocks: ``x, intensities = MAU(LN(x), x, key_mask)``, causal —
  Q from the LN output, K, V and T from x, the residual the LN output's
  first C channels — then ``x = FFN(LN(x))``; each block's intensities
  are collected (the reference's "LLE_PP", CTSMA.py:76-77);
* final LN; every position's row in training (the ``regressive_entire``
  protocol), the last position's at eval; tied scoring with a -1000 bias
  on id 0;
* the TPP regularizer: ``ct_reg`` times the sum over the blocks of the
  biased likelihood, marks and RAW spans broadcast over the heads
  (CTSMA.py:97-110).

``attention_impl`` picks the MAU engine (``models.base.mau_impl``): the
fused chain for the short-context preset, the streamed schedule for
CTSMA-LC (L = 2048), whose kernels run on the card. Training: hidden
dropout after the input codes and in the FFN, attention dropout inside
MAU, all drawn from the step's ``torch.Generator``. The training forward
returns no logits: the loss scores ``aux[SCORING]`` through the streamed
catalog NLL.
"""
from __future__ import annotations

from typing import Optional

import torch

from easydgl_tpu_torch.config import Config
from easydgl_tpu_torch.kernels.mau_blocked import mau_blocked
from easydgl_tpu_torch.models.base import (INTENSITIES, SCORING, OutputBias,
                                           SequentialModel, mau_impl,
                                           prediction_rows, scaled_times,
                                           tied_logits)
from easydgl_tpu_torch.nn import temporal
from easydgl_tpu_torch.nn.coding import Embedding, PositionCoding
from easydgl_tpu_torch.nn.layers import (ContribLayerNorm, FeedForward,
                                         dropout)
from easydgl_tpu_torch.nn.temporal import MAU


class CTSMA(SequentialModel):
    data_mode = "regressive_entire"
    uses_tpp = True
    long_context_engine = (temporal, "mau_streamed", mau_blocked)

    @classmethod
    def flax_layout(cls, cfg: Config, init) -> dict:
        """The JAX model's param tree: block 0's LN and its MAU's q, k, v
        and t take the 2C-wide concatenated inputs; the position table has
        L rows."""
        c, e, v = cfg.num_units, cfg.num_events, cfg.num_items
        dh = c // cfg.num_heads
        p = {}
        for i in range(cfg.num_blocks):
            c_in = 2 * c if i == 0 else c
            mau = {name: init.dense(c_in, c) for name in ("q", "k", "v", "t")}
            mau.update(intensity_dense_kernel=init.glorot(dh + 1, e * dh),
                       intensity_dense_bias=init.zeros(e * dh),
                       intensity_weight=init.glorot(e, dh),
                       intensity_scaling=init.zeros(e))
            p[f"block{i}_mau"] = mau
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
            self.add_module(f"block{i}_mau", MAU(
                c_in, c, cfg.num_heads, cfg.num_events,
                cfg.attention_probs_dropout_rate,
                intensity_impl=mau_impl(cfg), block_k=cfg.mau_block_k,
                compute_dtype=cdt, device=device))
            self.add_module(f"block{i}_ln1", ContribLayerNorm(
                c, compute_dtype=cdt, device=device))
            self.add_module(f"block{i}_ffn", FeedForward(
                c, (c, c), cfg.hidden_dropout_rate, compute_dtype=cdt,
                device=device))
        self.out_ln = ContribLayerNorm(c, compute_dtype=cdt, device=device)
        self.out_bias = OutputBias(cfg.num_items, device=device)

    def forward(self, features, *, is_training: bool = False,
                generator: Optional[torch.Generator] = None):
        """features: seqs_i (B, L) ids, seqs_t (B, L+1) raw timestamps,
        seqs_marks (B, L, E). Returns (logits (B, V) fp32, aux) at eval and
        (None, aux) when training; ``generator`` draws every dropout mask of
        a training forward and is required when a dropout rate is
        non-zero."""
        cfg = self.cfg
        if is_training and generator is None and (
                cfg.hidden_dropout_rate or cfg.attention_probs_dropout_rate):
            raise ValueError("CTSMA: a training forward with dropout needs "
                             "a torch.Generator")
        gen = generator if is_training else None
        ids = features["seqs_i"].long()
        ts = scaled_times(features["seqs_t"], cfg.time_scale)  # (B, L+1)
        spans = ts[:, 1:] - ts[:, :-1]                          # (B, L)
        marks = features["seqs_marks"]                          # (B, L, E)
        x = self.pcoding(self.item_embs(ids))                   # (B, L, 2C)
        x = dropout(x, cfg.hidden_dropout_rate, gen)
        key_mask = (ids != 0).float()
        intensities = []
        for i in range(cfg.num_blocks):
            blk = lambda name: getattr(self, f"block{i}_{name}")  # noqa: E731
            x, intny = blk("mau")(blk("ln0")(x), x, key_mask, spans, marks,
                                  generator=gen)
            x = blk("ffn")(blk("ln1")(x), gen)
            intensities.append(intny)
        x = self.out_ln(x)
        hidden = prediction_rows(x, is_training)
        bias = self.out_bias()
        table = self.item_embs.table()
        aux = {INTENSITIES: tuple(intensities), SCORING: (hidden, table, bias)}
        if is_training:
            return None, aux
        return tied_logits(hidden, table, bias, self.compute_dtype), aux

    def tpp_regularizer(self, aux, features, labels, next_marks):
        """ct_reg times the sum over the blocks of the biased TPP
        likelihood (reference CTSMA.py:97-110): spans from the RAW
        timestamps, spans and marks broadcast over the heads; no division
        by the head count (EasyDGL's has one)."""
        cfg = self.cfg
        ts = features["seqs_t"].float()
        spans = ts[:, 1:] - ts[:, :-1]                          # (B, L)
        b, length = spans.shape
        h = cfg.num_heads
        spans = spans[:, None].expand(b, h, length)
        onehot = next_marks.float()[:, None]                    # (B, 1, L, E)
        onehot = onehot.expand(b, h, length, onehot.shape[-1])
        reg = 0.0
        for intny in aux[INTENSITIES]:
            reg = reg + cfg.ct_reg * MAU.biased_likelihood(intny, onehot,
                                                           spans)
        return reg
