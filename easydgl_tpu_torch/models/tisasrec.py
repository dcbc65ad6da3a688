"""TiSASRec: time-interval-aware self-attention (WSDM'20). Port of
``easydgl_tpu.models.tisasrec``; parity with reference src/model/TiSASREC.py:

* the interval matrix ``D[q, k] = ts[q + 1] - ts[k]`` of the scaled
  timestamps, clipped to [0, timelen] and truncated toward zero to int32
  (TiSASREC.py:56-59), in the JAX model's order of fp32 operations
  (``interval_buckets``); the edge bucket ``timelen`` is out of range of the
  ``timelen``-row interval tables and codes to a zero row
  (``nn.coding.TimeIntervalCoding``);
* the K and V position tables (``timelen`` rows) and the K and V interval
  tables are shared by every block (TiSASREC.py:29-32): their codes are
  computed once and fed to every block;
* item embedding (zero pad, sqrt(d) scale), dropout, the padding mask;
  N pre-LN blocks ``x = TiMHA(LN(x), x, causal)``, ``x = FFN(LN(x))``, the
  re-mask; final LN; tied scoring with a -1000 bias on id 0; the last
  position's row at eval, every position's in training (the regressive
  protocol).

``attention_impl="factored"`` selects the factored interval attention (the
buckets and the extended tables, no (B, L, L, C) codes; the long-context
form); anything else the dense form, the reference layout. The training
forward returns no logits: the loss scores ``aux[SCORING]`` through the
streamed catalog NLL.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from easydgl_tpu_torch.config import Config
from easydgl_tpu_torch.models.base import (SCORING, OutputBias,
                                           SequentialModel, prediction_rows,
                                           scaled_times, tied_logits)
from easydgl_tpu_torch.nn.coding import (Embedding, PositionCoding,
                                         TimeIntervalCoding)
from easydgl_tpu_torch.nn.layers import (ContribLayerNorm, FeedForward,
                                         dropout)
from easydgl_tpu_torch.nn.temporal import TiMultiHeadAttention


def interval_buckets(seqs_t: torch.Tensor, time_scale: float,
                     timelen: int) -> torch.Tensor:
    """(B, L+1) timestamps -> (B, L, L) int32 buckets
    ``trunc(clip(ts[q + 1] - ts[k], 0, timelen))`` of
    ``ts = seqs_t / time_scale``, in the JAX model's fp32 operations: the
    division first, then the difference. A span within an fp32 rounding of
    a whole number of units lands on the same side of it only in that
    order: subtracting first, or working in fp64, moves some spans across
    it. The divisor is a tensor on the stamps' device: a Python float is a
    CPU scalar, which CUDA's division turns into a product with its fp32
    reciprocal, and that moves such spans too (``models.base.scaled_times``).
    """
    ts = scaled_times(seqs_t, time_scale)
    spans = ts[:, 1:, None] - ts[:, None, :-1]
    return spans.clamp(0.0, float(timelen)).to(torch.int32)


def interval_buckets_numpy(seqs_t: np.ndarray, time_scale: float,
                           timelen: int) -> np.ndarray:
    """``interval_buckets`` in numpy's fp32 operations, each rounded as the
    JAX source's run op by op: the buckets the device's are held to."""
    ts = seqs_t.astype(np.float32) / np.float32(time_scale)
    spans = ts[:, 1:, None] - ts[:, None, :-1]
    return np.clip(spans, np.float32(0), np.float32(timelen)).astype(np.int32)


class TiSASREC(SequentialModel):
    data_mode = "regressive"

    @classmethod
    def flax_layout(cls, cfg: Config, init) -> dict:
        c, v, s = cfg.num_units, cfg.num_items, cfg.timelen
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
        for name in ("pcoding_k", "pcoding_v", "tcoding_k", "tcoding_v"):
            p[name] = {"pembs": {"lookup_table": init.glorot(s, c)}}
        return p

    def __init__(self, cfg: Config, *, device=None):
        super().__init__(cfg)
        c = cfg.num_units
        cdt = cfg.matmul_dtype
        self.compute_dtype = cdt
        kw = dict(compute_dtype=cdt, device=device)
        self.item_embs = Embedding(cfg.num_items, c, zero_pad=True,
                                   scale=True, device=device)
        self.pcoding_k = PositionCoding(cfg.timelen, c, device=device)
        self.pcoding_v = PositionCoding(cfg.timelen, c, device=device)
        self.tcoding_k = TimeIntervalCoding(cfg.timelen, c, device=device)
        self.tcoding_v = TimeIntervalCoding(cfg.timelen, c, device=device)
        for i in range(cfg.num_blocks):
            self.add_module(f"block{i}_ln0", ContribLayerNorm(c, **kw))
            self.add_module(f"block{i}_attn", TiMultiHeadAttention(
                c, cfg.num_heads, cfg.attention_probs_dropout_rate, **kw))
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
            raise ValueError("TiSASREC: a training forward with dropout "
                             "needs a torch.Generator")
        gen = generator if is_training else None
        ids = features["seqs_i"].long()
        x = self.item_embs(ids)
        spans = interval_buckets(features["seqs_t"], cfg.time_scale,
                                 cfg.timelen)                 # (B, L, L)
        k_pos, v_pos = self.pcoding_k.code(x), self.pcoding_v.code(x)
        if cfg.attention_impl == "factored":
            k_int = v_int = None
            factored = dict(interval_buckets=spans, interval_tables=(
                self.tcoding_k.table_extended(),
                self.tcoding_v.table_extended()))
        else:
            k_int, v_int = self.tcoding_k.code(spans), \
                self.tcoding_v.code(spans)
            factored = {}
        x = dropout(x, cfg.hidden_dropout_rate, gen)
        mask = (ids != 0).to(x.dtype)[:, :, None]
        x = x * mask
        for i in range(cfg.num_blocks):
            blk = lambda name: getattr(self, f"block{i}_{name}")  # noqa: E731
            x = blk("attn")(blk("ln0")(x), x, k_pos, v_pos, k_int, v_int,
                            causality=True, generator=gen, **factored)
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
