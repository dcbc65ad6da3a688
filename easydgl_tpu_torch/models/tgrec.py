"""TGREC: temporal graph collaborative transformer (CIKM'21). Port of
``easydgl_tpu.models.tgrec``; parity with reference src/model/TGREC.py:

* unscaled item embeddings plus the position codes; the query time code is
  ``coding(0)``, the key codes those of the pairwise spans
  ``(ts[q + 1] - ts[k])+`` of the scaled timestamps (the TGAT convention:
  the reference's own interval shapes cannot broadcast, see the JAX
  model's docstring; ``ts`` by ``models.base.scaled_times``);
* N blocks: ``a = TgMHA(x, x)`` (``nn.temporal.TgMultiHeadAttention``, 2C
  wide), dropout, then the merge layer ``x = Dense(relu(Dense([a, x])))``
  (TGREC.py:66-68); the key mask is ``ids != 0``, not the keys' sign;
* tied scoring with a -1000 bias on id 0, no final LN; the last position's
  row at eval, every position's in training (the regressive protocol).

``attention_impl``: ``"xla"`` (the preset's) materialises the (B, L, L, 2C)
time-concatenated keys and values; ``"factored"`` splits them by
linearity and the per-position factors; ``"flash"`` runs the factored
form through the flash kernels (fp32, dh + 2C wide; on the CPU their plain
version). The training forward returns no logits: the loss scores
``aux[SCORING]`` through the streamed catalog NLL.
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
from easydgl_tpu_torch.nn.layers import Dense, dropout
from easydgl_tpu_torch.nn.temporal import TgMultiHeadAttention


class TGREC(SequentialModel):
    data_mode = "regressive"
    long_context_engine = (attention, "flash_attention",
                           flash_attention_reference)

    @classmethod
    def flax_layout(cls, cfg: Config, init) -> dict:
        c, v = cfg.num_units, cfg.num_items
        p = {}
        for i in range(cfg.num_blocks):
            p[f"block{i}_attn"] = {
                **{name: init.dense(2 * c, c) for name in ("q", "k", "v")},
                "merge": init.dense(c, 2 * c), "ln": init.ln(2 * c)}
            p[f"block{i}_inter"] = init.dense(3 * c, c)
            p[f"block{i}_out"] = init.dense(c, c)
        p["item_embs"] = {"lookup_table": init.glorot(v, c)}
        p["out_bias"] = {"output_bias": init.zeros(v - 1)}
        p["pcoding"] = {"pembs": {"lookup_table": init.glorot(cfg.seqslen,
                                                              c)}}
        p["tcoding"] = init.time_function(c)
        return p

    def __init__(self, cfg: Config, *, device=None):
        super().__init__(cfg)
        c = cfg.num_units
        cdt = cfg.matmul_dtype
        self.compute_dtype = cdt
        kw = dict(compute_dtype=cdt, device=device)
        self.item_embs = Embedding(cfg.num_items, c, zero_pad=True,
                                   scale=False, device=device)
        self.pcoding = PositionCoding(cfg.seqslen, c, device=device)
        self.tcoding = TimeFunctionCoding(c, device=device)
        for i in range(cfg.num_blocks):
            self.add_module(f"block{i}_attn", TgMultiHeadAttention(
                c, cfg.num_heads, cfg.attention_probs_dropout_rate,
                impl=cfg.attention_impl, **kw))
            self.add_module(f"block{i}_inter", Dense(3 * c, c, **kw))
            self.add_module(f"block{i}_out", Dense(c, c, **kw))
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
            raise ValueError("TGREC: a training forward with dropout needs a"
                             " torch.Generator")
        gen = generator if is_training else None
        ids = features["seqs_i"].long()
        ts = scaled_times(features["seqs_t"], cfg.time_scale)
        x = self.item_embs(ids)
        x = x + self.pcoding.code(x)
        b, t = ids.shape
        q_time = self.tcoding.code(ts.new_zeros((b, t, 1)))  # (B, L, 1, C)
        if cfg.attention_impl in ("factored", "flash"):
            k_time = None
            factors = self.tcoding.factors(ts[:, 1:], ts[:, :-1])
        else:
            spans = (ts[:, 1:, None] - ts[:, None, :-1]).clamp_min(0.0)
            k_time = self.tcoding.code(spans)              # (B, L, L, C)
            factors = None
        x = dropout(x, cfg.hidden_dropout_rate, gen)
        key_mask = (ids != 0).float()
        for i in range(cfg.num_blocks):
            blk = lambda name: getattr(self, f"block{i}_{name}")  # noqa: E731
            a = blk("attn")(x, x, key_mask, q_time, k_time, causality=True,
                            generator=gen, time_factors=factors)  # (B, L, 2C)
            a = dropout(a, cfg.hidden_dropout_rate, gen)
            m = torch.relu(blk("inter")(torch.cat([a, x], dim=-1)))
            x = blk("out")(m)
        hidden = prediction_rows(x, is_training)
        bias = self.out_bias()
        table = self.item_embs.table()
        aux = {SCORING: (hidden, table, bias)}
        if is_training:
            return None, aux
        return tied_logits(hidden, table, bias, self.compute_dtype), aux
