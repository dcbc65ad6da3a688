"""TimelyREC: heterogeneous temporal patterns (WWW'21). Port of
``easydgl_tpu.models.timelyrec``; parity with reference
src/model/TimelyREC.py:

* the user tower (TimelyREC.py:79-101): item embeddings with the position
  codes CONCATENATED (2C wide), dropout, the padding mask; one causal
  ``MultiHeadAttention`` over its ``ContribLayerNorm`` (moments over
  (T, 2C)) with the residual ``x[..., :C]``, the ``FeedForward`` over its
  LN, the re-mask and ``user_out_ln``;
* four ``MATEncoder``s (``nn.mate``) over month, day, weekday and hour
  (tables of 12, 31, 7 and 24 rows, glorot, no pad) with ``_timeslot``'s
  window smoothing (TimelyREC.py:57-77);
* the sigmoid combine over the four granularities (``period_q``, no bias,
  :126-136); ``TAHEncoder`` over the combined period codes with the items
  plus ``te_weight`` (a 0-d parameter) times their sinusoid time codes
  (:138-148); the dictionary combine ``dict0`` (sigmoid), ``dict1``
  (:149-155); tied scoring with a -1000 bias on id 0.

``attention_impl``: ``"xla"`` (the preset's) or ``"flash"``, the user
tower's attention core (``nn.attention``; at the preset's H = 4 the flash
kernels run at dh = 128). The stamps are divided by a device tensor
(``models.base.scaled_times``). In training JAX adds the per-row sinusoid
bias ``(out . tcodes) te_weight`` to its materialised logits only: a
per-row shift leaves the softmax NLL unchanged, so the catalog kernels
skip it (TimelyREC.py:158-172), and so does the port, which returns no
logits in training: the loss scores ``aux[SCORING]`` through the streamed
catalog NLL.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from easydgl_tpu_torch.config import Config
from easydgl_tpu_torch.kernels.flash_attention import \
    flash_attention_reference
from easydgl_tpu_torch.models.base import (SCORING, OutputBias,
                                           SequentialModel, prediction_rows,
                                           scaled_times, tied_logits)
from easydgl_tpu_torch.nn import attention
from easydgl_tpu_torch.nn.attention import MultiHeadAttention
from easydgl_tpu_torch.nn.coding import (Embedding, PositionCoding,
                                         TimeSinusoidCoding)
from easydgl_tpu_torch.nn.layers import (ContribLayerNorm, Dense,
                                         FeedForward, dropout,
                                         einsum_fp32acc)
from easydgl_tpu_torch.nn.mate import MATEncoder, TAHEncoder

# (feature, its period, the value subtracted first): month and day count
# from 1 (an ETL pad stamp's 0 becomes -1, which the lookup clamps to row 0)
GRANULARITIES = (("month", 12, 1), ("day", 31, 1), ("weekday", 7, 0),
                 ("hour", 24, 0))


def timeslot_window(maxrange: int, window_ratio: float) -> int:
    """The smoothing window: 3, 7, 2, 6 for month, day, weekday, hour at
    the preset's ratio 0.2."""
    return max(int(maxrange * window_ratio + 0.5), 1) + 1


class TimelyREC(SequentialModel):
    data_mode = "regressive_datetime"
    long_context_engine = (attention, "flash_attention",
                           flash_attention_reference)

    @classmethod
    def flax_layout(cls, cfg: Config, init) -> dict:
        c, v = cfg.num_units, cfg.num_items
        p = {"item_embs": {"lookup_table": init.glorot(v, c)},
             "pcoding": {"pembs": {"lookup_table": init.glorot(cfg.seqslen,
                                                               c)}},
             "user_attn": {name: init.dense(2 * c, c)
                           for name in ("q", "k", "v")},
             "user_attn_ln": init.ln(2 * c),
             "user_ffn": {"inner": init.dense(c, c),
                          "readout": init.dense(c, c)},
             "user_ffn_ln": init.ln(c), "user_out_ln": init.ln(c)}
        for name, period, _ in GRANULARITIES:
            p[f"{name}_embs"] = {"lookup_table": init.glorot(period, c)}
            p[f"{name}_mate"] = {"user_proj": {"kernel": init.glorot(c, c)}}
        p["period_q"] = {"kernel": init.glorot(c, c)}
        p["dict0"] = init.dense(3 * c, 2 * c)
        p["dict1"] = init.dense(2 * c, c)
        p["out_bias"] = {"output_bias": init.zeros(v - 1)}
        p["te_weight"] = init.ones()
        return p

    def __init__(self, cfg: Config, *, device=None):
        super().__init__(cfg)
        c = cfg.num_units
        cdt = cfg.matmul_dtype
        self.compute_dtype = cdt
        kw = dict(compute_dtype=cdt, device=device)
        self.item_embs = Embedding(cfg.num_items, c, zero_pad=True,
                                   scale=False, device=device)
        self.te_weight = nn.Parameter(torch.empty((), device=device))
        self.pcoding = PositionCoding(cfg.seqslen, c, device=device)
        self.user_attn_ln = ContribLayerNorm(2 * c, **kw)
        self.user_attn = MultiHeadAttention(
            2 * c, 2 * c, c, cfg.num_heads, cfg.attention_probs_dropout_rate,
            impl=cfg.attention_impl, cp_impl=cfg.cp_impl, **kw)
        self.user_ffn_ln = ContribLayerNorm(c, **kw)
        self.user_ffn = FeedForward(c, (c, c), cfg.hidden_dropout_rate, **kw)
        self.user_out_ln = ContribLayerNorm(c, **kw)
        for name, period, _ in GRANULARITIES:
            self.add_module(f"{name}_embs", Embedding(
                period, c, zero_pad=False, scale=False, device=device))
            self.add_module(f"{name}_mate", MATEncoder(c, **kw))
        self.period_q = Dense(c, c, use_bias=False, **kw)
        self.tcoding = TimeSinusoidCoding(c)
        self.tahe = TAHEncoder(compute_dtype=cdt)
        self.dict0 = Dense(3 * c, 2 * c, **kw)
        self.dict1 = Dense(2 * c, c, **kw)
        self.out_bias = OutputBias(cfg.num_items, device=device)

    def _timeslot(self, feature: torch.Tensor, maxrange: int,
                  embedding: Embedding):
        """(query (B, S, 1, C), keys (B, S, W + 1, C)) of one granularity
        (JAX ``TimelyREC._timeslot``): the W slots ``feature + d`` and
        ``feature - d``, d = 1..W, wrapped by the floored modulo, summed
        pairwise, then a running sum over the SEQUENCE axis (the
        reference's cumsum on axis 1, TimelyREC.py:70, kept verbatim),
        plus the feature's own code, over ``2 d + 1``."""
        w = timeslot_window(maxrange, self.cfg.window_ratio)
        b, s = feature.shape
        d = torch.arange(1, w + 1, device=feature.device)
        query = embedding(feature)[:, :, None, :]
        slots = torch.remainder(feature[:, :, None] + torch.cat([d, -d]),
                                maxrange)
        slots = embedding(slots.reshape(b, s, 2, w)).sum(dim=2)
        slots = torch.cumsum(slots, dim=1)
        outs = (query + slots) / (d.float() * 2.0 + 1.0)[None, None, :, None]
        return query, torch.cat([query, outs], dim=2)

    def forward(self, features, *, is_training: bool = False,
                generator: Optional[torch.Generator] = None):
        """features: seqs_i (B, L) ids, seqs_t (B, L+1) raw timestamps,
        seqs_month / seqs_day / seqs_weekday / seqs_hour (B, L). Returns
        (logits (B, V) fp32, aux) at eval and (None, aux) when training;
        ``generator`` draws every dropout mask of a training forward and
        is required when a dropout rate is non-zero."""
        cfg = self.cfg
        cdt = self.compute_dtype
        if is_training and generator is None and (
                cfg.hidden_dropout_rate or cfg.attention_probs_dropout_rate):
            raise ValueError("TimelyREC: a training forward with dropout "
                             "needs a torch.Generator")
        gen = generator if is_training else None
        ids = features["seqs_i"].long()

        x = dropout(self.pcoding(self.item_embs(ids)),
                    cfg.hidden_dropout_rate, gen)              # (B, L, 2C)
        mask = (ids != 0).to(x.dtype)[:, :, None]
        x = x * mask
        x = self.user_attn(self.user_attn_ln(x), x, causality=True,
                           generator=gen)
        x = self.user_ffn(self.user_ffn_ln(x), gen) * mask
        users = self.user_out_ln(x)                            # (B, L, C)

        periods = []
        for name, period, base in GRANULARITIES:
            query, keys = self._timeslot(
                features[f"seqs_{name}"].long() - base, period,
                getattr(self, f"{name}_embs"))
            periods.append(getattr(self, f"{name}_mate")(query, keys, users))
        pk = torch.stack(periods, dim=2)                       # (B, L, 4, C)
        pq = self.period_q(users)[:, :, None, :]
        pw = torch.sigmoid(einsum_fp32acc("bsoh,bsgh->bsog", pq, pk,
                                          cdt=cdt))
        period_outs = einsum_fp32acc("bsog,bsgh->bsh", pw, pk, cdt=cdt)

        tcodes = self.tcoding.code(scaled_times(features["seqs_t"][:, :-1],
                                                cfg.time_scale))
        history = (self.item_embs(ids) + self.te_weight * tcodes) * mask
        history = self.tahe(period_outs, period_outs, history)

        out = torch.cat([users.float(), history, period_outs], dim=-1)
        out = self.dict1(torch.sigmoid(self.dict0(out)))
        hidden = prediction_rows(out, is_training)
        bias = self.out_bias()
        table = self.item_embs.table()
        aux = {SCORING: (hidden, table, bias)}
        if is_training:
            return None, aux
        return tied_logits(hidden, table, bias, cdt), aux
