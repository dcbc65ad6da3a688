"""EasyDGL: BERT-style masked model with TPP-modulated attention (BiMAU).
Port of ``easydgl_tpu.models.easydgl``; parity with reference
src/model/EasyDGL.py:

* seqslen+1 positions, vocab num_items+1 (MASK id = num_items);
* spans = clip(Δ scaled ts, 0, 100), first interval duplicated;
* marks come as ``features['seqs_marks']`` (B, L+1, E) 0/1 floats with the
  MASK id mapped to row 0 (the loader or ``train.steps.device_marks``);
* input = concat([item_emb*sqrt(d) + sinusoid-time, position codes, mark
  codes], -1), 3C wide. The reference looks ``mark_embs`` up with the 0/1
  indicator VALUES as indices, so the mark code is
  (#active marks) * mark_embs[1] — reproduced faithfully;
* BiMAU blocks, on the engine ``models.base.mau_impl`` picks (the fused
  chain, or the streamed long-context schedule under
  ``attention_impl="flash"``); the attention residual takes x[:, :, :C];
* GELU transform head, tied scoring with a -1000 bias on id 0;
* training: hidden dropout after the input codes and after each sublayer's
  output projection, attention dropout inside BiMAU, all drawn from the
  step's ``torch.Generator``; ``tpp_regularizer`` adds the biased TPP
  likelihood over the masked positions (EasyDGL.py:158-175).

``gather_queries`` (opt-in, not reference-exact: the blocks' LayerNorm
moments then see only the gathered rows) runs the final block for the
prediction rows only — the last position at eval.
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
from easydgl_tpu_torch.nn.coding import (Embedding, PositionCoding,
                                         TimeSinusoidCoding)
from easydgl_tpu_torch.nn.layers import (ContribLayerNorm, Dense, dropout,
                                         gelu_exact, to_compute)
from easydgl_tpu_torch.nn import temporal
from easydgl_tpu_torch.nn.temporal import MAU, BiMAU


def _clip_spans(ts: torch.Tensor) -> torch.Tensor:
    """clip(Δt, 0, 100) with the first interval duplicated
    (EasyDGL.py:15-16, 72-74)."""
    spans = torch.clamp(ts[:, 1:] - ts[:, :-1], 0.0, 100.0)
    return torch.cat([spans[:, :1], spans], dim=-1)


class EasyDGL(SequentialModel):
    data_mode = "mau"
    uses_tpp = True
    long_context_engine = (temporal, "mau_streamed", mau_blocked)

    @classmethod
    def flax_layout(cls, cfg: Config, init) -> dict:
        """The JAX model's param tree: block 0's fused QKVT kernel takes the
        3C-wide inputs and is drawn from normal(0.02); vocab and position
        tables have one more row than the catalog and L (the MASK id)."""
        c, e = cfg.num_units, cfg.num_events
        dh = c // cfg.num_heads
        v = cfg.num_items + 1
        p = {}
        for i in range(cfg.num_blocks):
            c_in = 3 * c if i == 0 else c
            p[f"block{i}_bimau"] = {
                "qkvt": {"kernel": init.normal(0.02, c_in, 4 * c),
                         "bias": init.zeros(4 * c)},
                "intensity_dense_kernel": init.glorot(dh + 1, e * dh),
                "intensity_dense_bias": init.zeros(e * dh),
                "intensity_weight": init.glorot(e, dh),
                "intensity_scaling": init.zeros(e),
            }
            p[f"block{i}_attn_out"] = init.dense(c, c)
            p[f"block{i}_ln0"] = init.ln(c)
            p[f"block{i}_inter"] = init.dense(c, 2 * c)
            p[f"block{i}_out"] = init.dense(2 * c, c)
            p[f"block{i}_ln1"] = init.ln(c)
        p["item_embs"] = {"lookup_table": init.glorot(v, c)}
        p["mark_embs"] = {"lookup_table": init.glorot(e, c)}
        p["pcoding"] = {"pembs": {"lookup_table": init.glorot(cfg.seqslen + 1,
                                                              c)}}
        p["out_bias"] = {"output_bias": init.zeros(v - 1)}
        p["transform"] = init.dense(c, c)
        p["transform_ln"] = init.ln(c)
        return p

    def __init__(self, cfg: Config, *, device=None):
        super().__init__(cfg)
        self.gather_queries = cfg.gather_queries
        c = cfg.num_units
        cdt = cfg.matmul_dtype
        self.compute_dtype = cdt
        self.item_embs = Embedding(self.vocab_size, c, zero_pad=True,
                                   scale=True, device=device)
        self.mark_embs = Embedding(cfg.num_events, c, zero_pad=True,
                                   scale=False, device=device)
        self.tcoding = TimeSinusoidCoding(c)
        self.pcoding = PositionCoding(self.model_seqslen, c, device=device)
        for i in range(cfg.num_blocks):
            self.add_module(f"block{i}_bimau", BiMAU(
                3 * c if i == 0 else c, c, cfg.num_heads, cfg.num_events,
                cfg.attention_probs_dropout_rate,
                intensity_impl=mau_impl(cfg), block_k=cfg.mau_block_k,
                compute_dtype=cdt, device=device))
            self.add_module(f"block{i}_attn_out",
                            Dense(c, c, compute_dtype=cdt, device=device))
            self.add_module(f"block{i}_ln0",
                            ContribLayerNorm(c, compute_dtype=cdt,
                                             device=device))
            self.add_module(f"block{i}_inter",
                            Dense(c, 2 * c, compute_dtype=cdt, device=device))
            self.add_module(f"block{i}_out",
                            Dense(2 * c, c, compute_dtype=cdt, device=device))
            self.add_module(f"block{i}_ln1",
                            ContribLayerNorm(c, compute_dtype=cdt,
                                             device=device))
        self.transform = Dense(c, c, compute_dtype=cdt, device=device)
        self.transform_ln = ContribLayerNorm(c, compute_dtype=cdt,
                                             device=device)
        self.out_bias = OutputBias(self.vocab_size, device=device)

    @property
    def vocab_size(self) -> int:
        return self.cfg.num_items + 1

    @property
    def model_seqslen(self) -> int:
        return self.cfg.seqslen + 1

    def forward(self, features, *, is_training: bool = False,
                generator: Optional[torch.Generator] = None):
        """features: seqs_i (B, L+1) ids, seqs_t (B, L+1) raw timestamps,
        seqs_marks (B, L+1, E) [, masked_positions (B, M) at train].
        Returns (logits (N, V) fp32, aux) at eval and (None, aux) when
        training: the training loss scores ``aux[SCORING]`` through the
        streamed catalog NLL, and PyTorch, unlike XLA, would not drop an
        unused (N, V) product. ``generator`` draws every dropout mask of a
        training forward; it is required when a dropout rate is non-zero."""
        cfg = self.cfg
        rate = cfg.hidden_dropout_rate
        if is_training and generator is None and (
                rate or cfg.attention_probs_dropout_rate):
            raise ValueError("EasyDGL: a training forward with dropout needs "
                             "a torch.Generator")
        gen = generator if is_training else None
        c = cfg.num_units
        ids = features["seqs_i"].long()
        ts = scaled_times(features["seqs_t"], cfg.time_scale)
        spans = _clip_spans(ts)
        marks = features["seqs_marks"]

        units = self.item_embs(ids) + self.tcoding.code(ts)
        pos = self.pcoding.code(units)
        counts = marks.float().sum(-1, keepdim=True)
        mcodes = counts * self.mark_embs.table()[1][None, None, :]
        x = dropout(to_compute(torch.cat([units, pos, mcodes], dim=-1),
                               self.compute_dtype), rate, gen)  # (B, L+1, 3C)
        key_mask = (ids != 0).float()

        mpos = features.get("masked_positions")
        qpos_last = None
        if self.gather_queries:
            if is_training and mpos is not None \
                    and mpos.shape[1] < self.model_seqslen:
                qpos_last = mpos.long()
            elif not is_training:
                qpos_last = torch.full((ids.shape[0], 1),
                                       self.model_seqslen - 1,
                                       dtype=torch.long, device=ids.device)

        gathered = False
        intensities = []
        for i in range(cfg.num_blocks):
            blk = lambda name: getattr(self, f"block{i}_{name}")  # noqa: E731
            qpos = qpos_last if i == cfg.num_blocks - 1 else None
            a, intny = blk("bimau")(x, x, key_mask, spans, marks,
                                    query_positions=qpos, generator=gen)
            if qpos is not None:
                x_res = torch.take_along_dim(x, qpos[:, :, None], dim=1)
                gathered = True
            else:
                x_res = x
            a = dropout(blk("attn_out")(a), rate, gen)
            a = blk("ln0")(a + x_res[:, :, :c])
            o = dropout(blk("out")(gelu_exact(blk("inter")(a))), rate, gen)
            x = blk("ln1")(o + a)
            intensities.append(intny)

        x = self.transform_ln(gelu_exact(self.transform(x)))
        if gathered:
            hidden = x.reshape(-1, x.shape[-1])
        else:
            hidden = prediction_rows(x, is_training, mpos)
        bias = self.out_bias()
        table = self.item_embs.table()
        aux = {INTENSITIES: tuple(intensities), SCORING: (hidden, table, bias)}
        if is_training:
            return None, aux
        return tied_logits(hidden, table, bias, self.compute_dtype), aux

    def tpp_regularizer(self, aux, features, labels, next_marks):
        """ct_reg/num_heads * per-block biased likelihood over the MASKED
        positions (reference EasyDGL.py:158-175); spans from RAW (unscaled)
        timestamps, clipped to [0, 100]. A block whose intensities arrive
        gathered at the masked positions (gather_queries) is used as is."""
        cfg = self.cfg
        pos = features["masked_positions"].long()              # (B, M)
        spans = torch.take_along_dim(_clip_spans(features["seqs_t"].float()),
                                     pos, dim=1)               # (B, M)
        b, m = pos.shape
        h = cfg.num_heads
        spans = spans[:, None].expand(b, h, m)
        onehot = next_marks.float()[:, None]                   # (B, 1, M, E)
        onehot = onehot.expand(b, h, m, onehot.shape[-1])
        reg = 0.0
        for intny in aux[INTENSITIES]:
            if intny.shape[2] == m:
                gathered = intny
            else:
                gathered = torch.take_along_dim(
                    intny, pos[:, None, :, None], dim=2)       # (B, H, M, E)
            reg = reg + cfg.ct_reg * MAU.biased_likelihood(
                gathered, onehot, spans) / h
        return reg
