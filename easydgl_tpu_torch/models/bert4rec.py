"""BERT4Rec: bidirectional masked-item transformer (CIKM'19). Port of
``easydgl_tpu.models.bert4rec``; parity with reference src/model/BERT4REC.py:

* L+1 positions, vocab num_items + 2 (the MASK id is num_items,
  BERT4REC.py:43-45);
* scaled item embeddings plus ADDED position codes, LN, dropout (:61-70);
* post-LN blocks: ``BERTAttention`` (no residual), ``attn_out``, dropout,
  LN of the residual sum; a 2C GELU intermediate, ``out``, dropout, LN of
  the residual sum (:84-111);
* the GELU transform head with its LN (:114-117);
* the masked positions' rows in training, the last (MASK) position's at
  eval (:120-121); tied scoring with a -1000 bias on id 0.

``attention_impl`` picks the attention core (``nn.attention``): ``"xla"``
with the (B, T, T) attention mask for the short-context preset,
``"flash"`` with the key mask, non-causal, for BERT4REC-LC (L+1 = 2048),
whose kernels run on the card. Training: hidden dropout after the
embedding LN and after ``attn_out`` and ``out``, attention dropout in the
core, all drawn from the step's ``torch.Generator``. The training forward
returns no logits: the loss (``sparse_ce``) scores ``aux[SCORING]``
through the streamed catalog NLL. ``cfg.remat`` recomputes each block in
the backward (``models.base.remat``).
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
from easydgl_tpu_torch.nn.attention import BERTAttention
from easydgl_tpu_torch.nn.coding import Embedding, PositionCoding
from easydgl_tpu_torch.nn.layers import (ContribLayerNorm, Dense, dropout,
                                         gelu_exact)


class BERT4REC(SequentialModel):
    data_mode = "masked"
    loss_mode = "sparse_ce"
    long_context_engine = (attention, "flash_attention",
                           flash_attention_reference)

    @property
    def vocab_size(self) -> int:
        return self.cfg.num_items + 2

    @property
    def model_seqslen(self) -> int:
        return self.cfg.seqslen + 1

    @classmethod
    def flax_layout(cls, cfg: Config, init) -> dict:
        """The JAX model's param tree: q/k/v kernels truncated-normal(0.02),
        every other Dense and table glorot."""
        c, v, t = cfg.num_units, cfg.num_items + 2, cfg.seqslen + 1
        p = {"item_embs": {"lookup_table": init.glorot(v, c)},
             "pcoding": {"pembs": {"lookup_table": init.glorot(t, c)}},
             "emb_ln": init.ln(c)}
        for i in range(cfg.num_blocks):
            p[f"block{i}_attn"] = {
                name: {"kernel": init.truncated_normal(0.02, c, c),
                       "bias": init.zeros(c)} for name in ("q", "k", "v")}
            p[f"block{i}_attn_out"] = init.dense(c, c)
            p[f"block{i}_ln0"] = init.ln(c)
            p[f"block{i}_inter"] = init.dense(c, 2 * c)
            p[f"block{i}_out"] = init.dense(2 * c, c)
            p[f"block{i}_ln1"] = init.ln(c)
        p["transform"] = init.dense(c, c)
        p["transform_ln"] = init.ln(c)
        p["out_bias"] = {"output_bias": init.zeros(v - 1)}
        return p

    def __init__(self, cfg: Config, *, device=None):
        super().__init__(cfg)
        c = cfg.num_units
        cdt = cfg.matmul_dtype
        self.compute_dtype = cdt
        kw = dict(compute_dtype=cdt, device=device)
        self.item_embs = Embedding(self.vocab_size, c, zero_pad=True,
                                   scale=True, device=device)
        self.pcoding = PositionCoding(self.model_seqslen, c, device=device)
        self.emb_ln = ContribLayerNorm(c, **kw)
        for i in range(cfg.num_blocks):
            self.add_module(f"block{i}_attn", BERTAttention(
                c, cfg.num_heads, cfg.attention_probs_dropout_rate,
                impl=cfg.attention_impl, cp_impl=cfg.cp_impl, **kw))
            self.add_module(f"block{i}_attn_out", Dense(c, c, **kw))
            self.add_module(f"block{i}_ln0", ContribLayerNorm(c, **kw))
            self.add_module(f"block{i}_inter", Dense(c, 2 * c, **kw))
            self.add_module(f"block{i}_out", Dense(2 * c, c, **kw))
            self.add_module(f"block{i}_ln1", ContribLayerNorm(c, **kw))
        self.transform = Dense(c, c, **kw)
        self.transform_ln = ContribLayerNorm(c, **kw)
        self.out_bias = OutputBias(self.vocab_size, device=device)

    def forward(self, features, *, is_training: bool = False,
                generator: Optional[torch.Generator] = None):
        """features: seqs_i (B, L+1) ids, and ``masked_positions`` (B, M)
        when training. Returns (logits (B, V) fp32, aux) at eval and (None,
        aux) when training; ``generator`` draws every dropout mask of a
        training forward and is required when a dropout rate is non-zero."""
        cfg = self.cfg
        if is_training and generator is None and (
                cfg.hidden_dropout_rate or cfg.attention_probs_dropout_rate):
            raise ValueError("BERT4REC: a training forward with dropout "
                             "needs a torch.Generator")
        gen = generator if is_training else None
        ids = features["seqs_i"].long()
        x = self.item_embs(ids)
        x = x + self.pcoding.code(x)
        x = dropout(self.emb_ln(x), cfg.hidden_dropout_rate, gen)
        key_mask = (ids != 0).float()
        # the (B, Tq, Tk) attention mask (BERT4REC.py:74-79), a broadcast
        # of the key mask; the flash core takes the key mask itself
        attn_mask = (None if cfg.attention_impl == "flash" else
                     key_mask[:, None, :].expand(-1, ids.shape[1], -1))
        masks = (attn_mask, key_mask)
        for i in range(cfg.num_blocks):
            if cfg.remat and torch.is_grad_enabled():
                x = remat(self._block, i, x, masks, gen)
            else:
                x = self._block(i, x, masks, gen)
        x = self.transform_ln(gelu_exact(self.transform(x)))
        hidden = prediction_rows(x, is_training,
                                 features.get("masked_positions"))
        bias = self.out_bias()
        table = self.item_embs.table()
        aux = {SCORING: (hidden, table, bias)}
        if is_training:
            return None, aux
        return tied_logits(hidden, table, bias, self.compute_dtype), aux

    def _block(self, i: int, x, masks, gen):
        """Block i, post-LN: attention, ``attn_out``, dropout,
        ``ln0(a + x)``; ``inter`` with GELU, ``out``, dropout,
        ``ln1(o + a)``."""
        blk = lambda name: getattr(self, f"block{i}_{name}")  # noqa: E731
        rate = self.cfg.hidden_dropout_rate
        attn_mask, key_mask = masks
        a = blk("attn")(x, x, attn_mask, key_mask=key_mask, generator=gen)
        a = dropout(blk("attn_out")(a), rate, gen)
        a = blk("ln0")(a + x)
        o = blk("out")(gelu_exact(blk("inter")(a)))
        o = dropout(o, rate, gen)
        return blk("ln1")(o + a)
