"""GREC: masked dilated-CNN encoder-decoder (WWW'20). Port of
``easydgl_tpu.models.grec``; parity with reference src/model/GREC.py:

* vocab num_items + 2, L + 1 positions; separate encoder and decoder
  tables ``enc_embs`` / ``dec_embs``, truncated-normal(0.02), no zero pad,
  no scale (GREC.py:44-47);
* the encoder: a non-causal ``MaskedCNN`` stack (``nn.cnn``) over the
  MASKED sequence in training (``seqs_m``), over ``seqs_i`` at eval; the
  projector ``x + dec_embs``, Dense 2C, tanh-GELU, Dense C, plus the
  residual; the decoder: a causal ``MaskedCNN`` stack (GREC.py:67-84);
* the masked positions' rows in training, the last position's at eval,
  then relu; an UNTIED dense head ``head_kernel`` (C, V), ``head_bias``
  (V,), with the id-0 and last (V - 1) columns forced to -1000 at eval
  (GREC.py:95-103). The model has no dropout.

Training returns no logits: ``aux[SCORING]`` is (hidden, ``head_kernel``
transposed, ``head_bias``), and the loss (``grec``) scores it through the
streamed catalog NLL. The head is stored (C, V), as flax holds it, so the
weight bridge, the optimizer state and the checkpoints carry it as they
carry every other leaf; the catalog wrapper makes the one (V, C) copy a
step that its kernels read, in the compute dtype.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from easydgl_tpu_torch.config import Config
from easydgl_tpu_torch.models.base import (SCORING, SequentialModel,
                                           prediction_rows)
from easydgl_tpu_torch.nn.cnn import MaskedCNN
from easydgl_tpu_torch.nn.coding import Embedding
from easydgl_tpu_torch.nn.layers import Dense, gelu_tanh, mm_fp32acc


class GREC(SequentialModel):
    data_mode = "grec"
    loss_mode = "grec"

    @property
    def vocab_size(self) -> int:
        return self.cfg.num_items + 2

    @property
    def model_seqslen(self) -> int:
        return self.cfg.seqslen + 1

    @classmethod
    def flax_layout(cls, cfg: Config, init) -> dict:
        """The JAX model's param tree: tables and conv weights
        truncated-normal(0.02), the projector and the head glorot."""
        c, v, w = cfg.num_units, cfg.num_items + 2, cfg.filter_width
        p = {name: {"lookup_table": init.truncated_normal(0.02, v, c)}
             for name in ("enc_embs", "dec_embs")}
        for stack in ("regu_cnn", "mask_cnn"):
            for i in range(len(cfg.dilations)):
                p[f"{stack}{i}"] = {
                    **{conv: {"weight": init.truncated_normal(0.02, w, c, c),
                              "bias": init.zeros(c)}
                       for conv in ("dconv0", "dconv1")},
                    "ln0": init.ln(c), "ln1": init.ln(c)}
        p["proj0"] = init.dense(c, 2 * c)
        p["proj1"] = init.dense(2 * c, c)
        p["head_kernel"] = init.glorot(c, v)
        p["head_bias"] = init.zeros(v)
        return p

    def __init__(self, cfg: Config, *, device=None):
        super().__init__(cfg)
        c, v = cfg.num_units, self.vocab_size
        cdt = cfg.matmul_dtype
        self.compute_dtype = cdt
        self.enc_embs = Embedding(v, c, zero_pad=False, scale=False,
                                  device=device)
        self.dec_embs = Embedding(v, c, zero_pad=False, scale=False,
                                  device=device)
        for i, d in enumerate(cfg.dilations):
            self.add_module(f"regu_cnn{i}", MaskedCNN(
                cfg.filter_width, c, d, causality=False, device=device))
        self.proj0 = Dense(c, 2 * c, compute_dtype=cdt, device=device)
        self.proj1 = Dense(2 * c, c, compute_dtype=cdt, device=device)
        for i, d in enumerate(cfg.dilations):
            self.add_module(f"mask_cnn{i}", MaskedCNN(
                cfg.filter_width, c, d, causality=True, device=device))
        self.head_kernel = nn.Parameter(torch.empty(c, v, device=device))
        self.head_bias = nn.Parameter(torch.empty(v, device=device))

    def forward(self, features, *, is_training: bool = False,
                generator: Optional[torch.Generator] = None):
        """features: seqs_i (B, T) ids; in training also seqs_m (the
        masked sequence) and masked_positions (B, M). Returns (logits
        (B, V) fp32, aux) at eval and (None, aux) when training;
        ``generator`` is accepted for the step's signature (no
        dropout)."""
        del generator
        cfg = self.cfg
        ids_dec = features["seqs_i"].long()
        ids_enc = features["seqs_m"].long() if is_training else ids_dec
        x = self.enc_embs(ids_enc)
        for i in range(len(cfg.dilations)):
            x = getattr(self, f"regu_cnn{i}")(x)
        inp = x + self.dec_embs(ids_dec)
        x = self.proj1(gelu_tanh(self.proj0(inp))) + inp
        for i in range(len(cfg.dilations)):
            x = getattr(self, f"mask_cnn{i}")(x)
        hidden = torch.relu(prediction_rows(
            x, is_training, features.get("masked_positions")))
        if is_training:
            return None, {SCORING: (hidden, self.head_kernel.t(),
                                    self.head_bias)}
        logits = mm_fp32acc(hidden, self.head_kernel, self.compute_dtype) \
            + self.head_bias
        neg = logits.new_full((logits.shape[0], 1), -1000.0)
        return torch.cat([neg, logits[:, 1:-1], neg], dim=-1), {}
