"""Sequence attention of the time-independent family (port of
``easydgl_tpu.nn.attention``), reference src/module/sequential.py:16-83.

``MultiHeadAttention``: Q from the queries, K and V from the keys; the key
mask ``sign(|sum_c keys|)`` over the RAW key tensor (sequential.py:50);
optional causal mask; softmax, dropout, PV; the residual adds
``queries[..., :C]`` (the queries may be wider than C when position codes
were concatenated upstream). ``impl`` picks the attention core:

* ``"xla"``: materialised (T, T) probs, the reference semantics verbatim
  (``attention_probs``: mask value -2^32+1, so a row that sees no key is
  uniform over every key), dropout as flax ``nn.Dropout`` on the probs;
* ``"flash"``: ``kernels.flash_attention`` (the kernels on the card, the
  plain version on the CPU), O(T) memory. It writes 0 on a row that sees no
  key; such rows are patched to the xla path's uniform value, the mean of V
  over all keys, so the module equals ``"xla"`` on every row at dropout 0.
  One dropout seed per call, drawn from the step's generator.

``BERTAttention`` (BERT4REC): the same cores without the residual; the
``"xla"`` core takes the caller's (B, Tq, Tk) attention mask, the
``"flash"`` core the caller's key mask, never causal. Both modules' flash
cores share ``flash_context`` (the seed draw and the patch of rows that see
no key).

Under a (data, model) mesh the flash core splits whole heads over the
model axis (``kernels/spmd.py::flash_attention_spmd``), as JAX's SPMD
branch does. Under a seq axis of cp > 1 (or a ``LocalExchange``,
``dist/context.py::seq_exchange``) both modules take the context-parallel
branch whatever their ``impl`` (JAX attention.py:92-110, :165-194):
``cp_impl`` ``"ring"`` or ``"ulysses"`` (``dist/context.py``); BERTAttention
takes it with a key mask only, as JAX's.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from easydgl_tpu_torch.core.mesh import spmd_mesh
from easydgl_tpu_torch.kernels.flash_attention import flash_attention
from easydgl_tpu_torch.nn.layers import (Dense, dropout, dropout_seed,
                                         merge_heads, mm_fp32acc, split_heads)

NEG_INF_LOGIT = -(2.0 ** 32) + 1.0   # the reference's mask value


def attention_probs(q: torch.Tensor, k: torch.Tensor, *,
                    bias: Optional[torch.Tensor] = None,
                    key_mask: Optional[torch.Tensor] = None,
                    causal: bool = False, scale: Optional[float] = None,
                    compute_dtype: Optional[torch.dtype] = None
                    ) -> torch.Tensor:
    """Masked, scaled softmax probabilities, fp32 (B, H, Tq, Tk).

    q (B, H, Tq, D), k (B, H, Tk, D); key_mask (B, Tk); ``bias``: additive
    logits (B, H, Tq, Tk), added before the scale. The logits are a
    compute-dtype contraction with an fp32 result (``mxu_einsum``)."""
    logits = mm_fp32acc(q, k.transpose(-1, -2), compute_dtype)
    if bias is not None:
        logits = logits + bias
    logits = logits * (scale if scale is not None else
                       1.0 / q.shape[-1] ** 0.5)
    return masked_softmax(logits, key_mask, causal)


def masked_softmax(logits: torch.Tensor,
                   key_mask: Optional[torch.Tensor] = None,
                   causal: bool = False) -> torch.Tensor:
    """Softmax over the last axis of (B, H, Tq, Tk) logits with the
    reference's mask value where ``key_mask`` (B, Tk) is 0 and, under
    ``causal``, above the diagonal."""
    if key_mask is not None:
        km = (key_mask != 0)[:, None, None, :]
        logits = torch.where(km, logits, NEG_INF_LOGIT)
    if causal:
        tq, tk = logits.shape[-2], logits.shape[-1]
        tril = torch.ones((tq, tk), dtype=torch.bool,
                          device=logits.device).tril()
        logits = torch.where(tril, logits, NEG_INF_LOGIT)
    return torch.softmax(logits, dim=-1)


def flash_context(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  key_mask: torch.Tensor, *, causal: bool, rate: float,
                  generator: Optional[torch.Generator],
                  scale: Optional[float] = None,
                  spmd: bool = True) -> torch.Tensor:
    """The ``"flash"`` core: (B, H, Tq, Dv) context of ``flash_attention``,
    with one dropout seed drawn from ``generator`` when ``rate`` > 0, and
    every row that sees no key (under ``causal``: no key at or before it;
    else: a batch entry with no key at all) set to the xla path's uniform
    value, the mean of V over all keys. ``scale`` multiplies q . k (default
    1/sqrt of q's width; the Bochner attentions pass 1/sqrt(dh) of their
    un-augmented heads). ``spmd`` False keeps the single-device kernel
    call under a mesh (TGREC's, which has no SPMD branch in JAX)."""
    seed = dropout_seed(generator) if rate > 0.0 else None
    mesh = spmd_mesh() if spmd else None
    if mesh is not None:
        # under a mesh: heads split over the model axis (kernels/spmd.py),
        # as JAX's flash branches (attention.py:113-125, :195-205)
        from easydgl_tpu_torch.kernels.spmd import flash_attention_spmd
        ctx = flash_attention_spmd(q, k, v, key_mask, mesh, causal=causal,
                                   scale=scale, dropout_rate=rate, seed=seed)
    else:
        ctx = flash_attention(q, k, v, key_mask, causal=causal, scale=scale,
                              dropout_rate=rate, seed=seed)
    return torch.where(rows_that_see(key_mask, causal), ctx,
                       v.mean(dim=2, keepdim=True))


def rows_that_see(key_mask: torch.Tensor, causal: bool) -> torch.Tensor:
    """(B, 1, Tq or 1, 1) bool: the query rows that see a key, from the
    key mask (B, Tk) — under ``causal`` a key at or before the row, else
    any key of the batch entry."""
    if causal:
        return (torch.cumsum(key_mask, dim=1) > 0)[:, None, :, None]
    return (key_mask > 0).any(dim=1)[:, None, None, None]


class MultiHeadAttention(nn.Module):
    """Vanilla multi-head attention with the residual (reference
    sequential.py:16-83). Parameters ``q``, ``k``, ``v`` (Dense, C
    outputs); queries and keys may be wider than C."""

    def __init__(self, in_queries: int, in_keys: int, num_units: int,
                 num_heads: int, dropout_rate: float = 0.0, *,
                 impl: str = "xla", cp_impl: str = "ring",
                 compute_dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        if impl not in ("xla", "flash"):
            raise ValueError(f"MultiHeadAttention: unknown impl {impl}")
        self.num_units = num_units
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.impl = impl
        self.cp_impl = cp_impl
        self.compute_dtype = compute_dtype
        kw = dict(compute_dtype=compute_dtype, device=device)
        self.q = Dense(in_queries, num_units, **kw)
        self.k = Dense(in_keys, num_units, **kw)
        self.v = Dense(in_keys, num_units, **kw)

    def forward(self, queries: torch.Tensor, keys: torch.Tensor, *,
                causality: bool,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """queries (B, Tq, Cq), keys (B, Tk, Ck) -> (B, Tq, C).
        ``generator``: the training step's (dropout); None at eval."""
        h = self.num_heads
        q = split_heads(self.q(queries), h)
        k = split_heads(self.k(keys), h)
        v = split_heads(self.v(keys), h)
        key_mask = torch.sign(torch.abs(keys.detach().sum(-1)))
        residual = queries[:, :, :self.num_units]
        rate = self.dropout_rate if generator is not None else 0.0

        from easydgl_tpu_torch.dist.context import cp_attention, seq_exchange
        ex = seq_exchange()
        if ex is not None:
            ctx = cp_attention(self.cp_impl, q, k, v, key_mask, ex,
                               causal=causality, dropout_rate=rate,
                               generator=generator,
                               compute_dtype=self.compute_dtype)
            return merge_heads(ctx) + residual

        if self.impl == "flash":
            ctx = flash_context(q, k, v, key_mask, causal=causality,
                                rate=rate, generator=generator)
            return merge_heads(ctx) + residual

        probs = attention_probs(q, k, key_mask=key_mask, causal=causality,
                                compute_dtype=self.compute_dtype)
        probs = dropout(probs, rate, generator)
        ctx = mm_fp32acc(probs, v, self.compute_dtype)
        return merge_heads(ctx) + residual


class BERTAttention(nn.Module):
    """BERT-style attention, no residual (reference sequential.py:86-137).
    Parameters ``q``, ``k``, ``v`` (Dense, C outputs; truncated-normal(0.02)
    kernels in the JAX model's ``init``)."""

    def __init__(self, num_units: int, num_heads: int,
                 dropout_rate: float = 0.0, *, impl: str = "xla",
                 cp_impl: str = "ring",
                 compute_dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        if impl not in ("xla", "flash"):
            raise ValueError(f"BERTAttention: unknown impl {impl}")
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.impl = impl
        self.cp_impl = cp_impl
        self.compute_dtype = compute_dtype
        kw = dict(compute_dtype=compute_dtype, device=device)
        self.q = Dense(num_units, num_units, **kw)
        self.k = Dense(num_units, num_units, **kw)
        self.v = Dense(num_units, num_units, **kw)

    def forward(self, queries: torch.Tensor, keys: torch.Tensor,
                attention_mask: Optional[torch.Tensor], *,
                key_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """queries (B, Tq, C), keys (B, Tk, C) -> (B, Tq, C).
        ``attention_mask`` (B, Tq, Tk) or (B, 1, Tq, Tk), nonzero: attend
        (the ``"xla"`` core); ``key_mask`` (B, Tk): the ``"flash"`` core's,
        which without it takes the ``"xla"`` core. ``generator``: the
        training step's (dropout); None at eval."""
        h = self.num_heads
        q = split_heads(self.q(queries), h)
        k = split_heads(self.k(keys), h)
        v = split_heads(self.v(keys), h)
        rate = self.dropout_rate if generator is not None else 0.0

        from easydgl_tpu_torch.dist.context import cp_attention, seq_exchange
        ex = seq_exchange() if key_mask is not None else None
        if ex is not None:
            return merge_heads(cp_attention(
                self.cp_impl, q, k, v, key_mask.float(), ex, causal=False,
                dropout_rate=rate, generator=generator,
                compute_dtype=self.compute_dtype))

        if self.impl == "flash" and key_mask is not None:
            return merge_heads(flash_context(
                q, k, v, key_mask.float(), causal=False, rate=rate,
                generator=generator))

        logits = mm_fp32acc(q, k.transpose(-1, -2), self.compute_dtype) / (
            q.shape[-1] ** 0.5)
        mask = (attention_mask if attention_mask.dim() == 4
                else attention_mask[:, None])
        logits = torch.where(mask != 0, logits, NEG_INF_LOGIT)
        probs = dropout(torch.softmax(logits, dim=-1), rate, generator)
        return merge_heads(mm_fp32acc(probs, v, self.compute_dtype))
