"""TimelyREC encoders (port of ``easydgl_tpu.nn.mate``).

* ``MATEncoder``: multi-aspect time encoder, user-conditioned attention
  over candidate time-slot embeddings (reference
  src/module/sequential.py:210-237): ``u = user_proj(users)`` (no bias),
  the logits ``(q u) . (k u)`` over the W + 1 slot keys divided by
  sqrt(H) in fp32, softmax, the weighted keys.
* ``TAHEncoder``: time-aware history encoder (reference
  sequential.py:240-265): the weights ``(1 + cos) / 2`` of the
  l2-normalised queries and keys, MULTIPLIED by the causal ``tril`` (a
  zeroing mask, not a -inf softmax mask), applied to the histories.

Contractions are ``einsum_fp32acc`` (JAX ``mxu_einsum``): compute-dtype
operands, an fp32 result.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from easydgl_tpu_torch.nn.layers import Dense, einsum_fp32acc


class MATEncoder(nn.Module):
    """Parameter ``user_proj`` (Dense, no bias)."""

    def __init__(self, num_units: int, *,
                 compute_dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.user_proj = Dense(num_units, num_units, use_bias=False,
                               compute_dtype=compute_dtype, device=device)

    def forward(self, queries: torch.Tensor, keys: torch.Tensor,
                users: torch.Tensor) -> torch.Tensor:
        """queries (B, S, 1, H), keys (B, S, W, H), users (B, S, H) ->
        (B, S, H) fp32."""
        cdt = self.compute_dtype
        h = queries.shape[-1]
        u = self.user_proj(users)[:, :, None, :]
        q = queries * u
        k = keys * u
        logits = einsum_fp32acc("bsoh,bswh->bsow", q, k, cdt=cdt)
        logits = logits / torch.sqrt(torch.tensor(
            float(h), dtype=torch.float32, device=logits.device))
        probs = torch.softmax(logits, dim=-1)
        return einsum_fp32acc("bsow,bswh->bsoh", probs, k, cdt=cdt)[:, :, 0]


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """``tf.nn.l2_normalize``: ``x * rsqrt(max(sum(x^2), eps))`` over the
    last axis, in exactly this form (``F.normalize`` divides by
    ``max(norm, eps)``, another value on small rows). Its gradient is
    finite on an all-zero row: the threshold acts on the sum of squares
    before the rsqrt, so no 0/0 reaches the backward."""
    sq = x.square().sum(dim=-1, keepdim=True)
    return x * torch.rsqrt(torch.clamp_min(sq, eps))


class TAHEncoder(nn.Module):
    """No parameters."""

    def __init__(self, *, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype

    def forward(self, queries: torch.Tensor, keys: torch.Tensor,
                histories: torch.Tensor) -> torch.Tensor:
        """queries, keys (B, S, H); histories (B, S, H) -> (B, S, H)
        fp32."""
        cdt = self.compute_dtype
        qn, kn = l2_normalize(queries), l2_normalize(keys)
        cos = einsum_fp32acc("bqh,bkh->bqk", qn, kn, cdt=cdt)
        w = (1.0 + cos) / 2.0
        s = w.shape[-1]
        w = w * torch.ones((s, s), dtype=w.dtype, device=w.device).tril()
        return einsum_fp32acc("bqk,bkh->bqh", w, histories, cdt=cdt)
