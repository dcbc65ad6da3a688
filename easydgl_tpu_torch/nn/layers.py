"""Core NN building blocks (port of ``easydgl_tpu.nn.layers``).

* ``ContribLayerNorm``: TF-contrib LayerNorm — moments over ALL non-batch
  axes (T, C jointly), gamma/beta on the last axis, eps 1e-12. Not
  ``torch.nn.LayerNorm``, which normalises the last axis only.
* ``LastAxisLayerNorm``: the reference's simple LN (normalize.py:9-19) —
  last-axis moments, eps 1e-8, in the input's dtype (TGREC's attention).
* ``Dense``: ``tf.layers.dense`` with the weight stored ``(out, in)`` as
  ``nn.Linear`` does; the bridge (parity.py) transposes flax's ``(in, out)``
  kernels. Parameters are allocated empty: weights come from the bridge.

* ``FeedForward``: the reference's two width-1 convs (== Dense) with
  ReLU, dropout after each, and the residual (reference Base.py:70-87).
* ``dropout``: flax ``nn.Dropout`` — keep with probability 1-p, scale kept
  entries by 1/(1-p) in the input's dtype; the mask is drawn from an
  explicit ``torch.Generator`` with ``torch.rand`` (``F.dropout`` takes no
  generator).

Mixed precision follows the JAX package: parameters stay fp32; with a
compute dtype (``Config.matmul_dtype``, ``torch.bfloat16``) a Dense casts
its input, weight AND bias to that dtype and returns it (flax
``nn.Dense(dtype=bf16)``); ``mm_fp32acc`` contractions take compute-dtype
operands and return fp32 (``mxu_einsum``; ``einsum_fp32acc`` for other
contractions); LayerNorm moments, softmax and metrics are fp32.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def to_compute(x: torch.Tensor, cdt: Optional[torch.dtype]) -> torch.Tensor:
    """Cast an activation to the compute dtype (no-op in fp32 mode)."""
    return x.to(cdt) if cdt is not None else x


def _rounded(ops, cdt: Optional[torch.dtype]):
    """Each operand rounded to ``cdt`` and widened back to fp32 (as given
    where ``cdt`` is None)."""
    return ops if cdt is None else tuple(o.to(cdt).float() for o in ops)


def mm_fp32acc(a: torch.Tensor, b: torch.Tensor,
               cdt: Optional[torch.dtype]) -> torch.Tensor:
    """``a @ b`` with operands rounded to ``cdt`` and an fp32 result.

    The rounded operands are widened back to fp32 before the product: a
    product of two bf16 values is exact in fp32, so this is a bf16-operand,
    fp32-accumulate contraction whose result is never rounded to bf16 —
    what ``preferred_element_type=float32`` gives in JAX."""
    a, b = _rounded((a, b), cdt)
    return a @ b


def einsum_fp32acc(eq: str, *ops: torch.Tensor,
                   cdt: Optional[torch.dtype]) -> torch.Tensor:
    """``torch.einsum`` with ``mm_fp32acc``'s rounding: operands rounded to
    ``cdt``, an fp32 result (JAX ``mxu_einsum``)."""
    return torch.einsum(eq, *_rounded(ops, cdt))


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``; the identity when ``rate`` is 0 or there is no
    generator (the deterministic, eval case)."""
    if rate == 0.0 or generator is None:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < (
        1.0 - rate)
    return torch.where(keep, x / (1.0 - rate),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def dropout_seed(generator: torch.Generator) -> torch.Tensor:
    """One int64 seed, on the generator's device, for the counter-based
    (Philox) dropout of the attention kernels and the context-parallel
    bodies; drawing it does not wait for the device."""
    return torch.randint(0, 2 ** 31 - 1, (), generator=generator,
                         device=generator.device)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Erf-based GELU (reference: src/model/BERT4REC.py:12-24)."""
    return F.gelu(x, approximate="none")


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """Tanh-approximate GELU (reference: src/model/GREC.py:14-26; JAX
    ``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")


class Dense(nn.Module):
    """``tf.layers.dense``: y = x @ W^T + b, W stored (out, in); no ``bias``
    parameter with ``use_bias=False``."""

    def __init__(self, in_features: int, out_features: int, *,
                 use_bias: bool = True,
                 compute_dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, device=device))
        self.bias = (nn.Parameter(torch.empty(out_features, device=device))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        if cdt is None:
            return F.linear(x, self.weight, self.bias)
        return F.linear(x.to(cdt), self.weight.to(cdt),
                        None if self.bias is None else self.bias.to(cdt))


class FeedForward(nn.Module):
    """Dense ``inner``, ReLU, dropout, Dense ``readout``, dropout, plus the
    input (JAX ``nn/layers.py::FeedForward``)."""

    def __init__(self, in_features: int, num_units, dropout_rate: float = 0.2,
                 *, compute_dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.inner = Dense(in_features, num_units[0],
                           compute_dtype=compute_dtype, device=device)
        self.readout = Dense(num_units[0], num_units[1],
                             compute_dtype=compute_dtype, device=device)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator``: the training step's (dropout); None at eval."""
        rate = self.dropout_rate
        h = dropout(torch.relu(self.inner(x)), rate, generator)
        return dropout(self.readout(h), rate, generator) + x


class ContribLayerNorm(nn.Module):
    """TF-contrib-style LN: moments over all non-batch axes, params on the
    last (reference: src/model/Base.py:12-67). Output in the compute
    dtype."""

    def __init__(self, dim: int, *, epsilon: float = 1e-12,
                 compute_dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.compute_dtype = compute_dtype
        self.gamma = nn.Parameter(torch.empty(dim, device=device))
        self.beta = nn.Parameter(torch.empty(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        axes = tuple(range(1, x.dim()))
        mean = xf.mean(dim=axes, keepdim=True)
        var = (xf - mean).square().mean(dim=axes, keepdim=True)
        inv = torch.rsqrt(var + self.epsilon)
        out = (xf - mean) * inv * self.gamma + self.beta
        return to_compute(out, self.compute_dtype)


class LastAxisLayerNorm(nn.Module):
    """Last-axis LN (reference normalize.py:9-19, JAX
    ``nn/layers.py::LastAxisLayerNorm``): ``(x - mean) / sqrt(var + eps)``
    over the last axis, then ``gamma * x + beta``; no compute-dtype cast."""

    def __init__(self, dim: int, *, epsilon: float = 1e-8, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.gamma = nn.Parameter(torch.empty(dim, device=device))
        self.beta = nn.Parameter(torch.empty(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        return self.gamma * ((x - mean) / torch.sqrt(var + self.epsilon)) \
            + self.beta


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, T, C) -> (B, H, T, C/H); head h sees channel block
    [h*C/H : (h+1)*C/H] (reference sequential.py:39-41)."""
    b, t, c = x.shape
    return x.reshape(b, t, num_heads, c // num_heads).permute(0, 2, 1, 3)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, D) -> (B, T, H*D), inverse of split_heads."""
    b, h, t, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, t, h * d)
