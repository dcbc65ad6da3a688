"""Blocked MAU/BiMAU forward: the two-sweep long-context schedule in plain
PyTorch (port of ``easydgl_tpu.kernels.mau_blocked``, forward only).

The chain of ``mau_attention`` without any (Tq, Tk) tensor: keys are taken
in blocks of ``block_k`` and every intermediate is O(T * block_k).

* sweep 1 (``stats_reference``): online softmax stats m and l and the
  exp-weighted T accumulation, seq_units = softmax(S) @ T;
* the Hawkes intensity head (``intensity_reference``) once on seq_units, in
  fp32 — it needs only per-query state, so two sweeps are the least exact
  split;
* sweep 2 (``output_reference``): each probs block is recomputed as
  exp(s - m) / l, never exp(s - lse) (on a fully masked row every logit is
  the finite -2^32+1, whose fp32 ulp of 512 swallows log(T)), modulated by
  lam @ onehot^T (BiMAU: the diagonal := 1), dropped, and @V.

Masks follow the reference: real keys that are masked or causally hidden
get the finite -2^32+1, so a row with no visible key is uniform over all
the real keys; the alignment padding of the last key block gets -1e38 and
never counts.

It is the CPU engine of ``attention_impl="flash"`` and the plain version
the card kernels of ``kernels.mau_streamed`` are held against, so each
sweep is its own function and ``mau_blocked_forward`` also returns the
intermediates m, l, seq_units and lam.

Layout and precision are ``mau_attention``'s: q/k/v/t on the natural
(B, T, C) layout, queries at positions 0..Tq-1; the compute dtype is q's.
The operands of each block product are rounded to it and summed in fp32
(the JAX package's ``_mm``): the probs before @T, lam before @onehot^T, the
modulated probs before @V. Logits, stats and the intensity head are fp32.

Dropout draws from the Philox rule of ``mau_attention.dropout_factor`` at
the global key index, so the blocked, the streamed and the fused paths
draw one mask for one seed (the JAX package's blocked path draws from
``jax.random`` instead). Gradients are autograd's through these plain ops;
the two-pass custom backward comes with the long-context training slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from easydgl_tpu_torch.kernels.mau_attention import (NEG, _heads, _merge,
                                                     _round_to,
                                                     dropout_factor)

PAD_NEG = -1.0e38   # alignment padding: below NEG, so it never counts


class BlockedForward(NamedTuple):
    """The forward's outputs and the intermediates each kernel produces."""
    out: torch.Tensor   # (B, Tq, C) in q's dtype
    lam: torch.Tensor   # (B, H, Tq, E) fp32 mark intensities
    m: torch.Tensor     # (B, H, Tq) fp32 row max of the masked logits
    l: torch.Tensor     # (B, H, Tq) fp32 sum of exp(s - m)
    su: torch.Tensor    # (B, H, Tq, dh) fp32 seq_units


def _block(block_k: int, tk: int):
    """(bk, padded Tk): bk = min(block_k, Tk); Tk rounded up to bk."""
    bk = min(int(block_k), tk)
    return bk, -(-tk // bk) * bk


def _pad_keys(x: torch.Tensor, tkp: int) -> torch.Tensor:
    """Zero-pads dim 1 (keys) of (B, Tk, ...) to tkp."""
    pad = tkp - x.shape[1]
    if pad == 0:
        return x
    return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))


def _masked_logits(qh, kb, kmb, j0, *, scale, causal, tk):
    """One (B, H, Tq, bk) logits block of keys j0..j0+bk-1: visible keys
    give q.k * scale, real masked or causally hidden keys NEG, alignment
    padding PAD_NEG."""
    tq, bk = qh.shape[2], kb.shape[2]
    dev = qh.device
    s = (qh @ kb.transpose(-1, -2)) * scale
    kpos = j0 + torch.arange(bk, device=dev)
    mask = (kmb > 0)[:, None, None, :]
    if causal:
        qpos = torch.arange(tq, device=dev)
        mask = mask & (kpos[None, None, None, :] <= qpos[None, None, :, None])
    fill = torch.where(kpos < tk, NEG, PAD_NEG)
    return torch.where(mask, s, fill)


def stats_reference(q, k, t, key_mask, *, causal: bool = False,
                    num_heads: int, block_k: int = 512):
    """Sweep 1: (m, l, seq_units), (B, H, Tq) / (B, H, Tq) / (B, H, Tq, dh)
    fp32. Each block's probs exp(s - m_running) are rounded to q's dtype
    before @T (JAX ``mau_blocked.py:195``)."""
    cdt = q.dtype
    b, tq, _ = q.shape
    tk = k.shape[1]
    h = num_heads
    bk, tkp = _block(block_k, tk)
    qh = _heads(q, h)
    kh, th = (_heads(_pad_keys(x, tkp), h) for x in (k, t))
    km = _pad_keys(key_mask.float(), tkp)
    dh = qh.shape[-1]
    scale = 1.0 / dh ** 0.5
    m = torch.full((b, h, tq, 1), PAD_NEG, device=q.device)
    l = torch.zeros((b, h, tq, 1), device=q.device)
    su = torch.zeros((b, h, tq, dh), device=q.device)
    for j0 in range(0, tkp, bk):
        s = _masked_logits(qh, kh[:, :, j0:j0 + bk], km[:, j0:j0 + bk], j0,
                           scale=scale, causal=causal, tk=tk)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        su = su * corr + _round_to(p, cdt) @ th[:, :, j0:j0 + bk]
        m = m_new
    return m[..., 0], l[..., 0], su / l


def intensity_reference(su, intervals, wd, bd, w, scaling):
    """The Hawkes intensity head in fp32 (JAX ``mau_blocked._intensity``):
    lam = s * softplus(raw / s), s = exp(scaling), raw[e] = sum_d
    sigmoid([su | interval] @ Wd + bd)[e*dh + d] * w[e, d].

    su: (B, H, Tq, dh); intervals: (B, Tq). Returns (B, H, Tq, E) fp32."""
    b, h, tq, dh = su.shape
    e = w.shape[0]
    iv = intervals.float()[:, None, :, None].expand(b, h, tq, 1)
    x = torch.cat([su.float(), iv], dim=-1)
    sig = torch.sigmoid(x @ wd.float() + bd.float()).reshape(b, h, tq, e, dh)
    raw = (sig * w.float()).sum(-1)
    sc = torch.exp(scaling.float())
    return sc * torch.logaddexp(raw / sc, torch.zeros((), device=su.device))


def output_reference(q, k, v, key_mask, onehot, lam, m, l, *,
                     causal: bool = False, diag_reset: bool = False,
                     dropout_rate: float = 0.0, dropout_seed=None,
                     num_heads: int, block_k: int = 512):
    """Sweep 2: out (B, Tq, C) in q's dtype, from the stats (m, l) and lam
    (B, H, Tq, E). Per key block: p = exp(s - m) / l; iqk = lam @ onehot^T
    with lam rounded to q's dtype, BiMAU's diagonal := 1; the dropped
    modulated probs are rounded to q's dtype before @V."""
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("mau_blocked: dropout_rate > 0 needs dropout_seed")
    cdt = q.dtype
    b, tq, _ = q.shape
    tk = k.shape[1]
    h = num_heads
    dev = q.device
    bk, tkp = _block(block_k, tk)
    qh = _heads(q, h)
    kh, vh = (_heads(_pad_keys(x, tkp), h) for x in (k, v))
    km = _pad_keys(key_mask.float(), tkp)
    oh = _round_to(_pad_keys(onehot.float(), tkp), cdt)
    dh = qh.shape[-1]
    scale = 1.0 / dh ** 0.5
    lam_r = _round_to(lam.float(), cdt)
    mm, ll = m[..., None], l[..., None]
    qpos = torch.arange(tq, device=dev)
    acc = torch.zeros((b, h, tq, dh), device=dev)
    for j0 in range(0, tkp, bk):
        s = _masked_logits(qh, kh[:, :, j0:j0 + bk], km[:, j0:j0 + bk], j0,
                           scale=scale, causal=causal, tk=tk)
        p = torch.exp(s - mm) / ll
        iqk = lam_r @ oh[:, None, j0:j0 + bk].transpose(-1, -2)
        if diag_reset:
            kpos = j0 + torch.arange(bk, device=dev)
            iqk = torch.where(kpos[None, None, None, :]
                              == qpos[None, None, :, None], 1.0, iqk)
        mod = iqk * p
        if dropout_rate > 0.0:
            mod = mod * dropout_factor(dropout_seed, (b, h, tq, bk),
                                       dropout_rate, dev, key_offset=j0)
        acc = acc + _round_to(mod, cdt) @ vh[:, :, j0:j0 + bk]
    return _merge(acc).to(cdt)


def mau_blocked_forward(q, k, v, t, key_mask, intervals, onehot, wd, bd, w,
                        scaling, *, causal: bool = False,
                        diag_reset: bool = False, dropout_rate: float = 0.0,
                        dropout_seed=None, num_heads: int,
                        block_k: int = 512) -> BlockedForward:
    """The whole blocked forward with its intermediates.

    q: (B, Tq, C); k/v/t: (B, Tk, C), C = num_heads*dh; key_mask: (B, Tk),
    nonzero where the key is real; intervals: (B, Tq); onehot: (B, Tk, E);
    wd: (dh+1, E*dh); bd: (E*dh,); w: (E, dh); scaling: (E,);
    dropout_seed: int or int64 scalar tensor, needed when dropout_rate > 0.
    ``block_k`` need not divide Tk."""
    m, l, su = stats_reference(q, k, t, key_mask, causal=causal,
                               num_heads=num_heads, block_k=block_k)
    lam = intensity_reference(su, intervals, wd, bd, w, scaling)
    out = output_reference(q, k, v, key_mask, onehot, lam, m, l,
                           causal=causal, diag_reset=diag_reset,
                           dropout_rate=dropout_rate,
                           dropout_seed=dropout_seed, num_heads=num_heads,
                           block_k=block_k)
    return BlockedForward(out, lam, m, l, su)


def mau_blocked(q, k, v, t, key_mask, intervals, onehot, wd, bd, w, scaling,
                causal: bool = False, diag_reset: bool = False,
                dropout_rate: float = 0.0, *, num_heads: int,
                dropout_seed=None, block_k: int = 512):
    """(out (B, Tq, C) in q's dtype, mark_intensity (B, H, Tq, E) fp32):
    ``mau_blocked_forward`` without the intermediates, with the argument
    order of ``mau_attention``."""
    res = mau_blocked_forward(q, k, v, t, key_mask, intervals, onehot, wd, bd,
                              w, scaling, causal=causal, diag_reset=diag_reset,
                              dropout_rate=dropout_rate,
                              dropout_seed=dropout_seed, num_heads=num_heads,
                              block_k=block_k)
    return res.out, res.lam
