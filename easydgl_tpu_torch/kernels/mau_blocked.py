"""Blocked MAU/BiMAU: the two-sweep long-context schedule and its two-pass
custom backward in plain PyTorch (port of ``easydgl_tpu.kernels.mau_blocked``).

The chain of ``mau_attention`` without any (Tq, Tk) tensor: keys are taken
in blocks of ``block_k`` and every intermediate is O(T * block_k), in the
forward and in the backward.

Forward:

* sweep 1 (``stats_reference``): online softmax stats m and l and the
  exp-weighted T accumulation, seq_units = softmax(S) @ T;
* the Hawkes intensity head (``intensity_reference``) once on seq_units, in
  fp32 — it needs only per-query state, so two sweeps are the least exact
  split;
* sweep 2 (``output_reference``): each probs block is recomputed as
  exp(s - m) / l, never exp(s - lse) (on a fully masked row every logit is
  the finite -2^32+1, whose fp32 ulp of 512 swallows log(T)), modulated by
  lam @ onehot^T (BiMAU: the diagonal := 1), dropped, and @V.

Backward (JAX ``_mau_blocked_bwd``, mau_blocked.py:242-331), split as the
card kernels of ``kernels.mau_streamed`` split it, so that each kernel has
its own plain version:

* ``glam_reference``: pass 1's d(lambda) from the modulation (dV is left
  to ``dkvt_reference``, as the streamed split leaves it);
* ``intensity_vjp_reference``: the fp32 VJP of the intensity head, giving
  d(seq_units) and the head's parameter gradients (the interval's gradient
  is dropped, as JAX's ``None``);
* ``row_correction``: rho = <out, g_out> + <g_su, su> per query row, fp32;
* ``dq_reference`` and ``dkvt_reference``: pass 2's dQ, and dK, dV, dT.

``backward_chain`` runs the five in JAX's order with any set of
implementations (``BackwardOps``): the plain ones here, or the kernels.
``_MauBlocked`` wraps the forward and that backward in an autograd
``Function``; ``mau_blocked`` uses it when a gradient is needed, so the CPU
engine of ``attention_impl="flash"`` trains in O(T * block_k) memory.

Masks follow the reference: real keys that are masked or causally hidden
get the finite -2^32+1, so a row with no visible key is uniform over all
the real keys; the alignment padding of the last key block gets -1e38 and
never counts. Gradients through masked logits are exactly zero.

Layout and precision are ``mau_attention``'s: q/k/v/t on the natural
(B, T, C) layout, queries at positions 0..Tq-1; the compute dtype is q's.
The operands of each block product are rounded to it and summed in fp32
(the JAX package's ``_mm``): the probs before @T, lam before @onehot^T, the
modulated probs before @V; in the backward g_out, g_su, the d(intensity)
block before @onehot, the logits' gradient before @K and @Q (after the
1/sqrt(dh) scale, as the blocked path and not the streamed one applies
it), the modulated probs before @g_out and the probs before @g_su. Logits,
stats, the intensity head and its VJP are fp32.

Dropout draws from the Philox rule of ``mau_attention.dropout_factor`` at
the global key index, so the blocked, the streamed and the fused paths
draw one mask for one seed, in the forward and the backward (the JAX
package's blocked path draws from ``jax.random`` instead).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from easydgl_tpu_torch.kernels.mau_attention import (NEG, _heads, _merge,
                                                     _round_to,
                                                     differentiable,
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


def _visible(kmb, j0, tq, causal):
    """(B, 1, Tq or 1, bk) bool: keys j0..j0+bk-1 that are real, unmasked
    and (causal) not after the query."""
    mask = (kmb > 0)[:, None, None, :]
    if causal:
        kpos = j0 + torch.arange(kmb.shape[1], device=kmb.device)
        qpos = torch.arange(tq, device=kmb.device)
        mask = mask & (kpos[None, None, None, :] <= qpos[None, None, :, None])
    return mask


def _masked_logits(qh, kb, kmb, j0, *, scale, causal, tk):
    """One (B, H, Tq, bk) logits block of keys j0..j0+bk-1: visible keys
    give q.k * scale, real masked or causally hidden keys NEG, alignment
    padding PAD_NEG."""
    bk = kb.shape[2]
    s = (qh @ kb.transpose(-1, -2)) * scale
    kpos = j0 + torch.arange(bk, device=qh.device)
    fill = torch.where(kpos < tk, NEG, PAD_NEG)
    return torch.where(_visible(kmb, j0, qh.shape[2], causal), s, fill)


def _diag(j0, bk, tq, device):
    """(1, 1, Tq, bk) bool: key j0 + c is query row i."""
    kpos = j0 + torch.arange(bk, device=device)
    qpos = torch.arange(tq, device=device)
    return kpos[None, None, None, :] == qpos[None, None, :, None]


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


class _Blocks:
    """What every sweep recomputes per key block, on the natural layout:
    heads, padded keys, the mask, the one-hot in the compute dtype."""

    def __init__(self, q, k, key_mask, onehot, *, num_heads, block_k,
                 causal, others=()):
        self.cdt = q.dtype
        self.b, self.tq, _ = q.shape
        self.tk = k.shape[1]
        self.h = num_heads
        self.bk, self.tkp = _block(block_k, self.tk)
        self.qh = _heads(q, num_heads)
        self.kh = _heads(_pad_keys(k, self.tkp), num_heads)
        self.others = [_heads(_pad_keys(x, self.tkp), num_heads)
                       for x in others]
        self.km = _pad_keys(key_mask.float(), self.tkp)
        self.oh = _round_to(_pad_keys(onehot.float(), self.tkp), self.cdt)
        self.dh = self.qh.shape[-1]
        self.scale = 1.0 / self.dh ** 0.5
        self.causal = causal

    def probs(self, j0, m, l):
        """(visible mask, probs exp(s - m) / l) of keys j0..j0+bk-1."""
        kmb = self.km[:, j0:j0 + self.bk]
        s = _masked_logits(self.qh, self.kh[:, :, j0:j0 + self.bk], kmb, j0,
                           scale=self.scale, causal=self.causal, tk=self.tk)
        return (_visible(kmb, j0, self.tq, self.causal),
                torch.exp(s - m[..., None]) / l[..., None])

    def keep(self, j0, rate, seed):
        """The dropout factors of keys j0..j0+bk-1, or None at rate 0."""
        if rate <= 0.0:
            return None
        return dropout_factor(seed, (self.b, self.h, self.tq, self.bk), rate,
                              self.qh.device, key_offset=j0)

    def iqk(self, j0, lam_r, diag_reset):
        """lam @ onehot^T of keys j0..j0+bk-1; BiMAU: the diagonal := 1."""
        iqk = lam_r @ self.oh[:, None, j0:j0 + self.bk].transpose(-1, -2)
        if diag_reset:
            iqk = torch.where(_diag(j0, self.bk, self.tq, iqk.device), 1.0,
                              iqk)
        return iqk


def _need_seed(rate, seed):
    if rate > 0.0 and seed is None:
        raise ValueError("mau_blocked: dropout_rate > 0 needs dropout_seed")


def output_reference(q, k, v, key_mask, onehot, lam, m, l, *,
                     causal: bool = False, diag_reset: bool = False,
                     dropout_rate: float = 0.0, dropout_seed=None,
                     num_heads: int, block_k: int = 512):
    """Sweep 2: out (B, Tq, C) in q's dtype, from the stats (m, l) and lam
    (B, H, Tq, E). Per key block: p = exp(s - m) / l; iqk = lam @ onehot^T
    with lam rounded to q's dtype, BiMAU's diagonal := 1; the dropped
    modulated probs are rounded to q's dtype before @V."""
    _need_seed(dropout_rate, dropout_seed)
    blk = _Blocks(q, k, key_mask, onehot, num_heads=num_heads,
                  block_k=block_k, causal=causal, others=(v,))
    vh, = blk.others
    lam_r = _round_to(lam.float(), blk.cdt)
    acc = torch.zeros((blk.b, blk.h, blk.tq, blk.dh), device=q.device)
    for j0 in range(0, blk.tkp, blk.bk):
        _, p = blk.probs(j0, m, l)
        mod = blk.iqk(j0, lam_r, diag_reset) * p
        keep = blk.keep(j0, dropout_rate, dropout_seed)
        if keep is not None:
            mod = mod * keep
        acc = acc + _round_to(mod, blk.cdt) @ vh[:, :, j0:j0 + blk.bk]
    return _merge(acc).to(blk.cdt)


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


# ---------------------------------------------------------------- backward


def glam_reference(q, k, v, key_mask, onehot, m, l, g_out, *,
                   causal: bool = False, diag_reset: bool = False,
                   dropout_rate: float = 0.0, dropout_seed=None,
                   num_heads: int, block_k: int = 512):
    """Backward pass 1 (JAX mau_blocked.py:268-288, without dV): the
    modulation's d(lambda), (B, H, Tq, E) fp32. Per key block:
    g_iqk = (g_out @ V^T) * p * keep, zero on BiMAU's diagonal (the
    constant 1, not lambda), rounded to q's dtype before @onehot."""
    _need_seed(dropout_rate, dropout_seed)
    blk = _Blocks(q, k, key_mask, onehot, num_heads=num_heads,
                  block_k=block_k, causal=causal, others=(v,))
    vh, = blk.others
    go = _round_to(_heads(g_out, num_heads), blk.cdt)
    g_lam = torch.zeros((blk.b, blk.h, blk.tq, onehot.shape[-1]),
                        device=q.device)
    for j0 in range(0, blk.tkp, blk.bk):
        _, p = blk.probs(j0, m, l)
        g_iqk = (go @ vh[:, :, j0:j0 + blk.bk].transpose(-1, -2)) * p
        keep = blk.keep(j0, dropout_rate, dropout_seed)
        if keep is not None:
            g_iqk = g_iqk * keep
        if diag_reset:
            g_iqk = torch.where(_diag(j0, blk.bk, blk.tq, q.device), 0.0,
                                g_iqk)
        g_lam = g_lam + _round_to(g_iqk, blk.cdt) @ blk.oh[:, None,
                                                          j0:j0 + blk.bk]
    return g_lam


def intensity_vjp_reference(su, intervals, wd, bd, w, scaling, g_lam):
    """The fp32 VJP of ``intensity_reference`` at g_lam (B, H, Tq, E):
    (g_su (B, H, Tq, dh), gWd (dh+1, E*dh), gbd (E*dh,), gw (E, dh),
    gscaling (E,)), all fp32 (JAX mau_blocked.py:291-297). With
    r = raw / s: g_raw = g_lam sigmoid(r); gscaling = sum g_lam (lam -
    sigmoid(r) raw); g_z = g_raw w sig (1 - sig); gWd = x^T g_z, g_x =
    g_z Wd^T, whose interval lane is dropped."""
    b, h, tq, dh = su.shape
    e = w.shape[0]
    wdf, wf = wd.float(), w.float()
    iv = intervals.float()[:, None, :, None].expand(b, h, tq, 1)
    x = torch.cat([su.float(), iv], dim=-1).reshape(-1, dh + 1)
    sig = torch.sigmoid(x @ wdf + bd.float()).reshape(-1, e, dh)
    raw = (sig * wf).sum(-1)
    sc = torch.exp(scaling.float())
    r = raw / sc
    sr = torch.sigmoid(r)
    lam = sc * torch.logaddexp(r, torch.zeros((), device=su.device))
    gl = g_lam.float().reshape(-1, e)
    g_raw = gl * sr
    g_sc = (gl * (lam - sr * raw)).sum(0)
    g_w = (g_raw[:, :, None] * sig).sum(0)
    g_z = (g_raw[:, :, None] * wf * sig * (1.0 - sig)).reshape(-1, e * dh)
    g_wd = x.t() @ g_z
    g_bd = g_z.sum(0)
    g_su = (g_z @ wdf[:dh].t()).reshape(b, h, tq, dh)
    return g_su, g_wd, g_bd, g_w, g_sc


def row_correction(out, g_out, su, g_su, num_heads: int):
    """rho = <out, g_out> + <g_su, su> per query row, (B, H, Tq) fp32
    (JAX mau_blocked.py:265, :300): out is the MAU output before the
    residual add, in its compute-dtype rounding; g_su fp32."""
    return ((_heads(out, num_heads) * _heads(g_out, num_heads)).sum(-1)
            + (g_su.float() * su.float()).sum(-1))


def _pass2_block(blk, j0, vh, th, go, gsu_r, lam_r, m, l, rho, *,
                 diag_reset, dropout_rate, dropout_seed):
    """Pass 2's per-block terms: (p, keep, iqk, g_s) with g_s the rounded
    logits' gradient where(visible, p (g_p - rho), 0) / sqrt(dh),
    g_p = (g_out @ V^T) keep iqk + g_su @ T^T."""
    vis, p = blk.probs(j0, m, l)
    sl = slice(j0, j0 + blk.bk)
    iqk = blk.iqk(j0, lam_r, diag_reset)
    keep = blk.keep(j0, dropout_rate, dropout_seed)
    g_mod = go @ vh[:, :, sl].transpose(-1, -2)
    if keep is not None:
        g_mod = g_mod * keep
    g_p = g_mod * iqk + gsu_r @ th[:, :, sl].transpose(-1, -2)
    g_s = torch.where(vis, p * (g_p - rho[..., None]), 0.0) * blk.scale
    return p, keep, iqk, _round_to(g_s, blk.cdt)


def dq_reference(q, k, v, t, key_mask, onehot, lam, m, l, g_out, g_su, rho,
                 *, causal: bool = False, diag_reset: bool = False,
                 dropout_rate: float = 0.0, dropout_seed=None,
                 num_heads: int, block_k: int = 512):
    """Backward pass 2, dQ (B, Tq, C) in q's dtype (JAX
    mau_blocked.py:303-317): sum over key blocks of g_s @ K. g_su
    (B, H, Tq, dh) fp32, rounded to q's dtype here; rho (B, H, Tq) fp32."""
    _need_seed(dropout_rate, dropout_seed)
    blk = _Blocks(q, k, key_mask, onehot, num_heads=num_heads,
                  block_k=block_k, causal=causal, others=(v, t))
    vh, th = blk.others
    go = _round_to(_heads(g_out, num_heads), blk.cdt)
    gsu_r = _round_to(g_su.float(), blk.cdt)
    lam_r = _round_to(lam.float(), blk.cdt)
    dq = torch.zeros((blk.b, blk.h, blk.tq, blk.dh), device=q.device)
    for j0 in range(0, blk.tkp, blk.bk):
        g_s = _pass2_block(blk, j0, vh, th, go, gsu_r, lam_r, m, l, rho,
                           diag_reset=diag_reset, dropout_rate=dropout_rate,
                           dropout_seed=dropout_seed)[3]
        dq = dq + g_s @ blk.kh[:, :, j0:j0 + blk.bk]
    return _merge(dq).to(blk.cdt)


def dkvt_reference(q, k, v, t, key_mask, onehot, lam, m, l, g_out, g_su,
                   rho, *, causal: bool = False, diag_reset: bool = False,
                   dropout_rate: float = 0.0, dropout_seed=None,
                   num_heads: int, block_k: int = 512):
    """Backward pass 2's key side, (dK, dV, dT), each (B, Tk, C) in q's
    dtype (JAX mau_blocked.py:278 and :318-319): per key block
    dK = g_s^T @ Q, dV = rnd(iqk p keep)^T @ g_out, dT = rnd(p)^T @ g_su."""
    _need_seed(dropout_rate, dropout_seed)
    blk = _Blocks(q, k, key_mask, onehot, num_heads=num_heads,
                  block_k=block_k, causal=causal, others=(v, t))
    vh, th = blk.others
    cdt = blk.cdt
    go = _round_to(_heads(g_out, num_heads), cdt)
    gsu_r = _round_to(g_su.float(), cdt)
    lam_r = _round_to(lam.float(), cdt)
    qr = blk.qh
    dk, dv, dt = [], [], []
    for j0 in range(0, blk.tkp, blk.bk):
        p, keep, iqk, g_s = _pass2_block(
            blk, j0, vh, th, go, gsu_r, lam_r, m, l, rho,
            diag_reset=diag_reset, dropout_rate=dropout_rate,
            dropout_seed=dropout_seed)
        mod = iqk * p if keep is None else iqk * p * keep
        dk.append(g_s.transpose(-1, -2) @ qr)
        dv.append(_round_to(mod, cdt).transpose(-1, -2) @ go)
        dt.append(_round_to(p, cdt).transpose(-1, -2) @ gsu_r)
    return tuple(_merge(torch.cat(x, dim=2)[:, :, :blk.tk]).to(cdt)
                 for x in (dk, dv, dt))


class BackwardOps(NamedTuple):
    """One implementation of each backward piece, with the plain
    versions' signatures."""
    glam: Callable
    intensity_vjp: Callable
    dq: Callable
    dkvt: Callable


PLAIN_OPS = BackwardOps(glam_reference, intensity_vjp_reference,
                        dq_reference, dkvt_reference)


class Residuals(NamedTuple):
    """What the forward keeps for the backward (JAX ``res``, :237-238)."""
    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    t: torch.Tensor
    key_mask: torch.Tensor
    intervals: torch.Tensor
    onehot: torch.Tensor
    wd: torch.Tensor
    bd: torch.Tensor
    w: torch.Tensor
    scaling: torch.Tensor
    m: torch.Tensor
    l: torch.Tensor
    su: torch.Tensor
    lam: torch.Tensor
    out: torch.Tensor


def backward_chain(res: Residuals, g_out, g_lam_up, *, ops: BackwardOps,
                   causal: bool, diag_reset: bool, dropout_rate: float,
                   dropout_seed, num_heads: int, block_k: int = 512):
    """The two-pass backward in JAX's order (_mau_streamed_bwd :664-789):
    d(lambda) from the modulation plus ``g_lam_up`` (the cotangent of
    mark_intensity, or None), the intensity head's VJP, rho, dQ, then dK,
    dV, dT. Returns (dq, dk, dv, dt) in q's dtype and (dWd, dbd, dw,
    dscaling) fp32."""
    kw = dict(causal=causal, diag_reset=diag_reset, dropout_rate=dropout_rate,
              dropout_seed=dropout_seed, num_heads=num_heads,
              block_k=block_k)
    r = res
    g_lam = ops.glam(r.q, r.k, r.v, r.key_mask, r.onehot, r.m, r.l, g_out,
                     **kw)
    if g_lam_up is not None:
        g_lam = g_lam + g_lam_up.float()
    g_su, g_wd, g_bd, g_w, g_sc = ops.intensity_vjp(
        r.su, r.intervals, r.wd, r.bd, r.w, r.scaling, g_lam)
    rho = row_correction(r.out, g_out, r.su, g_su, num_heads)
    args = (r.q, r.k, r.v, r.t, r.key_mask, r.onehot, r.lam, r.m, r.l, g_out,
            g_su, rho)
    dq = ops.dq(*args, **kw)
    dk, dv, dt = ops.dkvt(*args, **kw)
    return dq, dk, dv, dt, g_wd, g_bd, g_w, g_sc


def autograd_function(name: str, forward: Callable, ops: BackwardOps):
    """An autograd Function over (q, k, v, t, key_mask, intervals, onehot,
    wd, bd, w, scaling, dropout_seed, (causal, diag_reset, dropout_rate,
    num_heads, block_k)): ``forward`` (``mau_blocked_forward``'s contract,
    returning a ``BlockedForward``) gives (out, lam) and the residuals, the
    backward is ``backward_chain`` on ``ops`` with the same seed."""

    def fwd(ctx, q, k, v, t, key_mask, intervals, onehot, wd, bd, w, scaling,
            seed, cfg):
        causal, diag_reset, rate, num_heads, block_k = cfg
        res = forward(q, k, v, t, key_mask, intervals, onehot, wd, bd, w,
                      scaling, causal=causal, diag_reset=diag_reset,
                      dropout_rate=rate, dropout_seed=seed,
                      num_heads=num_heads, block_k=block_k)
        ctx.save_for_backward(q, k, v, t, key_mask, intervals, onehot, wd, bd,
                              w, scaling, res.m, res.l, res.su, res.lam,
                              res.out)
        ctx.seed, ctx.cfg = seed, cfg
        ctx.set_materialize_grads(False)
        return res.out, res.lam

    @once_differentiable
    def bwd(ctx, g_out, g_lam):
        r = Residuals(*ctx.saved_tensors)
        causal, diag_reset, rate, num_heads, block_k = ctx.cfg
        if g_out is None:
            g_out = torch.zeros_like(r.out)
        dq, dk, dv, dt, g_wd, g_bd, g_w, g_sc = backward_chain(
            r, g_out, g_lam, ops=ops, causal=causal, diag_reset=diag_reset,
            dropout_rate=rate, dropout_seed=ctx.seed, num_heads=num_heads,
            block_k=block_k)
        return (dq, dk, dv, dt, None, None, None, g_wd.to(r.wd.dtype),
                g_bd.to(r.bd.dtype), g_w.to(r.w.dtype),
                g_sc.to(r.scaling.dtype), None, None)

    return type(name, (torch.autograd.Function,),
                {"forward": staticmethod(fwd), "backward": staticmethod(bwd)})


_MauBlocked = autograd_function("_MauBlocked", mau_blocked_forward, PLAIN_OPS)


def mau_blocked(q, k, v, t, key_mask, intervals, onehot, wd, bd, w, scaling,
                causal: bool = False, diag_reset: bool = False,
                dropout_rate: float = 0.0, *, num_heads: int,
                dropout_seed=None, block_k: int = 512):
    """(out (B, Tq, C) in q's dtype, mark_intensity (B, H, Tq, E) fp32):
    ``mau_blocked_forward`` without the intermediates, with the argument
    order of ``mau_attention``. Under autograd it runs ``_MauBlocked``, whose
    backward is ``backward_chain`` on the plain pieces."""
    _need_seed(dropout_rate, dropout_seed)
    if differentiable(q, k, v, t, wd, bd, w, scaling):
        return _MauBlocked.apply(q, k, v, t, key_mask, intervals, onehot, wd,
                                 bd, w, scaling, dropout_seed,
                                 (causal, diag_reset, dropout_rate, num_heads,
                                  block_k))
    res = mau_blocked_forward(q, k, v, t, key_mask, intervals, onehot, wd, bd,
                              w, scaling, causal=causal, diag_reset=diag_reset,
                              dropout_rate=dropout_rate,
                              dropout_seed=dropout_seed, num_heads=num_heads,
                              block_k=block_k)
    return res.out, res.lam
