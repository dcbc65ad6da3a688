"""Fused MAU/BiMAU self-modulating attention, forward and backward (port of
``easydgl_tpu.kernels.mau_attention``).

The whole chain after the Q/K/V/T projections, on the natural (B, T, C)
layout (head h in channels [h*dh, (h+1)*dh), reference sequential.py:39-41):

    logits = QK^T / sqrt(dh) -> key/causal mask -> softmax
    seq_units = probs @ T
    z = [seq_units | interval] @ Wd + bd; sig = sigmoid(z)
    raw[e] = sum_d sig[e*dh+d] * w[e, d]
    lam = s * softplus(raw / s), s = exp(scaling)
    intensity_qk = lam @ onehot^T  (BiMAU: := 1 at col == qpos)
    out = dropout(intensity_qk * probs) @ V

``mau_attention`` dispatches on where its tensors lie. CPU tensors take
``mau_attention_reference``, the plain PyTorch version, and autograd
differentiates it. CUDA tensors launch the hand-written kernels (or raise):
``csrc/mau_attention_fwd.cu`` forward (in bf16 the attention side, the
intensity head over the rows of every head at once, ``csrc/intensity_head.cuh``,
and the modulation, with ``fused_fwd_workspaces`` between them; in fp32 one
kernel) and, under autograd, ``csrc/mau_attention_bwd.cu`` backward, through
``_MauAttention``.
``mau_attention_bwd`` is the backward's wrapper and
``mau_attention_bwd_reference`` its plain version. Each kernel launch adds
one to ``mau_attention.launches`` (forward) or ``mau_attention_bwd.launches``.

Dropout draws its bits from Philox4x32-10 (``philox4x32_10``, and the same
generator in ``csrc/common.cuh``): entry (b, h, i, j) of the modulated probs
is kept where the first output word of counter (j, i, h, b) under key
(seed mod 2^32, seed >> 32) is below min(floor((1-p) 2^32), 2^32 - 1), and
scaled by 1/(1-p). The mask is a pure function of the seed and the index, so
the forward, the backward and the plain version draw the same one.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from easydgl_tpu_torch.kernels import build

NEG = -(2.0 ** 32) + 1.0   # the reference's mask value
KERNEL_TK_MAX = 128        # longest key sequence the kernels take
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
KERNEL_SMEM_MAX = 232448   # bytes of shared memory one block may use
BWD_ROWS_PER_CHUNK = 2048  # rows of each dWd block (mau_bwd_weights, fp32)
INT_COLS = 128             # Wd columns of a mau_bwd_int_tc block
INT_WAVES = 8              # waves of mau_bwd_int_tc blocks (int_plan)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


# ---------------------------------------------------------------- dropout


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of a * b for a < 2^32 and int64 b < 2^32,
    without overflowing int64: b is split into 16-bit halves."""
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 (Salmon et al., SC'11; the Random123 constants) on
    int64 tensors holding 32-bit values; returns the four output words."""
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_threshold(rate: float) -> int:
    """Keep threshold on a uint32 draw; clamped so rate 0 keeps all."""
    return min(int((1.0 - rate) * 2.0 ** 32), 2 ** 32 - 1)


def dropout_factor(seed, shape, rate: float, device,
                   key_offset: int = 0) -> torch.Tensor:
    """(B, H, Tq, Tk) fp32 keep factors, 1/(1-rate) or 0, of the attention
    dropout. ``seed``: int or int64 scalar tensor. Row i of the mask is
    query row i of the call (not its original position); column j is key
    ``key_offset + j``, so a block of keys draws the bits of its global key
    indices and a blocked schedule draws the mask of the whole call."""
    b, h, tq, tk = shape
    seed = torch.as_tensor(seed, dtype=torch.int64, device=device)
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)  # noqa: E731
    c3 = ar(b)[:, None, None, None]
    c2 = ar(h)[None, :, None, None]
    c1 = ar(tq)[None, None, :, None]
    c0 = ar(tk)[None, None, None, :] + key_offset
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    bits = philox4x32_10(c0, c1, c2, c3, k0, k1)[0]
    keep = bits < dropout_threshold(rate)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32,
                         device=device)
    return torch.where(keep, scale, torch.zeros((), device=device))


# ---------------------------------------------------------------- plain


def _round_to(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Round fp32 values to ``dt``'s precision, keeping them fp32."""
    return x.to(dt).float() if dt != torch.float32 else x


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    b, t, c = x.shape
    return x.float().reshape(b, t, h, c // h).permute(0, 2, 1, 3)


def _merge(x: torch.Tensor) -> torch.Tensor:
    b, h, t, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, t, h * d)


def _chain(q, k, v, t, key_mask, intervals, onehot, wd, bd, w, scaling, *,
           causal, diag_reset, dropout_rate, dropout_seed, num_heads, qpos):
    """The plain chain, every intermediate the backward needs."""
    cdt = q.dtype
    r = lambda x: _round_to(x, cdt)  # noqa: E731
    b, tq, _ = q.shape
    tk = k.shape[1]
    e, dh = w.shape
    h = num_heads
    dev = q.device
    qh, kh, vh, th = (_heads(x, h) for x in (q, k, v, t))
    if qpos is None:
        qpos = torch.arange(tq, device=dev)[None].expand(b, tq)
    qpos = qpos.long()
    kpos = torch.arange(tk, device=dev)
    s = (qh @ kh.transpose(-1, -2)) * (1.0 / dh ** 0.5)
    valid = (key_mask[:, None, None, :] != 0).expand(b, h, tq, tk)
    if causal:
        valid = valid & (kpos[None, None, None, :] <= qpos[:, None, :, None])
    s = torch.where(valid, s, NEG)
    probs = torch.softmax(s, dim=-1)
    seq_units = r(probs) @ th                                # (B, H, Tq, dh)
    iv = intervals.float()[:, None, :, None].expand(b, h, tq, 1)
    x = r(torch.cat([seq_units, iv], dim=-1))
    wdr = r(wd.float())
    sig = r(torch.sigmoid(x @ wdr + bd.float()))             # (B, H, Tq, E*dh)
    wr = r(w.float())
    raw = (sig.reshape(b, h, tq, e, dh) * wr).sum(-1)        # (B, H, Tq, E)
    sc = torch.exp(scaling.float())
    lam = sc * torch.logaddexp(raw / sc, torch.zeros((), device=dev))
    iqk = lam @ onehot.float().transpose(1, 2)[:, None]
    is_diag = None
    if diag_reset:
        is_diag = kpos[None, None, None, :] == qpos[:, None, :, None]
        iqk = torch.where(is_diag, 1.0, iqk)
    modulated = iqk * probs
    drop = None
    if dropout_rate > 0.0:
        if dropout_seed is None:
            raise ValueError("mau_attention: dropout_rate > 0 needs a seed")
        drop = dropout_factor(dropout_seed, (b, h, tq, tk), dropout_rate, dev)
        modulated = modulated * drop
    out = r(modulated) @ vh                                  # (B, H, Tq, dh)
    return dict(qh=qh, kh=kh, vh=vh, th=th, probs=probs, valid=valid, x=x,
                wdr=wdr, sig=sig, wr=wr, raw=raw, sc=sc, lam=lam, iqk=iqk,
                is_diag=is_diag, drop=drop, out=out)


def mau_attention_reference(q, k, v, t, key_mask, intervals, onehot,
                            wd, bd, w, scaling, *, causal: bool = False,
                            diag_reset: bool = False,
                            dropout_rate: float = 0.0, dropout_seed=None,
                            num_heads: int,
                            qpos: Optional[torch.Tensor] = None):
    """Plain PyTorch version, materialized (the chain of the JAX package's
    nn/temporal.py:687-712), with the kernel's argument contract.

    The compute dtype is q's dtype. In bf16 the operands of each product are
    rounded to bf16 exactly where the kernel rounds them (probs before @T,
    [seq_units | interval], Wd and w, the sigmoid, the modulated probs
    before @V) and every sum is fp32 — the precision contract of the TPU
    kernel (mau_attention.py:247-270). Differentiable by autograd."""
    c = _chain(q, k, v, t, key_mask, intervals, onehot, wd, bd, w, scaling,
               causal=causal, diag_reset=diag_reset,
               dropout_rate=dropout_rate, dropout_seed=dropout_seed,
               num_heads=num_heads, qpos=qpos)
    return _merge(c["out"]).to(q.dtype), c["lam"]


@torch.no_grad()
def mau_attention_bwd_reference(q, k, v, t, key_mask, intervals, onehot,
                                wd, bd, w, scaling, g_out, g_lam, *,
                                causal: bool = False,
                                diag_reset: bool = False,
                                dropout_rate: float = 0.0, dropout_seed=None,
                                num_heads: int,
                                qpos: Optional[torch.Tensor] = None):
    """Plain version of the backward, written out (the TPU kernel's
    ``_bwd_kernel``, mau_attention.py:406-521) with its bf16 rounding points:
    the (rows, E*dh) intermediates dsw, dsig, dz are in the compute dtype,
    the product operands (g_out, the modulated probs, x, Wd, dseq, dlogit)
    are rounded to it, sums are fp32. Returns (dq, dk, dv, dt) in q's dtype
    and (dWd, dbd, dw, dscaling) in fp32."""
    cdt = q.dtype
    r = lambda x: _round_to(x, cdt)  # noqa: E731
    c = _chain(q, k, v, t, key_mask, intervals, onehot, wd, bd, w, scaling,
               causal=causal, diag_reset=diag_reset,
               dropout_rate=dropout_rate, dropout_seed=dropout_seed,
               num_heads=num_heads, qpos=qpos)
    b, tq, _ = q.shape
    e, dh = w.shape
    h = num_heads
    probs, iqk, drop, sig, x = c["probs"], c["iqk"], c["drop"], c["sig"], c["x"]
    go = r(_heads(g_out, h))
    modulated = iqk * probs
    if drop is not None:
        modulated = modulated * drop
    dv = r(modulated).transpose(-1, -2) @ go
    dmod = go @ c["vh"].transpose(-1, -2)
    if drop is not None:
        dmod = dmod * drop
    dprobs = dmod * iqk
    dint = dmod * probs
    if c["is_diag"] is not None:
        dint = torch.where(c["is_diag"], 0.0, dint)
    dlam = dint @ onehot.float()[:, None] + g_lam.float()
    xr = c["raw"] / c["sc"]
    sr = torch.sigmoid(xr)
    draw = dlam * sr
    softplus = torch.logaddexp(xr, torch.zeros((), device=q.device))
    dsc = (dlam * (softplus - sr * xr) * c["sc"]).sum((0, 1, 2))
    dsw = r(draw)[..., :, None].expand(b, h, tq, e, dh).reshape(
        b, h, tq, e * dh)
    dw = r(dsw * sig).sum((0, 1, 2)).reshape(e, dh)
    dsig = r(dsw * c["wr"].reshape(e * dh))
    dz = r(r(dsig * sig) * r(1.0 - sig))
    dx = dz @ c["wdr"].t()
    dwd = torch.einsum("bhqc,bhqn->cn", x, dz)
    dbd = dz.sum((0, 1, 2))
    dseq = r(dx[..., :dh])
    dprobs = dprobs + dseq @ c["th"].transpose(-1, -2)
    dt = r(probs).transpose(-1, -2) @ dseq
    dlogit = probs * (dprobs - (dprobs * probs).sum(-1, keepdim=True))
    dlogit = r(torch.where(c["valid"], dlogit, 0.0) * (1.0 / dh ** 0.5))
    dq = dlogit @ c["kh"]
    dk = dlogit.transpose(-1, -2) @ c["qh"]
    return (_merge(dq).to(cdt), _merge(dk).to(cdt), _merge(dv).to(cdt),
            _merge(dt).to(cdt), dwd, dbd, dw, dsc)


# ---------------------------------------------------------------- dispatch


def mau_attention(q, k, v, t, key_mask, intervals, onehot, wd, bd, w,
                  scaling, causal: bool = False, diag_reset: bool = False,
                  dropout_rate: float = 0.0, *, num_heads: int,
                  qpos: Optional[torch.Tensor] = None, dropout_seed=None):
    """Fused self-modulating attention (natural-layout wire format).

    q: (B, Tq, C); k/v/t: (B, Tk, C), C = num_heads*dh; key_mask: (B, Tk),
    nonzero where the key is real; intervals: (B, Tq); onehot: (B, Tk, E);
    wd: (dh+1, E*dh); bd: (E*dh,); w: (E, dh); scaling: (E,); qpos: (B, Tq)
    original positions of the query rows (default iota; the gathered case
    passes the prediction positions with Tq < Tk); dropout_seed: int or
    int64 scalar tensor, needed when dropout_rate > 0.
    Returns (out (B, Tq, C) in q.dtype, mark_intensity (B, H, Tq, E) fp32).

    CPU tensors take the plain version (differentiable by autograd); CUDA
    tensors launch the kernels or raise — the forward, and the backward
    when autograd asks for it."""
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("mau_attention: dropout_rate > 0 needs dropout_seed")
    if not _on_card("mau_attention", q, k, v, t):
        return mau_attention_reference(
            q, k, v, t, key_mask, intervals, onehot, wd, bd, w, scaling,
            causal=causal, diag_reset=diag_reset, dropout_rate=dropout_rate,
            dropout_seed=dropout_seed, num_heads=num_heads, qpos=qpos)
    seed = _seed_tensor(dropout_seed, dropout_rate, q.device)
    if differentiable(q, k, v, t, wd, bd, w, scaling):
        return _MauAttention.apply(q, k, v, t, key_mask, intervals, onehot,
                                   wd, bd, w, scaling, qpos, seed, causal,
                                   diag_reset, dropout_rate, num_heads)
    out, lam, _ = _launch_fwd(q, k, v, t, key_mask, intervals, onehot, wd,
                              bd, w, scaling, causal, diag_reset, num_heads,
                              qpos, seed, dropout_rate, want_raw=False)
    return out, lam


mau_attention.launches = 0


def mau_attention_bwd(q, k, v, t, key_mask, intervals, onehot, wd, bd, w,
                      scaling, raw, g_out, g_lam, *, causal: bool,
                      diag_reset: bool, dropout_rate: float, dropout_seed,
                      num_heads: int, qpos: Optional[torch.Tensor] = None):
    """The backward: (dq, dk, dv, dt) in q's dtype and (dWd, dbd, dw,
    dscaling) in fp32. ``raw``: the forward's residual (B, H, Tq, E) fp32
    (the CUDA kernel reads it; the plain version recomputes it). CPU
    tensors take ``mau_attention_bwd_reference``; CUDA tensors launch the
    kernel or raise."""
    if not _on_card("mau_attention_bwd", q, k, v, t):
        return mau_attention_bwd_reference(
            q, k, v, t, key_mask, intervals, onehot, wd, bd, w, scaling,
            g_out, g_lam, causal=causal, diag_reset=diag_reset,
            dropout_rate=dropout_rate, dropout_seed=dropout_seed,
            num_heads=num_heads, qpos=qpos)
    seed = _seed_tensor(dropout_seed, dropout_rate, q.device)
    return _launch_bwd(q, k, v, t, key_mask, intervals, onehot, wd, bd, w,
                       scaling, raw, g_out, g_lam, causal, diag_reset,
                       num_heads, qpos, seed, dropout_rate)


mau_attention_bwd.launches = 0


class _MauAttention(torch.autograd.Function):
    """Forward kernel (with the raw residual) and backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, t, key_mask, intervals, onehot, wd, bd, w,
                scaling, qpos, seed, causal, diag_reset, rate, num_heads):
        out, lam, raw = _launch_fwd(q, k, v, t, key_mask, intervals, onehot,
                                    wd, bd, w, scaling, causal, diag_reset,
                                    num_heads, qpos, seed, rate,
                                    want_raw=True)
        ctx.save_for_backward(q, k, v, t, key_mask, intervals, onehot, wd,
                              bd, w, scaling, raw)
        ctx.qpos, ctx.seed = qpos, seed
        ctx.cfg = (causal, diag_reset, rate, num_heads)
        return out, lam

    @staticmethod
    def backward(ctx, g_out, g_lam):
        (q, k, v, t, key_mask, intervals, onehot, wd, bd, w, scaling,
         raw) = ctx.saved_tensors
        causal, diag_reset, rate, num_heads = ctx.cfg
        dq, dk, dv, dt, dwd, dbd, dw, dsc = _launch_bwd(
            q, k, v, t, key_mask, intervals, onehot, wd, bd, w, scaling, raw,
            g_out, g_lam, causal, diag_reset, num_heads, ctx.qpos, ctx.seed,
            rate)
        return (dq, dk, dv, dt, None, None, None, dwd.to(wd.dtype),
                dbd.to(bd.dtype), dw.to(w.dtype), dsc.to(scaling.dtype),
                None, None, None, None, None, None)


# ---------------------------------------------------------------- launch


def _seed_tensor(seed, rate: float, dev) -> Optional[torch.Tensor]:
    """The dropout seed as an int64 device scalar (the kernels read it from
    device memory, so a seed drawn on the device costs no host sync), or
    None when there is no dropout."""
    if rate <= 0.0:
        return None
    return torch.as_tensor(seed, dtype=torch.int64).to(dev).reshape(())


def fused_fwd_workspaces(b: int, h: int, tq: int, tk: int, dh: int, e: int,
                         dev):
    """The bf16 forward's scratch, each written before it is read: probs
    (B*H, Tq*Tk rounded up to 4) fp32 from the attention side for the
    modulation, each (b, h)'s (Tq, Tk) on a 16-byte boundary; x
    (B*H*Tq, dh) bf16, the rounded seq_units rows of every head, for the
    intensity head; Wd's seq_units lanes as bf16 tiles (dh, E*dh); and the
    rounded interval lane and w of Wd (2, E*dh) fp32."""
    edh = e * dh
    return dict(
        probs=torch.empty((b * h, -(-tq * tk // 4) * 4), dtype=torch.float32,
                          device=dev),
        x=torch.empty((b * h * tq, dh), dtype=torch.bfloat16, device=dev),
        wd=torch.empty((dh, edh), dtype=torch.bfloat16, device=dev),
        side=torch.empty((2, edh), dtype=torch.float32, device=dev))


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"mau_attention kernel: {msg}")


def _rows16(x: torch.Tensor) -> torch.Tensor:
    """x where its rows start on 16-byte boundaries, as the bf16 kernels'
    vector loads need, else a contiguous copy (C is a multiple of 8)."""
    if x.dtype == torch.bfloat16 and (x.data_ptr() % 16 or x.stride(0) % 8
                                      or x.stride(1) % 8):
        return x.contiguous()
    return x


def _bind(lib, name, argtypes):
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _LL, _I32, _U32, _F32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                             ctypes.c_uint, ctypes.c_float)


def _fwd_lib() -> ctypes.CDLL:
    lib = build.load("mau_attention_fwd")
    _bind(lib, "mau_attention_fwd",
          [_P, _LL, _LL] * 4 + [_P] * 12 + [_U32, _F32] + [_P] * 4
          + [_I32] * 8 + [_F32, _I32, _P])
    lib.mau_attention_fwd_smem_bytes.argtypes = [_I32] * 5
    lib.mau_attention_fwd_smem_bytes.restype = ctypes.c_size_t
    lib.mau_cuda_error_string.argtypes = [_I32]
    lib.mau_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("mau_attention_bwd")
    _bind(lib, "mau_attention_bwd",
          [_P, _LL, _LL] * 5 + [_P] * 12 + [_U32, _F32] + [_P] * 17
          + [_I32] * 8 + [_F32] + [_I32] * 5 + [_P])
    lib.mau_attention_bwd_smem_bytes.argtypes = [_I32] * 5
    lib.mau_attention_bwd_smem_bytes.restype = ctypes.c_size_t
    lib.mau_attention_bwd_tensor_cores.argtypes = [_I32, _I32]
    lib.mau_attention_bwd_tensor_cores.restype = ctypes.c_int
    return lib


def _checked_inputs(q, k, v, t, key_mask, intervals, onehot, wd, bd, w,
                    scaling, num_heads, qpos):
    """Validates the kernels' contract; returns the fp32/int32 contiguous
    small tensors (key mask, intervals, one-hot, qpos) on q's device."""
    dev, cdt = q.device, q.dtype
    _check(cdt in _DTYPE_CODE, f"q dtype {cdt} not float32/bfloat16")
    b, tq, c = q.shape
    tk = k.shape[1]
    e, dh = w.shape
    for name, x in (("k", k), ("v", v), ("t", t)):
        _check(x.dtype == cdt, f"{name} dtype {x.dtype} != q dtype {cdt}")
        _check(tuple(x.shape) == (b, tk, c), f"{name} shape {tuple(x.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v), ("t", t)):
        _check(x.stride(2) == 1, f"{name} channels not contiguous")
    _check(c == num_heads * dh, f"C={c} != num_heads*dh={num_heads}*{dh}")
    _check(dh in KERNEL_HEAD_DIMS, f"head dim {dh} not in {KERNEL_HEAD_DIMS}")
    _check(1 <= tq <= tk <= KERNEL_TK_MAX,
           f"needs 1 <= Tq={tq} <= Tk={tk} <= {KERNEL_TK_MAX}")
    _check(tuple(key_mask.shape) == (b, tk), "key_mask shape")
    _check(tuple(intervals.shape) == (b, tq), "intervals shape")
    _check(tuple(onehot.shape) == (b, tk, e), "onehot shape")
    _check(tuple(wd.shape) == (dh + 1, e * dh), "wd shape")
    _check(tuple(bd.shape) == (e * dh,), "bd shape")
    _check(tuple(scaling.shape) == (e,), "scaling shape")
    if qpos is None:
        qpos = torch.arange(tq, device=dev, dtype=torch.int32)[None]
        qpos = qpos.expand(b, tq)
    _check(tuple(qpos.shape) == (b, tq), "qpos shape")
    km, iv, oh = (x.detach().to(device=dev, dtype=torch.float32).contiguous()
                  for x in (key_mask, intervals, onehot))
    qp = qpos.to(device=dev, dtype=torch.int32).contiguous()
    for name, x in (("q", q), ("k", k), ("v", v), ("t", t), ("key_mask", km),
                    ("intervals", iv), ("onehot", oh), ("qpos", qp)):
        _check(x.device == dev, f"{name} on {x.device}, q on {dev}")
    return km, iv, oh, qp


def _f32(x, dev):
    return x.detach().to(device=dev, dtype=torch.float32).contiguous()


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _drop_args(seed, rate):
    if seed is None:
        return None, 0, 0.0
    return seed.data_ptr(), dropout_threshold(rate), 1.0 / (1.0 - rate)


def differentiable(*tensors) -> bool:
    """True where autograd will ask for a gradient of these tensors."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in tensors)


def _on_card(name: str, *tensors, entry: Optional[str] = None) -> bool:
    """The device rule of the one-kernel wrappers: False for CPU tensors
    (the caller takes the plain version), True for CUDA tensors (the caller
    launches its kernel). Raises on any other device, on mixed devices and,
    where ``entry`` names the differentiable entry point, where autograd
    would need a gradient of this one kernel, which has none of its own."""
    dev = tensors[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if entry is not None and differentiable(*tensors):
        raise RuntimeError(f"{name}: one kernel has no gradient of its own; "
                           f"differentiate {entry}")
    for x in tensors:
        if x.device != dev:
            raise ValueError(f"{name}: a tensor on {x.device}, the first "
                             f"on {dev}")
    return True


def _raise_on(rc: int, what: str, error_string) -> None:
    """Raises on a kernel's nonzero return code, with its library's text
    (``error_string``: the library's ``*_error_string`` function)."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + error_string(rc).decode())


def _launch_fwd(q, k, v, t, key_mask, intervals, onehot, wd, bd, w, scaling,
                causal, diag_reset, num_heads, qpos, seed, rate, *,
                want_raw: bool):
    """The forward kernels, by dtype: bf16 runs the attention side, the
    intensity head over every (b, h, i) row and the modulation (three
    kernels and the head's rounding kernel, on ``fused_fwd_workspaces``);
    fp32 runs the one fused kernel. Both take every shape the checks admit.
    Returns (out, lam, raw or None)."""
    km, iv, oh, qp = _checked_inputs(q, k, v, t, key_mask, intervals, onehot,
                                     wd, bd, w, scaling, num_heads, qpos)
    dev, cdt = q.device, q.dtype
    b, tq, c = q.shape
    tk = k.shape[1]
    e, dh = w.shape
    q, k, v, t = (_rows16(x) for x in (q, k, v, t))
    wdf, bdf, wf, scf = (_f32(x, dev) for x in (wd, bd, w, scaling))
    for name, x in (("wd", wdf), ("w", wf), ("bd", bdf)):
        _check(x.data_ptr() % 16 == 0, f"{name} not 16-byte aligned")
    lib = _fwd_lib()
    smem = lib.mau_attention_fwd_smem_bytes(tq, tk, dh, e, _DTYPE_CODE[cdt])
    _check(smem <= KERNEL_SMEM_MAX,
           f"needs {smem} bytes of shared memory (Tq={tq}, Tk={tk}, dh={dh},"
           f" E={e}); the limit is {KERNEL_SMEM_MAX}")
    out = torch.empty((b, tq, c), dtype=cdt, device=dev)
    lam = torch.empty((b, num_heads, tq, e), dtype=torch.float32, device=dev)
    raw = (torch.empty((b, num_heads, tq, e), dtype=torch.float32, device=dev)
           if want_raw else None)
    ws = (fused_fwd_workspaces(b, num_heads, tq, tk, dh, e, dev)
          if cdt == torch.bfloat16 else {})
    seed_ptr, thresh, dscale = _drop_args(seed, rate)
    with torch.cuda.device(dev):
        rc = lib.mau_attention_fwd(
            q.data_ptr(), q.stride(0), q.stride(1),
            k.data_ptr(), k.stride(0), k.stride(1),
            v.data_ptr(), v.stride(0), v.stride(1),
            t.data_ptr(), t.stride(0), t.stride(1),
            km.data_ptr(), iv.data_ptr(), qp.data_ptr(), oh.data_ptr(),
            wdf.data_ptr(), bdf.data_ptr(), wf.data_ptr(), scf.data_ptr(),
            out.data_ptr(), lam.data_ptr(),
            None if raw is None else raw.data_ptr(), seed_ptr, thresh,
            dscale, *(ws[n].data_ptr() if ws else None
                      for n in ("probs", "x", "wd", "side")),
            b, tq, tk, num_heads, dh, e, int(causal),
            int(diag_reset), 1.0 / dh ** 0.5, _DTYPE_CODE[cdt], _stream(dev))
    _raise_on(rc, "mau_attention", lib.mau_cuda_error_string)
    mau_attention.launches += 1
    return out, lam, raw


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def bwd_smem_bytes(qc: int, tk: int, dh: int, e: int,
                   tensor_cores: bool) -> int:
    """Dynamic shared memory of the backward's attention kernel
    (``mau_bwd_attn``) for ``qc`` query rows a block, in bytes: on the
    tensor-core path (bf16) the larger of kPre's and kPost's (kPre's), else
    kFull's. Mirrors ``layout`` in ``csrc/mau_attention_bwd.cu`` (the
    library's ``mau_attention_bwd_smem_bytes``, which the card tests hold
    equal to it)."""
    ldh, lde = dh + 4, _round4(e) + 4

    def mode_bytes(mode):
        post = mode == "post"
        k = _round4(tk * ldh)
        v = 0 if post or (mode == "pre" and qc <= ldh) else _round4(max(
            tk * ldh, qc * tk, (dh + 1) * 65 + qc * 65 if mode == "full"
            else 0))
        q = _round4(qc * ldh)
        lam = 0 if post else _round4(qc * lde)
        oh = _round4(qc * ldh if post else max(tk * lde, qc * ldh))
        return 4 * (2 * k + v + q + (0 if post else q) + 3 * _round4(qc * tk)
                    + 2 * lam + oh + _round4(e) + _round4(tk + 2 * qc))

    if tensor_cores:
        return max(mode_bytes("pre"), mode_bytes("post"))
    return mode_bytes("full")


def _bwd_query_chunk(tq, tk, dh, e, tensor_cores: bool) -> int:
    """Query rows per block of the backward's row kernel: all of them when
    Tq <= 32, else the largest of 32/16/8 whose modes (``bwd_smem_bytes``)
    fit shared memory: 16 at Tk = 128, dh = 128 in bf16."""
    for qc in ((tq,) if tq <= 32 else (32, 16, 8)):
        if bwd_smem_bytes(qc, tk, dh, e, tensor_cores) <= KERNEL_SMEM_MAX:
            return qc
    raise ValueError(f"mau_attention_bwd kernel: Tq={tq}, Tk={tk}, dh={dh},"
                     f" E={e} does not fit {KERNEL_SMEM_MAX} bytes of shared"
                     " memory")


def int_plan(rows: int, edh: int, sms: int):
    """(column blocks, row chunks, row tiles a chunk) of the bf16
    intensity-head kernel (``mau_bwd_int_tc``): its grid is column blocks
    (128 columns of Wd each) x row chunks, and each block walks its chunk's
    64-row tiles. The chunks are sized so that the grid is about
    ``INT_WAVES`` waves of one block an SM whatever the number of column
    blocks: at the flagship train shape (126,976 rows, E*dh = 4,096) on 132
    SMs, 32 x 33 blocks of 61 tiles. Every tile lies in exactly one chunk;
    no chunk is empty."""
    tiles = -(-rows // 64)
    col_blocks = -(-edh // INT_COLS)
    wanted = max(1, INT_WAVES * sms // col_blocks)
    per = -(-tiles // min(tiles, wanted))
    return col_blocks, -(-tiles // per), per


def int_lanes(dh: int) -> int:
    """Lanes of the tensor-core path's x rows, Wd tiles, dseq^T and dWd^T:
    64 (zero past dh) at dh <= 64, two 64-lane halves at dh = 128."""
    return 64 if dh <= 64 else 128


def int_workspaces(rows: int, tk: int, e: int, dh: int, dev):
    """The tensor-core path's scratch, zeroed where the kernels add into it
    or read what no kernel writes (rows past ``rows``, events past E), with
    XL = ``int_lanes(dh)``: x (rows_pad, XL) bf16, rnd(draw)^T (E rounded
    up to 8, rows_pad) bf16, probs and dprobs (rows, Tk) fp32, dseq^T (XL,
    rows_pad) fp32, dWd^T (E*dh rounded up to 128, XL) fp32 and its
    interval lane (E*dh,) fp32; rows_pad = rows rounded up to 64."""
    rows_pad = -(-rows // 64) * 64
    xl = int_lanes(dh)
    f32 = dict(dtype=torch.float32, device=dev)
    x = torch.empty((rows_pad, xl), dtype=torch.bfloat16, device=dev)
    x[rows:].zero_()
    draw = torch.empty((-(-e // 8) * 8, rows_pad), dtype=torch.bfloat16,
                       device=dev)
    draw[e:].zero_()
    draw[:, rows:].zero_()
    return dict(x=x, draw=draw, probs=torch.empty((rows, tk), **f32),
                dprobs=torch.empty((rows, tk), **f32),
                dseq=torch.zeros((xl, rows_pad), **f32),
                dwd=torch.zeros((-(-e * dh // 128) * 128, xl), **f32),
                dwd_iv=torch.zeros((e * dh,), **f32), rows_pad=rows_pad)


def int_dwd(ws, e: int, dh: int) -> torch.Tensor:
    """dWd (dh+1, E*dh) from the tensor-core path's workspaces: the
    transposed seq_units lanes of ``ws["dwd"]`` and the interval lane."""
    return torch.cat([ws["dwd"][:e * dh, :dh].t(), ws["dwd_iv"][None]])


def _wd_tiles(wd: torch.Tensor, dh: int):
    """bf16 Wd's seq_units lanes as the tensor-core kernel reads them by
    TMA: (``int_lanes(dh)``, E*dh rounded up to 128), zero past dh lanes
    and E*dh columns (the interval lane is read in fp32 by the kernel)."""
    n = wd.shape[1]
    out = torch.zeros((int_lanes(dh), -(-n // 128) * 128),
                      dtype=torch.bfloat16, device=wd.device)
    out[:dh, :n] = wd[:dh].detach().to(torch.bfloat16)
    return out


def _launch_bwd(q, k, v, t, key_mask, intervals, onehot, wd, bd, w, scaling,
                raw, g_out, g_lam, causal, diag_reset, num_heads, qpos, seed,
                rate):
    km, iv, oh, qp = _checked_inputs(q, k, v, t, key_mask, intervals, onehot,
                                     wd, bd, w, scaling, num_heads, qpos)
    dev, cdt = q.device, q.dtype
    b, tq, c = q.shape
    tk = k.shape[1]
    e, dh = w.shape
    go = g_out.to(cdt).contiguous()
    gl = _f32(g_lam, dev)
    _check(tuple(go.shape) == (b, tq, c), "g_out shape")
    _check(tuple(gl.shape) == (b, num_heads, tq, e), "g_lam shape")
    _check(raw is not None and tuple(raw.shape) == (b, num_heads, tq, e)
           and raw.dtype == torch.float32 and raw.is_contiguous(),
           "raw residual (B, H, Tq, E) fp32")
    wdf, bdf, wf, scf = (_f32(x, dev) for x in (wd, bd, w, scaling))
    lib = _bwd_lib()
    tc = bool(lib.mau_attention_bwd_tensor_cores(dh, _DTYPE_CODE[cdt]))
    qc = _bwd_query_chunk(tq, tk, dh, e, tc)
    rows = b * num_heads * tq
    f32 = dict(dtype=torch.float32, device=dev)
    dq = torch.empty((b, tq, c), dtype=cdt, device=dev)
    dk, dv, dt = (torch.empty((b, tk, c), dtype=cdt, device=dev)
                  for _ in range(3))
    accs = ([torch.zeros((b, tk, c), **f32) for _ in range(3)]
            if qc < tq else [None] * 3)
    dsc = torch.zeros((e,), **f32)
    dbd = torch.zeros((e * dh,), **f32)
    dw = torch.zeros((e * dh,), **f32)
    if tc:
        ws = int_workspaces(rows, tk, e, dh, dev)
        wdt = _wd_tiles(wdf, dh)
        x_out, draw_out, dwd = ws["x"], ws["draw"], ws["dwd"]
        extra = (ws["probs"], ws["dprobs"], ws["dseq"])
        tiles_per_chunk = int_plan(
            rows, e * dh,
            torch.cuda.get_device_properties(dev).multi_processor_count)[2]
    else:
        ws, wdt, extra, tiles_per_chunk = dict(rows_pad=0), None, (None,) * 3, 0
        x_out = torch.empty((rows, dh + 1), **f32)
        draw_out = torch.empty((rows, e), **f32)
        dwd = torch.zeros((dh + 1, e * dh), **f32)
    seed_ptr, thresh, dscale = _drop_args(seed, rate)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        rc = lib.mau_attention_bwd(
            q.data_ptr(), q.stride(0), q.stride(1),
            k.data_ptr(), k.stride(0), k.stride(1),
            v.data_ptr(), v.stride(0), v.stride(1),
            t.data_ptr(), t.stride(0), t.stride(1),
            go.data_ptr(), go.stride(0), go.stride(1),
            km.data_ptr(), iv.data_ptr(), qp.data_ptr(), oh.data_ptr(),
            wdf.data_ptr(), bdf.data_ptr(), wf.data_ptr(), scf.data_ptr(),
            ptr(wdt), raw.data_ptr(), gl.data_ptr(), seed_ptr, thresh, dscale,
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dt.data_ptr(),
            *(ptr(a) for a in accs), x_out.data_ptr(), draw_out.data_ptr(),
            *(ptr(a) for a in extra), dsc.data_ptr(), dwd.data_ptr(),
            ptr(ws.get("dwd_iv")), dbd.data_ptr(), dw.data_ptr(),
            b, tq, tk, num_heads, dh, e, int(causal), int(diag_reset),
            1.0 / dh ** 0.5, qc, BWD_ROWS_PER_CHUNK, tiles_per_chunk,
            ws["rows_pad"], _DTYPE_CODE[cdt], _stream(dev))
    _raise_on(rc, "mau_attention_bwd", _fwd_lib().mau_cuda_error_string)
    if accs[0] is not None:
        dk, dv, dt = (a.to(cdt) for a in accs)
    if tc:
        dwd = int_dwd(ws, e, dh)
    mau_attention_bwd.launches += 1
    return dq, dk, dv, dt, dwd, dbd, dw.reshape(e, dh), dsc
