"""Flash attention, forward and backward (port of
``easydgl_tpu.kernels.flash_attention``).

    out = dropout(softmax(mask(Q K^T * scale))) @ V

q (B, H, Tq, dh), k and v (B, H, Tk, dh), key_mask (B, Tk) (> 0 = visible),
optionally causal (key j visible to query i where j <= i). The semantics are
the TPU kernel's: masked probs are exactly 0, a row with no visible key
outputs 0 (``nn.attention.MultiHeadAttention`` patches such rows), dropout
normalises first and then drops and rescales, and ``lse`` (B, H, Tq) fp32 is
what the backward recomputes the probs from.

Two kernels on the card (``csrc/flash_attention.cu``):

* ``flash_attention_fwd`` (TPU ``_fwd_kernel``): out and lse;
* ``flash_attention_bwd`` (TPU ``_dq_kernel`` and ``_dkv_kernel``): dQ, dK
  and dV in one key-major pass.

Both visit only the key tiles the key mask leaves live
(``flash_live_tiles``), the same (query tile, key tile) pairs
(``flash_visited_tiles``). They take q, k and v of one head width dh in
``KERNEL_FWD_HEAD_DIMS`` / ``KERNEL_BWD_HEAD_DIMS``
(``narrow_kernels``); any other heads — q and k of any width D, v of any
width DV, as TGAT's and TGREC's augmented heads (D = 2,048 and 150) — take
the kernels of ``csrc/flash_wide.cu`` (a forward and a backward, bf16 on
the tensor cores, fp32 on the CUDA cores), which walk the width in chunks,
on widths
zero-padded to multiples of 64 (zero columns add nothing to q . k or
dO . v; the outputs' extra columns are dropped). The same wrappers launch
them and count them.

Each wrapper dispatches on where its tensors lie: CPU tensors take the plain
version (``flash_fwd_reference``, ``flash_bwd_reference``, which is
``flash_dq_reference`` and ``flash_dkv_reference``); CUDA tensors launch the
kernel, adding one to the wrapper's ``launches``, or raise.
``flash_attention`` is the differentiable entry point: under autograd it
runs ``_FlashAttention``, which keeps ``out`` and ``lse`` and whose backward
is delta = rowsum(dO * out) in PyTorch, then the backward wrapper — the
kernel on the card, the plain pieces on the CPU.

Rounding points (bf16 compute dtype; the identity in fp32), as the TPU
kernel: s = (q . k) * scale in fp32; p cast to v's dtype before P @ V, its
row sum l taken undropped; ds cast to k's / q's dtype before dS @ K and
dS^T @ Q, the scale applied after; delta from the rounded, dropped output;
out, dq, dk and dv leave in the input dtype.

Dropout draws one Philox word at counter (j, i, h, b) per entry
(``mau_attention.dropout_factor``), i the query row of the call and j the
key, so the forward, the key-major backward and the plain version draw one
mask whatever their tiles. The TPU kernel seeds its PRNG per block instead,
so its mask cannot be matched (ROADMAP C3).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from easydgl_tpu_torch.kernels import build
from easydgl_tpu_torch.kernels.mau_attention import (_DTYPE_CODE,
                                                     KERNEL_SMEM_MAX, _bind,
                                                     _drop_args, _on_card,
                                                     _raise_on, _round_to,
                                                     _seed_tensor, _stream,
                                                     differentiable,
                                                     dropout_factor)

NEG = -1.0e38   # the masked logit and the running max before a visible key
KERNEL_FWD_HEAD_DIMS = (16, 32, 64, 128)
KERNEL_BWD_HEAD_DIMS = (16, 32, 64)
BF16_TC_HEAD_DIM = 64    # the bf16 kernels' tile width (narrower heads pad)
_FWD, _BWD = range(2)   # as flash_smem_bytes numbers the kernels
TILE = 64                # the kernels' query and key tiles
_P, _LL, _I32, _U32, _F32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                             ctypes.c_uint, ctypes.c_float)


def _wide_lib() -> ctypes.CDLL:
    lib = build.load("flash_wide")
    seq = [_P, _LL, _LL, _LL]
    tail = [_I32] * 7 + [_F32, _I32, _P]
    _bind(lib, "flash_wide_fwd",
          seq * 3 + [_P, _P, _P, _U32, _F32, _P, _P] + tail)
    _bind(lib, "flash_wide_bwd",
          seq * 4 + [_P] * 5 + [_U32, _F32] + [_P] * 3 + tail)
    lib.flash_wide_error_string.argtypes = [_I32]
    lib.flash_wide_error_string.restype = ctypes.c_char_p
    return lib


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    seq = [_P, _LL, _LL, _LL]
    tail = [_I32] * 6 + [_F32, _I32, _P]
    _bind(lib, "flash_fwd",
          seq * 3 + [_P, _P, _P, _U32, _F32] + seq + [_P] + tail)
    _bind(lib, "flash_bwd",
          seq * 4 + [_P] * 5 + [_U32, _F32, _P] + seq * 2 + tail)
    lib.flash_smem_bytes.argtypes = [_I32] * 3
    lib.flash_smem_bytes.restype = ctypes.c_size_t
    lib.flash_error_string.argtypes = [_I32]
    lib.flash_error_string.restype = ctypes.c_char_p
    return lib


# ---------------------------------------------------------------- plain


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return float(scale) if scale is not None else 1.0 / q.shape[-1] ** 0.5


def _need_seed(rate: float, seed):
    if rate > 0.0 and seed is None:
        raise ValueError("flash_attention: dropout_rate > 0 needs a seed")


def _visible(key_mask, b: int, tq: int, tk: int, causal: bool, device):
    """(B, 1, Tq, Tk) bool: key_mask > 0, and j <= i under causal."""
    if key_mask is None:
        vis = torch.ones((b, 1, 1, tk), dtype=torch.bool, device=device)
    else:
        vis = (key_mask > 0)[:, None, None, :]
    if causal:
        tril = torch.ones((tq, tk), dtype=torch.bool, device=device).tril()
        vis = vis & tril
    return vis.expand(b, 1, tq, tk)


def _logits(q, k, scale):
    return (q.float() @ k.float().transpose(-1, -2)) * scale


def _drop(q, k, rate, seed):
    b, h, tq, _ = q.shape
    return dropout_factor(seed, (b, h, tq, k.shape[2]), rate, q.device)


def flash_fwd_reference(q, k, v, key_mask=None, *, causal: bool = False,
                        scale=None, dropout_rate: float = 0.0, seed=None):
    """(out (B, H, Tq, dh) in q's dtype, lse (B, H, Tq) fp32): the forward
    kernel's function, materialised. Rows with no visible key give out 0 and
    lse ~ -1e38."""
    _need_seed(dropout_rate, seed)
    scale = _scale(q, scale)
    b, _, tq, _ = q.shape
    vis = _visible(key_mask, b, tq, k.shape[2], causal, q.device)
    s = torch.where(vis, _logits(q, k, scale), NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(vis, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    if dropout_rate > 0.0:
        p = p * _drop(q, k, dropout_rate, seed)
    acc = _round_to(p, v.dtype) @ v.float()
    out = torch.where(l > 0.0, acc / l.clamp_min(1e-37), 0.0)
    lse = (m + torch.log(l.clamp_min(1e-37)))[..., 0]
    return out.to(q.dtype), lse


def flash_attention_reference(q, k, v, key_mask=None, *, causal: bool = False,
                              scale=None, dropout_rate: float = 0.0,
                              seed=None):
    """The output of ``flash_fwd_reference``; differentiable by autograd."""
    return flash_fwd_reference(q, k, v, key_mask, causal=causal, scale=scale,
                               dropout_rate=dropout_rate, seed=seed)[0]


def flash_delta(dout: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * out) in fp32, (B, H, Tq): the softmax Jacobian's
    row term, on the rounded, dropped output (JAX computes it outside the
    kernels too)."""
    return (dout.float() * out.float()).sum(-1).contiguous()


def _probs_ds(q, k, v, key_mask, dout, lse, delta, causal, scale, rate, seed):
    """(dropped p, ds), fp32 (B, H, Tq, Tk), p recomputed from lse."""
    b, _, tq, _ = q.shape
    vis = _visible(key_mask, b, tq, k.shape[2], causal, q.device)
    p = torch.where(vis, torch.exp(_logits(q, k, scale) - lse[..., None]),
                    0.0)
    dp = dout.float() @ v.float().transpose(-1, -2)
    pd = p
    if rate > 0.0:
        keep = _drop(q, k, rate, seed)
        pd, dp = p * keep, dp * keep
    ds = torch.where(vis, p * (dp - delta[..., None]), 0.0)
    return pd, ds


def flash_live_tiles(key_mask: torch.Tensor) -> torch.Tensor:
    """(B, ceil(Tk / 64)) int32 from the key mask (B, Tk), one code a 64-key
    tile: 0 where every key of the tile is masked or past Tk (a dead tile,
    which no query sees), 2 where all 64 keys are real and visible (a full
    tile), 1 otherwise."""
    b, tk = key_mask.shape
    nkt = -(-tk // TILE)
    vis = torch.nn.functional.pad(key_mask > 0, (0, nkt * TILE - tk))
    vis = vis.view(b, nkt, TILE)
    return (vis.any(-1).int() + vis.all(-1).int()).contiguous()


def flash_visited_tiles(live: torch.Tensor, tq: int,
                        causal: bool) -> torch.Tensor:
    """(B, ceil(Tq / 64), ceil(Tk / 64)) bool: the (query tile, key tile)
    pairs the backward computes, from ``flash_live_tiles``. A dead key tile
    is visited by no query tile; under causal a live one by the query tiles
    from its diagonal on (query tile qt holds a query at or after key tile
    kt's first key where qt >= kt)."""
    b, nkt = live.shape
    nqt = -(-tq // TILE)
    vis = (live > 0)[:, None, :].expand(b, nqt, nkt)
    if causal:
        qt = torch.arange(nqt, device=live.device)[:, None]
        vis = vis & (qt >= torch.arange(nkt, device=live.device)[None])
    return vis


@torch.no_grad()
def flash_bwd_reference(q, k, v, key_mask, dout, lse, delta, *,
                        causal: bool = False, scale=None,
                        dropout_rate: float = 0.0, seed=None):
    """(dQ, dK, dV): ``flash_dq_reference`` and ``flash_dkv_reference``,
    the backward kernel's function."""
    kw = dict(causal=causal, scale=scale, dropout_rate=dropout_rate,
              seed=seed)
    return ((flash_dq_reference(q, k, v, key_mask, dout, lse, delta, **kw),)
            + flash_dkv_reference(q, k, v, key_mask, dout, lse, delta, **kw))


@torch.no_grad()
def flash_dq_reference(q, k, v, key_mask, dout, lse, delta, *,
                       causal: bool = False, scale=None,
                       dropout_rate: float = 0.0, seed=None):
    """dQ (B, H, Tq, dh) in q's dtype from dO (B, H, Tq, dh), lse and delta
    (B, H, Tq): (rnd(ds) @ K) * scale."""
    _need_seed(dropout_rate, seed)
    scale = _scale(q, scale)
    _, ds = _probs_ds(q, k, v, key_mask, dout, lse, delta, causal, scale,
                      dropout_rate, seed)
    return ((_round_to(ds, k.dtype) @ k.float()) * scale).to(q.dtype)


@torch.no_grad()
def flash_dkv_reference(q, k, v, key_mask, dout, lse, delta, *,
                        causal: bool = False, scale=None,
                        dropout_rate: float = 0.0, seed=None):
    """(dK, dV), each (B, H, Tk, dh) in k's / v's dtype: dV = rnd(p keep)^T
    @ dO, dK = (rnd(ds)^T @ Q) * scale."""
    _need_seed(dropout_rate, seed)
    scale = _scale(q, scale)
    pd, ds = _probs_ds(q, k, v, key_mask, dout, lse, delta, causal, scale,
                       dropout_rate, seed)
    dv = _round_to(pd, dout.dtype).transpose(-1, -2) @ dout.float()
    dk = (_round_to(ds, q.dtype).transpose(-1, -2) @ q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------- kernels


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"flash_attention kernel: {msg}")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x where the kernels can read it in place (channels contiguous, rows
    on 16-byte boundaries), else a contiguous copy."""
    it = x.element_size()
    if (x.stride(3) != 1 or x.data_ptr() % 16
            or any(x.stride(d) * it % 16 for d in range(3))):
        return x.contiguous()
    return x


def _seq4(x: torch.Tensor):
    return x.data_ptr(), x.stride(0), x.stride(1), x.stride(2)


def _like_heads(b, h, t, dh, dtype, dev) -> torch.Tensor:
    """An output (B, H, T, dh) laid out as (B, T, H, dh): merging the heads
    back into (B, T, C) is then free."""
    return torch.empty((b, t, h, dh), dtype=dtype,
                       device=dev).permute(0, 2, 1, 3)


def _inputs(name, which, q, k, v, key_mask, dout=None):
    """Checks the operands of kernel ``which``; returns (b, h, tq, tk, dh,
    q, k, v[, dout] as the kernels read them, the key mask in fp32, the
    library)."""
    cdt = q.dtype
    _check(cdt in _DTYPE_CODE, f"{name}: q dtype {cdt} not float32/bfloat16")
    _check(q.dim() == 4, f"{name}: q must be (B, H, Tq, dh)")
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    dh_allowed = KERNEL_FWD_HEAD_DIMS if which == _FWD else \
        KERNEL_BWD_HEAD_DIMS
    _check(dh in dh_allowed, f"{name}: head dim {dh} not in {dh_allowed}")
    seqs = [("k", k), ("v", v)] + ([("dout", dout)] if dout is not None
                                   else [])
    for label, x in seqs:
        _check(x.dtype == cdt, f"{name}: {label} dtype {x.dtype} != {cdt}")
        want = (b, h, tq if label == "dout" else tk, dh)
        _check(tuple(x.shape) == want,
               f"{name}: {label} shape {tuple(x.shape)} != {want}")
    if key_mask is None:
        km = torch.ones((b, tk), dtype=torch.float32, device=q.device)
    else:
        _check(tuple(key_mask.shape) == (b, tk),
               f"{name}: key_mask shape {tuple(key_mask.shape)}")
        km = key_mask.detach().to(torch.float32).contiguous()
    lib = _lib()
    _check(lib.flash_smem_bytes(which, dh, _DTYPE_CODE[cdt])
           <= KERNEL_SMEM_MAX, f"{name}: dh={dh} over the shared memory")
    return (b, h, tq, tk, dh,
            [_aligned(x.detach()) for x in (q, k, v)
             + ((dout,) if dout is not None else ())], km, lib)


def narrow_kernels(which: int, q: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether ``flash_attention.cu``'s kernel ``which`` (``_FWD``,
    ``_BWD``) takes these heads: q, k and v of one width in its head dims.
    Any other heads take the wide kernels (``flash_wide.cu``)."""
    dims = KERNEL_FWD_HEAD_DIMS if which == _FWD else KERNEL_BWD_HEAD_DIMS
    return q.shape[-1] == v.shape[-1] and q.shape[-1] in dims


def _wide_inputs(name, q, k, v, key_mask, dout=None):
    """Checks the wide kernels' operands; returns (b, h, tq, tk, dh, dv,
    q, k, v[, dout] zero-padded to widths of whole 64-column chunks as the
    kernels read them, the key mask in fp32)."""
    cdt = q.dtype
    _check(cdt in _DTYPE_CODE, f"{name}: q dtype {cdt} not float32/bfloat16")
    _check(q.dim() == 4 and v.dim() == 4, f"{name}: q, v must be 4-D")
    b, h, tq, dh = q.shape
    tk, dv = k.shape[2], v.shape[3]
    seqs = [("k", k, (b, h, tk, dh)), ("v", v, (b, h, tk, dv))]
    if dout is not None:
        seqs.append(("dout", dout, (b, h, tq, dv)))
    for label, x, want in seqs:
        _check(x.dtype == cdt, f"{name}: {label} dtype {x.dtype} != {cdt}")
        _check(tuple(x.shape) == want,
               f"{name}: {label} shape {tuple(x.shape)} != {want}")
    if key_mask is None:
        km = torch.ones((b, tk), dtype=torch.float32, device=q.device)
    else:
        _check(tuple(key_mask.shape) == (b, tk),
               f"{name}: key_mask shape {tuple(key_mask.shape)}")
        km = key_mask.detach().to(torch.float32).contiguous()
    dp, dvp = (-(-w // TILE) * TILE for w in (dh, dv))
    padded = [_aligned(x.detach() if w == x.shape[3] else
                       torch.nn.functional.pad(x.detach(),
                                               (0, w - x.shape[3])))
              for x, w in ((q, dp), (k, dp), (v, dvp))
              + (((dout, dvp),) if dout is not None else ())]
    return b, h, tq, tk, dh, dv, padded, km


def _wide_fwd(q, k, v, key_mask, causal, scale, rate, seed):
    """``flash_wide_fwd_tc_kernel`` (bf16) or ``flash_wide_fwd_kernel``
    (fp32): (out (B, H, Tq, dv), lse)."""
    b, h, tq, tk, dh, dv, (qa, ka, va), km = _wide_inputs(
        "flash_attention_fwd", q, k, v, key_mask)
    seed_ptr, thresh, dscale = _drop_args(
        _seed_tensor(seed, rate, q.device), rate)
    live = flash_live_tiles(km)
    out = torch.empty((b, h, tq, va.shape[3]), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    lib = _wide_lib()
    with torch.cuda.device(q.device):
        rc = lib.flash_wide_fwd(*_seq4(qa), *_seq4(ka), *_seq4(va),
                                km.data_ptr(), live.data_ptr(), seed_ptr,
                                thresh, dscale, out.data_ptr(),
                                lse.data_ptr(), b, h, tq, tk, qa.shape[3],
                                va.shape[3], int(causal), _scale(q, scale),
                                _DTYPE_CODE[q.dtype], _stream(q.device))
    _raise_on(rc, "flash_attention_fwd", lib.flash_wide_error_string)
    return out[..., :dv], lse


def _wide_bwd(q, k, v, key_mask, dout, lse, delta, causal, scale, rate,
              seed):
    """``flash_wide_bwd_tc_kernel`` (bf16) or ``flash_wide_bwd_kernel``
    (fp32): (dQ, dK, dV) added by atomics into zeroed fp32 workspaces, cast
    on the way out."""
    b, h, tq, tk, dh, dv, (qa, ka, va, da), km = _wide_inputs(
        "flash_attention_bwd", q, k, v, key_mask, dout=dout)
    lse, delta = _bwd_stats(lse, delta, b, h, tq)
    seed_ptr, thresh, dscale = _drop_args(
        _seed_tensor(seed, rate, q.device), rate)
    live = flash_live_tiles(km)
    f32 = dict(dtype=torch.float32, device=q.device)
    dp, dvp = qa.shape[3], va.shape[3]
    dq = torch.zeros((b, h, tq, dp), **f32)
    dk = torch.zeros((b, h, tk, dp), **f32)
    dvw = torch.zeros((b, h, tk, dvp), **f32)
    lib = _wide_lib()
    with torch.cuda.device(q.device):
        rc = lib.flash_wide_bwd(*_seq4(qa), *_seq4(ka), *_seq4(va),
                                *_seq4(da), km.data_ptr(), live.data_ptr(),
                                lse.data_ptr(), delta.data_ptr(), seed_ptr,
                                thresh, dscale, dq.data_ptr(), dk.data_ptr(),
                                dvw.data_ptr(), b, h, tq, tk, dp, dvp,
                                int(causal), _scale(q, scale),
                                _DTYPE_CODE[q.dtype], _stream(q.device))
    _raise_on(rc, "flash_attention_bwd", lib.flash_wide_error_string)
    return tuple(x[..., :w].to(q.dtype)
                 for x, w in ((dq, dh), (dk, dh), (dvw, dv)))


def _pad_heads(dh, *xs):
    """(dh the kernel takes, xs): the bf16 kernels' tiles are 64 wide, so
    narrower bf16 heads are zero-padded to 64; zero columns add nothing to
    q . k or dO . v, and the outputs' extra columns are dropped."""
    if xs[0].dtype != torch.bfloat16 or dh >= BF16_TC_HEAD_DIM:
        return dh, xs
    pad = BF16_TC_HEAD_DIM - dh
    return BF16_TC_HEAD_DIM, tuple(torch.nn.functional.pad(x, (0, pad))
                                   for x in xs)


def flash_attention_fwd(q, k, v, key_mask=None, *, causal: bool = False,
                        scale=None, dropout_rate: float = 0.0, seed=None):
    """(out (B, H, Tq, dv) in q's dtype, lse (B, H, Tq) fp32). CPU tensors:
    ``flash_fwd_reference``; CUDA tensors: ``flash_fwd_tc_kernel`` (bf16,
    heads narrower than 64 zero-padded) or ``flash_fwd_kernel`` (fp32),
    which visit only the key tiles the key mask leaves live
    (``flash_live_tiles``) within a query tile's causal range; heads those
    do not take (``narrow_kernels``) ``flash_wide_fwd_kernel``."""
    _need_seed(dropout_rate, seed)
    tensors = (q, k, v) + (() if key_mask is None else (key_mask,))
    if not _on_card("flash_attention_fwd", *tensors,
                    entry="flash_attention"):
        return flash_fwd_reference(q, k, v, key_mask, causal=causal,
                                   scale=scale, dropout_rate=dropout_rate,
                                   seed=seed)
    if not narrow_kernels(_FWD, q, v):
        res = _wide_fwd(q, k, v, key_mask, causal, scale, dropout_rate, seed)
        flash_attention_fwd.launches += 1
        return res
    b, h, tq, tk, dh, (qa, ka, va), km, lib = _inputs(
        "flash_attention_fwd", _FWD, q, k, v, key_mask)
    live = flash_live_tiles(km)
    seed_t = _seed_tensor(seed, dropout_rate, q.device)
    seed_ptr, thresh, dscale = _drop_args(seed_t, dropout_rate)
    kdh, (qa, ka, va) = _pad_heads(dh, qa, ka, va)
    out = _like_heads(b, h, tq, kdh, q.dtype, q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.flash_fwd(*_seq4(qa), *_seq4(ka), *_seq4(va), km.data_ptr(),
                           live.data_ptr(), seed_ptr, thresh, dscale,
                           *_seq4(out), lse.data_ptr(), b, h, tq, tk, kdh,
                           int(causal), _scale(q, scale),
                           _DTYPE_CODE[q.dtype], _stream(q.device))
    _raise_on(rc, "flash_attention_fwd", lib.flash_error_string)
    flash_attention_fwd.launches += 1
    return out[..., :dh], lse


flash_attention_fwd.launches = 0


def _bwd_stats(lse, delta, b, h, tq):
    _check(tuple(lse.shape) == (b, h, tq) and tuple(delta.shape) == (b, h, tq),
           "lse / delta shape")
    return (lse.detach().to(torch.float32).contiguous(),
            delta.detach().to(torch.float32).contiguous())


def flash_attention_bwd(q, k, v, key_mask, dout, lse, delta, *,
                        causal: bool = False, scale=None,
                        dropout_rate: float = 0.0, seed=None):
    """(dQ (B, H, Tq, dh), dK (B, H, Tk, dh), dV (B, H, Tk, dv)) in q's
    dtype from dO (B, H, Tq, dv), lse and delta (B, H, Tq). Heads the
    kernels below do not take (``narrow_kernels``) take
    ``flash_wide_bwd_kernel``. CPU tensors:
    ``flash_bwd_reference``; CUDA tensors: ``flash_bwd_tc_kernel`` (bf16)
    or ``flash_bwd_kernel`` (fp32), one key-major pass over the live key
    tiles (``flash_live_tiles``) that adds dQ into a zeroed fp32 workspace
    (B, Tq, H, dh), which is then cast into dQ's (B, T, H, dh) storage."""
    _need_seed(dropout_rate, seed)
    tensors = (q, k, v, dout, lse, delta) + (() if key_mask is None
                                             else (key_mask,))
    if not _on_card("flash_attention_bwd", *tensors,
                    entry="flash_attention"):
        return flash_bwd_reference(q, k, v, key_mask, dout, lse, delta,
                                   causal=causal, scale=scale,
                                   dropout_rate=dropout_rate, seed=seed)
    if not narrow_kernels(_BWD, q, v):
        res = _wide_bwd(q, k, v, key_mask, dout.to(q.dtype), lse, delta,
                        causal, scale, dropout_rate, seed)
        flash_attention_bwd.launches += 1
        return res
    b, h, tq, tk, dh, (qa, ka, va, da), km, lib = _inputs(
        "flash_attention_bwd", _BWD, q, k, v, key_mask,
        dout=dout.to(q.dtype))
    lse, delta = _bwd_stats(lse, delta, b, h, tq)
    live = flash_live_tiles(km)
    seed_t = _seed_tensor(seed, dropout_rate, q.device)
    seed_ptr, thresh, dscale = _drop_args(seed_t, dropout_rate)
    kdh, (qa, ka, va, da) = _pad_heads(dh, qa, ka, va, da)
    ws = torch.zeros((b, tq, h, kdh), dtype=torch.float32, device=q.device)
    dk = _like_heads(b, h, tk, kdh, q.dtype, q.device)
    dv = _like_heads(b, h, tk, kdh, q.dtype, q.device)
    with torch.cuda.device(q.device):
        rc = lib.flash_bwd(*_seq4(qa), *_seq4(ka), *_seq4(va), *_seq4(da),
                           km.data_ptr(), live.data_ptr(), lse.data_ptr(),
                           delta.data_ptr(), seed_ptr, thresh, dscale,
                           ws.data_ptr(), *_seq4(dk), *_seq4(dv), b, h, tq,
                           tk, kdh, int(causal), _scale(q, scale),
                           _DTYPE_CODE[q.dtype], _stream(q.device))
    _raise_on(rc, "flash_attention_bwd", lib.flash_error_string)
    flash_attention_bwd.launches += 1
    dq = ws[..., :dh].to(q.dtype).permute(0, 2, 1, 3)
    return dq, dk[..., :dh], dv[..., :dh]


flash_attention_bwd.launches = 0
FLASH_KERNELS = (flash_attention_fwd, flash_attention_bwd)


class _FlashAttention(torch.autograd.Function):
    """out of ``flash_attention_fwd``; the backward is delta = rowsum(dO *
    out), then ``flash_attention_bwd`` with the same seed (the kernel on the
    card, the plain pieces on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, seed, cfg):
        causal, scale, rate = cfg
        out, lse = flash_attention_fwd(q, k, v, key_mask, causal=causal,
                                       scale=scale, dropout_rate=rate,
                                       seed=seed)
        ctx.save_for_backward(q, k, v, key_mask, out, lse)
        ctx.seed, ctx.cfg = seed, cfg
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, key_mask, out, lse = ctx.saved_tensors
        causal, scale, rate = ctx.cfg
        kw = dict(causal=causal, scale=scale, dropout_rate=rate,
                  seed=ctx.seed)
        g = g.to(q.dtype)
        delta = flash_delta(g, out)
        dq, dk, dv = flash_attention_bwd(q, k, v, key_mask, g, lse, delta,
                                         **kw)
        return dq, dk, dv, None, None, None


class _FlashWrittenOut(torch.autograd.Function):
    """``flash_fwd_reference``, differentiated by the written-out
    ``flash_bwd_reference`` (ds rounded to the compute dtype before both
    products, as the kernels round it) rather than by autograd (which keeps
    ds in fp32): on any device, the plain version a bf16 train step
    through the kernels is held to."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, seed, cfg):
        causal, scale, rate = cfg
        out, lse = flash_fwd_reference(q, k, v, key_mask, causal=causal,
                                       scale=scale, dropout_rate=rate,
                                       seed=seed)
        ctx.save_for_backward(q, k, v, key_mask, out, lse)
        ctx.seed, ctx.cfg = seed, cfg
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, key_mask, out, lse = ctx.saved_tensors
        causal, scale, rate = ctx.cfg
        g = g.to(q.dtype)
        dq, dk, dv = flash_bwd_reference(
            q, k, v, key_mask, g, lse, flash_delta(g, out), causal=causal,
            scale=scale, dropout_rate=rate, seed=ctx.seed)
        return dq, dk, dv, None, None, None


def flash_attention_written_out(q, k, v, key_mask=None, *,
                                causal: bool = False, scale=None,
                                dropout_rate: float = 0.0, seed=None):
    """``flash_attention`` in plain ops on any device, its backward the
    written-out plain pieces (``_FlashWrittenOut``)."""
    _need_seed(dropout_rate, seed)
    cfg = (bool(causal), _scale(q, scale), float(dropout_rate))
    return _FlashWrittenOut.apply(q, k, v, key_mask, seed, cfg)


def flash_attention(q, k, v, key_mask=None, *, causal: bool = False,
                    scale=None, dropout_rate: float = 0.0, seed=None):
    """Blockwise attention: out (B, H, Tq, dv) in q's dtype. q (B, H, Tq,
    dh); k (B, H, Tk, dh); v (B, H, Tk, dv); key_mask (B, Tk) or None;
    ``scale`` (default 1/sqrt(dh)) multiplies q . k; ``seed`` (an int or
    an int64 scalar tensor) keys the dropout mask and is required when
    ``dropout_rate`` > 0. CPU tensors take the plain version, CUDA tensors
    the kernels; under autograd ``_FlashAttention``."""
    _need_seed(dropout_rate, seed)
    cfg = (bool(causal), _scale(q, scale), float(dropout_rate))
    if differentiable(q, k, v):
        return _FlashAttention.apply(q, k, v, key_mask, seed, cfg)
    return flash_attention_fwd(q, k, v, key_mask, causal=cfg[0], scale=cfg[1],
                               dropout_rate=cfg[2], seed=seed)[0]
