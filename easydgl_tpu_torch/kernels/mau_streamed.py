"""Streamed MAU/BiMAU forward on the card (port of
``easydgl_tpu.kernels.mau_streamed``, forward).

The two-sweep long-context schedule of ``kernels.mau_blocked`` as three
hand-written CUDA kernels (``csrc/mau_streamed_fwd.cu``), on the natural
(B, T, C) layout:

* ``mau_stats`` (TPU ``_stats_kernel``): m, l and seq_units;
* ``mau_intensity`` (TPU ``_int_fwd_kernel``): lam from seq_units, fp32;
* ``mau_modulated_out`` (TPU ``_out_kernel``): the modulated output.

``mau_streamed`` runs the three, with the argument contract of
``mau_attention`` (no gathered queries: queries are at positions
0..Tq-1). Every wrapper dispatches on where its tensors lie: CPU tensors
take the plain version (``mau_blocked`` and its sweeps); CUDA tensors launch
the kernel, adding one to the wrapper's ``launches``, or raise. Forward
only: on the card a call that needs a gradient raises
``NotImplementedError`` (the backward kernels come with the EasyDGL-LC
train step, queue B of ROADMAP.md); it never detaches and never falls back
to the plain version.

lam comes back in fp32 (the JAX streamed path rounds it to q's dtype; its
blocked path, like this one, does not). ``block_k`` is the plain version's
key block; the kernels tile by 64 queries and 64 keys. In bf16 the stats
and output kernels run their products on the tensor cores, and the output
kernel takes lam and the one-hot rounded to bf16 (as the plain version
rounds them) and zero-padded to a multiple of 16 events.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from easydgl_tpu_torch.kernels import build
from easydgl_tpu_torch.kernels.mau_attention import (_DTYPE_CODE,
                                                     KERNEL_HEAD_DIMS,
                                                     KERNEL_SMEM_MAX, _bind,
                                                     _drop_args, _seed_tensor,
                                                     _stream)
from easydgl_tpu_torch.kernels.mau_blocked import (intensity_reference,
                                                   mau_blocked,
                                                   output_reference,
                                                   stats_reference)

_P, _LL, _I32, _U32, _F32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                             ctypes.c_uint, ctypes.c_float)
_TRAINING_SLICE = ("the streamed MAU backward is not ported yet (the "
                   "EasyDGL-LC train step, ROADMAP.md queue B rows 11 and "
                   "14-16); run the forward under torch.no_grad() or on the "
                   "CPU")


def _lib() -> ctypes.CDLL:
    lib = build.load("mau_streamed_fwd")
    _bind(lib, "mau_stats_fwd",
          [_P, _LL, _LL] * 3 + [_P] * 4 + [_I32] * 6 + [_F32, _I32, _P])
    _bind(lib, "mau_intensity_fwd", [_P] * 7 + [_I32] * 5 + [_P])
    _bind(lib, "mau_out_fwd",
          [_P, _LL, _LL] * 3 + [_P] * 6 + [_U32, _F32, _P] + [_I32] * 8
          + [_F32, _I32, _P])
    lib.mau_stats_smem_bytes.argtypes = [_I32, _I32]
    lib.mau_out_smem_bytes.argtypes = [_I32, _I32, _I32]
    lib.mau_intensity_smem_bytes.argtypes = [_I32, _I32]
    for name in ("mau_stats_smem_bytes", "mau_out_smem_bytes",
                 "mau_intensity_smem_bytes"):
        getattr(lib, name).restype = ctypes.c_size_t
    lib.mau_streamed_error_string.argtypes = [_I32]
    lib.mau_streamed_error_string.restype = ctypes.c_char_p
    return lib


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"mau_streamed kernel: {msg}")


def _on_card(name: str, *tensors) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on other devices
    and where autograd would need a gradient of the kernel."""
    dev = tensors[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        raise NotImplementedError(f"{name}: {_TRAINING_SLICE}")
    for x in tensors:
        _check(x.device == dev, f"{name}: a tensor on {x.device}, q on {dev}")
    return True


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to(torch.float32).contiguous()


def _seq(x: torch.Tensor):
    return x.data_ptr(), x.stride(0), x.stride(1)


def _rows16(x: torch.Tensor) -> torch.Tensor:
    """x where its rows start on 16-byte boundaries, as the bf16 kernels'
    vector loads need, else a contiguous copy (C is a multiple of 8)."""
    if x.dtype == torch.bfloat16 and (x.data_ptr() % 16 or x.stride(0) % 8
                                      or x.stride(1) % 8):
        return x.contiguous()
    return x


def _bf16_events(x: torch.Tensor) -> torch.Tensor:
    """(..., E) -> bf16 (..., EP), rounded and zero-padded to EP = E rounded
    up to 16: the bf16 output kernel's lam and one-hot operands."""
    e = x.shape[-1]
    return F.pad(x.detach().to(torch.bfloat16), (0, -(-e // 16) * 16 - e)
                 ).contiguous()


def _checked_seqs(q, others, num_heads):
    """Validates q (B, Tq, C) and k/v/t (B, Tk, C); returns (b, tq, tk, dh)."""
    cdt = q.dtype
    _check(cdt in _DTYPE_CODE, f"q dtype {cdt} not float32/bfloat16")
    b, tq, c = q.shape
    tk = others[0][1].shape[1]
    _check(c % num_heads == 0, f"C={c} not a multiple of num_heads")
    dh = c // num_heads
    _check(dh in KERNEL_HEAD_DIMS, f"head dim {dh} not in {KERNEL_HEAD_DIMS}")
    _check(q.stride(2) == 1, "q channels not contiguous")
    for name, x in others:
        _check(x.dtype == cdt, f"{name} dtype {x.dtype} != q dtype {cdt}")
        _check(tuple(x.shape) == (b, tk, c), f"{name} shape {tuple(x.shape)}")
        _check(x.stride(2) == 1, f"{name} channels not contiguous")
    return b, tq, tk, dh


def _raise_on(lib, rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.mau_streamed_error_string(rc).decode())


def mau_stats(q, k, t, key_mask, *, causal: bool = False, num_heads: int,
              block_k: int = 512):
    """Sweep 1: (m (B, H, Tq), l (B, H, Tq), seq_units (B, H, Tq, dh)),
    fp32. CPU tensors: ``mau_blocked.stats_reference``; CUDA tensors:
    ``mau_stats_kernel``."""
    if not _on_card("mau_stats", q, k, t, key_mask):
        return stats_reference(q, k, t, key_mask, causal=causal,
                               num_heads=num_heads, block_k=block_k)
    b, tq, tk, dh = _checked_seqs(q, (("k", k), ("t", t)), num_heads)
    _check(tuple(key_mask.shape) == (b, tk), "key_mask shape")
    km = _f32(key_mask)
    q, k, t = (_rows16(x) for x in (q, k, t))
    lib = _lib()
    _check(lib.mau_stats_smem_bytes(dh, _DTYPE_CODE[q.dtype])
           <= KERNEL_SMEM_MAX, "shared memory over the limit")
    f32 = dict(dtype=torch.float32, device=q.device)
    h = num_heads
    m, l = torch.empty((b, h, tq), **f32), torch.empty((b, h, tq), **f32)
    su = torch.empty((b, h, tq, dh), **f32)
    with torch.cuda.device(q.device):
        rc = lib.mau_stats_fwd(*_seq(q), *_seq(k), *_seq(t), km.data_ptr(),
                               m.data_ptr(), l.data_ptr(), su.data_ptr(), b,
                               tq, tk, h, dh, int(causal), 1.0 / dh ** 0.5,
                               _DTYPE_CODE[q.dtype], _stream(q.device))
    _raise_on(lib, rc, "mau_stats")
    mau_stats.launches += 1
    return m, l, su


mau_stats.launches = 0


def mau_intensity(su, intervals, wd, bd, w, scaling):
    """The intensity head: lam (B, H, Tq, E) fp32 from seq_units
    (B, H, Tq, dh) and intervals (B, Tq). CPU tensors:
    ``mau_blocked.intensity_reference``; CUDA tensors:
    ``mau_intensity_kernel`` (fp32 throughout)."""
    if not _on_card("mau_intensity", su, intervals, wd, bd, w, scaling):
        return intensity_reference(su, intervals, wd, bd, w, scaling)
    b, h, tq, dh = su.shape
    e = w.shape[0]
    _check(dh in KERNEL_HEAD_DIMS, f"head dim {dh} not in {KERNEL_HEAD_DIMS}")
    _check(tuple(intervals.shape) == (b, tq), "intervals shape")
    _check(tuple(wd.shape) == (dh + 1, e * dh), "wd shape")
    _check(tuple(bd.shape) == (e * dh,), "bd shape")
    _check(tuple(w.shape) == (e, dh), "w shape")
    _check(tuple(scaling.shape) == (e,), "scaling shape")
    suf, iv, wdf, bdf, wf, scf = (_f32(x) for x in
                                  (su, intervals, wd, bd, w, scaling))
    for name, x in (("wd", wdf), ("bd", bdf), ("w", wf)):
        _check(x.data_ptr() % 16 == 0, f"{name} not 16-byte aligned")
    lib = _lib()
    _check(lib.mau_intensity_smem_bytes(dh, e) <= KERNEL_SMEM_MAX,
           f"E={e} needs more shared memory than the limit")
    lam = torch.empty((b, h, tq, e), dtype=torch.float32, device=su.device)
    with torch.cuda.device(su.device):
        rc = lib.mau_intensity_fwd(suf.data_ptr(), iv.data_ptr(),
                                   wdf.data_ptr(), bdf.data_ptr(),
                                   wf.data_ptr(), scf.data_ptr(),
                                   lam.data_ptr(), b, h, tq, dh, e,
                                   _stream(su.device))
    _raise_on(lib, rc, "mau_intensity")
    mau_intensity.launches += 1
    return lam


mau_intensity.launches = 0


def mau_modulated_out(q, k, v, key_mask, onehot, lam, m, l, *,
                      causal: bool = False, diag_reset: bool = False,
                      dropout_rate: float = 0.0, dropout_seed=None,
                      num_heads: int, block_k: int = 512):
    """Sweep 2: out (B, Tq, C) in q's dtype from lam (B, H, Tq, E) and the
    stats m, l (B, H, Tq). CPU tensors: ``mau_blocked.output_reference``;
    CUDA tensors: ``mau_out_kernel``."""
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("mau_streamed: dropout_rate > 0 needs dropout_seed")
    if not _on_card("mau_modulated_out", q, k, v, key_mask, onehot, lam, m,
                    l):
        return output_reference(q, k, v, key_mask, onehot, lam, m, l,
                                causal=causal, diag_reset=diag_reset,
                                dropout_rate=dropout_rate,
                                dropout_seed=dropout_seed,
                                num_heads=num_heads, block_k=block_k)
    b, tq, tk, dh = _checked_seqs(q, (("k", k), ("v", v)), num_heads)
    h = num_heads
    e = lam.shape[-1]
    _check(tuple(key_mask.shape) == (b, tk), "key_mask shape")
    _check(tuple(onehot.shape) == (b, tk, e), "onehot shape")
    _check(tuple(lam.shape) == (b, h, tq, e), "lam shape")
    _check(tuple(m.shape) == (b, h, tq) and tuple(l.shape) == (b, h, tq),
           "m / l shape")
    km, mf, lf = (_f32(x) for x in (key_mask, m, l))
    if q.dtype == torch.bfloat16:
        q, k, v = (_rows16(x) for x in (q, k, v))
        oh, lamf = _bf16_events(onehot), _bf16_events(lam)
    else:
        oh, lamf = _f32(onehot), _f32(lam)
    lib = _lib()
    _check(lib.mau_out_smem_bytes(dh, e, _DTYPE_CODE[q.dtype])
           <= KERNEL_SMEM_MAX,
           f"dh={dh}, E={e} need more shared memory than the limit")
    seed = _seed_tensor(dropout_seed, dropout_rate, q.device)
    seed_ptr, thresh, dscale = _drop_args(seed, dropout_rate)
    out = torch.empty((b, tq, h * dh), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.mau_out_fwd(*_seq(q), *_seq(k), *_seq(v), km.data_ptr(),
                             oh.data_ptr(), lamf.data_ptr(), mf.data_ptr(),
                             lf.data_ptr(), seed_ptr, thresh, dscale,
                             out.data_ptr(), b, tq, tk, h, dh, e, int(causal),
                             int(diag_reset), 1.0 / dh ** 0.5,
                             _DTYPE_CODE[q.dtype], _stream(q.device))
    _raise_on(lib, rc, "mau_modulated_out")
    mau_modulated_out.launches += 1
    return out


mau_modulated_out.launches = 0


def mau_streamed(q, k, v, t, key_mask, intervals, onehot, wd, bd, w,
                 scaling, causal: bool = False, diag_reset: bool = False,
                 dropout_rate: float = 0.0, *, num_heads: int,
                 dropout_seed=None, block_k: int = 512):
    """Long-context self-modulating attention, the natural-layout wire
    format of ``mau_attention``: q (B, Tq, C); k/v/t (B, Tk, C); key_mask
    (B, Tk); intervals (B, Tq); onehot (B, Tk, E); the intensity-head
    parameters. Returns (out (B, Tq, C) in q's dtype, mark_intensity
    (B, H, Tq, E) fp32). CPU tensors take ``mau_blocked`` (differentiable
    by autograd); CUDA tensors launch the three kernels or raise."""
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("mau_streamed: dropout_rate > 0 needs dropout_seed")
    if not _on_card("mau_streamed", q, k, v, t, key_mask, intervals, onehot,
                    wd, bd, w, scaling):
        return mau_blocked(q, k, v, t, key_mask, intervals, onehot, wd, bd, w,
                           scaling, causal, diag_reset, dropout_rate,
                           num_heads=num_heads, dropout_seed=dropout_seed,
                           block_k=block_k)
    m, l, su = mau_stats(q, k, t, key_mask, causal=causal,
                         num_heads=num_heads)
    lam = mau_intensity(su, intervals, wd, bd, w, scaling)
    out = mau_modulated_out(q, k, v, key_mask, onehot, lam, m, l,
                            causal=causal, diag_reset=diag_reset,
                            dropout_rate=dropout_rate,
                            dropout_seed=dropout_seed, num_heads=num_heads)
    return out, lam
