"""Streamed MAU/BiMAU on the card, forward and backward (port of
``easydgl_tpu.kernels.mau_streamed``).

The two-sweep long-context schedule of ``kernels.mau_blocked`` and its
two-pass backward as hand-written CUDA kernels on the natural (B, T, C)
layout. Forward (``csrc/mau_streamed_fwd.cu``):

* ``mau_stats`` (TPU ``_stats_kernel``): m, l and seq_units;
* ``mau_intensity`` (TPU ``_int_fwd_kernel``): lam from seq_units, fp32
  (its product on the tensor cores in three bf16 products of a hi/lo split
  of each fp32 operand);
* ``mau_modulated_out`` (TPU ``_out_kernel``): the modulated output.

Backward (``csrc/mau_streamed_bwd.cu``), run by ``_MauStreamed`` in JAX's
order (``_mau_streamed_bwd``):

* ``mau_glam`` (TPU ``_glam_kernel``): d(lambda) from the modulation;
* ``mau_intensity_bwd`` (TPU ``_int_bwd_kernel``): the intensity head's
  fp32 VJP, d(seq_units) and the head's parameter gradients (its products
  on the tensor cores in three bf16 products of a hi/lo split);
* rho = <out, g_out> + <g_su, su> in PyTorch;
* ``mau_dq`` (TPU ``_dq_kernel``): dQ;
* ``mau_dkvt`` (TPU ``_dkvt_kernel``): dK, dV, dT, key-major.

``mau_streamed`` runs them with the argument contract of ``mau_attention``
(no gathered queries: queries are at positions 0..Tq-1). Every wrapper
dispatches on where its tensors lie: CPU tensors take the plain version
(``mau_blocked`` and its pieces, whose autograd Function ``_MauBlocked`` is
the CPU engine); CUDA tensors launch the kernel, adding one to the wrapper's
``launches``, or raise. ``mau_streamed`` on CUDA tensors that need a
gradient runs ``_MauStreamed``; a single wrapper is not differentiable on
its own and raises under autograd rather than detach. No path falls back
to the plain version on the card.

lam comes back in fp32 (the JAX streamed path rounds it to q's dtype; its
blocked path, like this one, does not). ``block_k`` is the plain version's
key block; the kernels tile by 64 queries and 64 keys. In bf16 every kernel
runs its products on the tensor cores and takes lam and the one-hot rounded
to bf16 (as the plain version rounds them) and zero-padded to 64-event
tiles for the ``wgmma`` kernels (output, d-lambda, dq, dk/dv/dt), whose
heads, and the stats kernel's, are zero-padded to 64 channels too. Those
five visit only the (query tile, key tile) pairs of
``streamed_visited_tiles`` (dq its visible-only
form): each block makes ``streamed_key_plan``'s row of its batch row from
the key mask (``key_plan`` in ``csrc/mau_streamed.cuh``) and applies the
rule to it. The backward kernels take dh in (16, 32, 64) and E up to 128;
in fp32 the attention-side kernels run on the CUDA cores.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from easydgl_tpu_torch.kernels import build
from easydgl_tpu_torch.kernels.flash_attention import TILE, flash_live_tiles
from easydgl_tpu_torch.kernels.mau_attention import (_DTYPE_CODE,
                                                     KERNEL_HEAD_DIMS,
                                                     KERNEL_SMEM_MAX, _bind,
                                                     _drop_args, _rows16,
                                                     _seed_tensor, _on_card,
                                                     _raise_on, _stream,
                                                     differentiable)
from easydgl_tpu_torch.kernels.mau_blocked import (
    BackwardOps, BlockedForward, autograd_function,
    dkvt_reference, dq_reference, glam_reference, intensity_reference,
    intensity_vjp_reference, mau_blocked, output_reference, stats_reference)

_P, _LL, _I32, _U32, _F32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                             ctypes.c_uint, ctypes.c_float)
KERNEL_BWD_HEAD_DIMS = (16, 32, 64)
KERNEL_BWD_EVENTS_MAX = 128
# kernels of mau_streamed_bwd.cu, as mau_streamed_bwd_smem_bytes numbers them
_GLAM, _DQ, _DKVT, _INT_ROWS, _INT_COLS = range(5)


def _lib() -> ctypes.CDLL:
    lib = build.load("mau_streamed_fwd")
    _bind(lib, "mau_stats_fwd",
          [_P, _LL, _LL] * 3 + [_P] * 4 + [_I32] * 6 + [_F32, _I32, _P])
    _bind(lib, "mau_intensity_fwd", [_P] * 8 + [_I32] * 5 + [_P])
    _bind(lib, "mau_out_fwd",
          [_P, _LL, _LL] * 3 + [_P] * 6 + [_U32, _F32, _P] + [_I32] * 8
          + [_F32, _I32, _P])
    lib.mau_stats_smem_bytes.argtypes = [_I32] * 3
    lib.mau_out_smem_bytes.argtypes = [_I32] * 4
    lib.mau_intensity_smem_bytes.argtypes = [_I32]
    for name in ("mau_stats_smem_bytes", "mau_out_smem_bytes",
                 "mau_intensity_smem_bytes"):
        getattr(lib, name).restype = ctypes.c_size_t
    lib.mau_streamed_error_string.argtypes = [_I32]
    lib.mau_streamed_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("mau_streamed_bwd")
    _bind(lib, "mau_glam_bwd", [_P, _LL, _LL] * 4 + [_P] * 5
          + [_U32, _F32, _P] + [_I32] * 8 + [_F32, _I32, _P])
    _bind(lib, "mau_dq_bwd", [_P, _LL, _LL] * 5 + [_P] * 8
          + [_U32, _F32, _P] + [_I32] * 8 + [_F32, _I32, _P])
    _bind(lib, "mau_dkvt_bwd", [_P, _LL, _LL] * 5 + [_P] * 8 + [_U32, _F32]
          + [_P] * 3 + [_I32] * 8 + [_F32, _I32, _P])
    _bind(lib, "mau_intensity_bwd", [_P] * 13 + [_I32] * 5 + [_P])
    lib.mau_streamed_bwd_smem_bytes.argtypes = [_I32] * 5
    lib.mau_streamed_bwd_smem_bytes.restype = ctypes.c_size_t
    return lib


def streamed_key_plan(key_mask: torch.Tensor) -> torch.Tensor:
    """(B, ceil(Tk / 64) + 1) int32 from the key mask (B, Tk): per batch row
    the code of each 64-key tile (``flash_live_tiles``: 0 where no key of
    the tile is real, 2 where all 64 are, 1 otherwise), then the index of
    its first real key (Tk where it has none): what each block of the bf16
    output, d-lambda and dk/dv/dt kernels makes of its batch row
    (``key_plan`` in ``csrc/mau_streamed.cuh``) and reads its live-tile rule
    from; ``streamed_visited_tiles`` is that rule."""
    real = key_mask > 0
    first = torch.where(real.any(1), real.int().argmax(1), real.shape[1])
    return torch.cat([flash_live_tiles(key_mask), first[:, None].int()],
                     1).contiguous()


def streamed_visited_tiles(key_mask: torch.Tensor, tq: int, causal: bool,
                           visible_only: bool = False) -> torch.Tensor:
    """(B, ceil(Tq / 64), ceil(Tk / 64)) bool: the (query tile, key tile)
    pairs that the bf16 output, d-lambda and dk/dv/dt kernels compute. A
    query tile is blind where a row of it sees no key: every row where the
    batch row has no real key, and under causal the rows before its first
    real key. A blind query tile visits every key tile (such a row is
    uniform over every real key, masked ones included); any other one the
    key tiles that hold a real key, under causal none after its last query
    (``key_tiles``' range). Every other pair adds exactly 0. The
    ``visible_only`` form (the bf16 dq kernel's) takes no query tile as
    blind: dq's g_s is 0 wherever an entry is not visible, so a row that
    sees no key adds nothing to dq (``TileRule`` in
    ``csrc/mau_streamed.cuh`` with its ``visible_only`` flag)."""
    plan = streamed_key_plan(key_mask)
    tk, nkt = key_mask.shape[1], plan.shape[1] - 1
    dev = key_mask.device
    first = plan[:, -1, None, None]
    q0 = TILE * torch.arange(-(-tq // TILE), device=dev)[None, :, None]
    kt = torch.arange(nkt, device=dev)[None, None, :]
    blind = ((first >= tk) | (causal & (q0 < first))) & (not visible_only)
    vis = (plan[:, None, :nkt] > 0) | blind
    if causal:
        vis = vis & (blind | (TILE * kt <= (q0 + TILE).clamp(max=tq) - 1))
    return vis


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"mau_streamed kernel: {msg}")


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to(torch.float32).contiguous()


def _seq(x: torch.Tensor):
    return x.data_ptr(), x.stride(0), x.stride(1)


def _bf16_events(x: torch.Tensor) -> torch.Tensor:
    """(..., E) -> bf16 (..., EP), rounded and zero-padded to EP = E rounded
    up to 64: the lam and one-hot operands of the bf16 kernels (the wgmma
    kernels' 64-event tiles)."""
    e = x.shape[-1]
    return F.pad(x.detach().to(torch.bfloat16), (0, -(-e // 64) * 64 - e)
                 ).contiguous()


def _pad_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, T, H * dh) -> (B, T, H * 64), each head zero-padded to 64
    channels where dh < 64 (the wgmma kernels' 64-wide tiles), else x."""
    b, n, c = x.shape
    dh = c // num_heads
    if dh >= 64:
        return x
    return F.pad(x.reshape(b, n, num_heads, dh), (0, 64 - dh)).reshape(
        b, n, num_heads * 64)


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


def mau_stats(q, k, t, key_mask, *, causal: bool = False, num_heads: int,
              block_k: int = 512):
    """Sweep 1: (m (B, H, Tq), l (B, H, Tq), seq_units (B, H, Tq, dh)),
    fp32. CPU tensors: ``mau_blocked.stats_reference``; CUDA tensors:
    ``mau_stats_tc_kernel`` (bf16: heads zero-padded to 64 channels, the key
    tiles of ``streamed_visited_tiles`` only) or ``mau_stats_kernel``
    (fp32)."""
    if not _on_card("mau_stats", q, k, t, key_mask,
                    entry="mau_streamed"):
        return stats_reference(q, k, t, key_mask, causal=causal,
                               num_heads=num_heads, block_k=block_k)
    b, tq, tk, dh = _checked_seqs(q, (("k", k), ("t", t)), num_heads)
    _check(tuple(key_mask.shape) == (b, tk), "key_mask shape")
    km = _f32(key_mask)
    h = num_heads
    kdh = dh
    if q.dtype == torch.bfloat16:
        q, k, t = (_pad_heads(x, h) for x in (q, k, t))
        kdh = q.shape[-1] // h
    q, k, t = (_rows16(x) for x in (q, k, t))
    lib = _lib()
    _check(lib.mau_stats_smem_bytes(kdh, tk, _DTYPE_CODE[q.dtype])
           <= KERNEL_SMEM_MAX, "shared memory over the limit")
    f32 = dict(dtype=torch.float32, device=q.device)
    m, l = torch.empty((b, h, tq), **f32), torch.empty((b, h, tq), **f32)
    su = torch.empty((b, h, tq, kdh), **f32)
    with torch.cuda.device(q.device):
        rc = lib.mau_stats_fwd(*_seq(q), *_seq(k), *_seq(t), km.data_ptr(),
                               m.data_ptr(), l.data_ptr(), su.data_ptr(), b,
                               tq, tk, h, kdh, int(causal), 1.0 / dh ** 0.5,
                               _DTYPE_CODE[q.dtype], _stream(q.device))
    _raise_on(rc, "mau_stats", _lib().mau_streamed_error_string)
    mau_stats.launches += 1
    return m, l, su[..., :dh]


mau_stats.launches = 0


def mau_intensity(su, intervals, wd, bd, w, scaling):
    """The intensity head: lam (B, H, Tq, E) fp32 from seq_units
    (B, H, Tq, dh) and intervals (B, Tq). CPU tensors:
    ``mau_blocked.intensity_reference``; CUDA tensors, any dh in
    (16, 32, 64, 128) and any E: ``mau_int_split_kernel`` (Wd's seq_units
    lanes into bf16 hi and lo, in a scratch of this call) then
    ``mau_int_fwd_tc_kernel`` (one launch of the wrapper), fp32 in and out,
    its product on the tensor cores in three bf16 products of the hi/lo
    split (about 2^-16 of |a||b| a term)."""
    if not _on_card("mau_intensity", su, intervals, wd, bd, w, scaling,
                    entry="mau_streamed"):
        return intensity_reference(su, intervals, wd, bd, w, scaling)
    b, h, tq, dh = su.shape
    e = w.shape[0]
    _check(dh in KERNEL_HEAD_DIMS, f"head dim {dh} not in {KERNEL_HEAD_DIMS}")
    _check(tuple(intervals.shape) == (b, tq), "intervals shape")
    _check(tuple(wd.shape) == (dh + 1, e * dh), "wd shape")
    _check(tuple(bd.shape) == (e * dh,), "bd shape")
    _check(tuple(w.shape) == (e, dh), "w shape")
    _check(tuple(scaling.shape) == (e,), "scaling shape")
    # contiguous fp32, at 16-byte boundaries for the kernels' vector loads
    suf, iv, wdf, bdf, wf, scf = (
        x if x.data_ptr() % 16 == 0 else x.clone() for x in (
            _f32(y) for y in (su, intervals, wd, bd, w, scaling)))
    lib = _lib()
    _check(lib.mau_intensity_smem_bytes(dh) <= KERNEL_SMEM_MAX,
           f"dh={dh} needs more shared memory than the limit")
    split = torch.empty((2, dh, e * dh), dtype=torch.bfloat16,
                        device=su.device)
    lam = torch.empty((b, h, tq, e), dtype=torch.float32, device=su.device)
    with torch.cuda.device(su.device):
        rc = lib.mau_intensity_fwd(suf.data_ptr(), iv.data_ptr(),
                                   wdf.data_ptr(), bdf.data_ptr(),
                                   wf.data_ptr(), scf.data_ptr(),
                                   split.data_ptr(), lam.data_ptr(), b, h,
                                   tq, dh, e, _stream(su.device))
    _raise_on(rc, "mau_intensity", _lib().mau_streamed_error_string)
    mau_intensity.launches += 1
    return lam


mau_intensity.launches = 0


def mau_modulated_out(q, k, v, key_mask, onehot, lam, m, l, *,
                      causal: bool = False, diag_reset: bool = False,
                      dropout_rate: float = 0.0, dropout_seed=None,
                      num_heads: int, block_k: int = 512):
    """Sweep 2: out (B, Tq, C) in q's dtype from lam (B, H, Tq, E) and the
    stats m, l (B, H, Tq). CPU tensors: ``mau_blocked.output_reference``;
    CUDA tensors: ``mau_out_tc_kernel`` (bf16: heads zero-padded to 64
    channels, lam and the one-hot to 64-event tiles, the key tiles of
    ``streamed_visited_tiles`` only) or ``mau_out_kernel`` (fp32)."""
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("mau_streamed: dropout_rate > 0 needs dropout_seed")
    if not _on_card("mau_modulated_out", q, k, v, key_mask, onehot, lam, m,
                    l, entry="mau_streamed"):
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
    kdh = dh
    if q.dtype == torch.bfloat16:
        q, k, v = (_rows16(_pad_heads(x, h)) for x in (q, k, v))
        kdh = q.shape[-1] // h
        oh, lamf = _bf16_events(onehot), _bf16_events(lam)
    else:
        oh, lamf = _f32(onehot), _f32(lam)
    lib = _lib()
    _check(lib.mau_out_smem_bytes(kdh, e, tk, _DTYPE_CODE[q.dtype])
           <= KERNEL_SMEM_MAX,
           f"dh={dh}, E={e} need more shared memory than the limit")
    seed = _seed_tensor(dropout_seed, dropout_rate, q.device)
    seed_ptr, thresh, dscale = _drop_args(seed, dropout_rate)
    out = torch.empty((b, tq, h * kdh), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.mau_out_fwd(*_seq(q), *_seq(k), *_seq(v), km.data_ptr(),
                             oh.data_ptr(), lamf.data_ptr(), mf.data_ptr(),
                             lf.data_ptr(), seed_ptr, thresh, dscale,
                             out.data_ptr(), b, tq, tk, h, kdh, e, int(causal),
                             int(diag_reset), 1.0 / dh ** 0.5,
                             _DTYPE_CODE[q.dtype], _stream(q.device))
    _raise_on(rc, "mau_modulated_out", _lib().mau_streamed_error_string)
    mau_modulated_out.launches += 1
    return _unpad_heads(out, h, dh)


mau_modulated_out.launches = 0


def _streamed_forward(q, k, v, t, key_mask, intervals, onehot, wd, bd, w,
                      scaling, *, causal: bool, diag_reset: bool,
                      dropout_rate: float, dropout_seed, num_heads: int,
                      block_k: int = 512) -> BlockedForward:
    """The three forward kernels, with the intermediates the backward
    keeps (``mau_blocked_forward``'s contract)."""
    m, l, su = mau_stats(q, k, t, key_mask, causal=causal,
                         num_heads=num_heads)
    lam = mau_intensity(su, intervals, wd, bd, w, scaling)
    out = mau_modulated_out(q, k, v, key_mask, onehot, lam, m, l,
                            causal=causal, diag_reset=diag_reset,
                            dropout_rate=dropout_rate,
                            dropout_seed=dropout_seed, num_heads=num_heads)
    return BlockedForward(out, lam, m, l, su)


# ---------------------------------------------------------------- backward


def _bwd_fits(lib, which: int, name: str, dh: int, e: int, dtype,
              tk: int = 0):
    _check(dh in KERNEL_BWD_HEAD_DIMS,
           f"{name}: head dim {dh} not in {KERNEL_BWD_HEAD_DIMS}")
    _check(e <= KERNEL_BWD_EVENTS_MAX,
           f"{name}: E={e} above {KERNEL_BWD_EVENTS_MAX}")
    _check(lib.mau_streamed_bwd_smem_bytes(which, dh, e, tk,
                                           _DTYPE_CODE[dtype])
           <= KERNEL_SMEM_MAX,
           f"{name}: dh={dh}, E={e} need more shared memory than the limit")


def _attention_bwd_args(name, q, kv, key_mask, onehot, stats, g_out,
                        num_heads):
    """Checks the attention-side backward kernels' inputs; returns (b, tq,
    tk, dh, e, the sequences (q, k, v[, t], g_out in q's dtype; in bf16
    with rows on 16-byte boundaries), the key mask in fp32, the one-hot,
    the stats). In bf16 the one-hot and lam (the first of ``stats``, where
    given) are bf16 rounded and zero-padded to a multiple of 64 events, as
    the tensor-core kernels read them; else everything is fp32."""
    b, tq, tk, dh = _checked_seqs(q, kv, num_heads)
    h, e = num_heads, onehot.shape[-1]
    _check(tuple(key_mask.shape) == (b, tk), f"{name}: key_mask shape")
    _check(tuple(onehot.shape) == (b, tk, e), f"{name}: onehot shape")
    for label, x in stats:
        _check(tuple(x.shape[:3]) == (b, h, tq), f"{name}: {label} shape")
    _check(tuple(g_out.shape) == tuple(q.shape), f"{name}: g_out shape")
    go = g_out.detach().to(q.dtype)
    if go.stride(2) != 1:
        go = go.contiguous()
    seqs = [q] + [x for _, x in kv] + [go]
    stats = [x for _, x in stats]
    if q.dtype == torch.bfloat16:
        seqs = [_rows16(x) for x in seqs]
        oh = _bf16_events(onehot)
        if stats and stats[0].dim() == 4:   # lam
            stats[0] = _bf16_events(stats[0])
    else:
        oh = _f32(onehot)
    return (b, tq, tk, dh, e, seqs, _f32(key_mask), oh,
            [x if x.dtype == torch.bfloat16 else _f32(x) for x in stats])


def mau_glam(q, k, v, key_mask, onehot, m, l, g_out, *, causal: bool = False,
             diag_reset: bool = False, dropout_rate: float = 0.0,
             dropout_seed=None, num_heads: int, block_k: int = 512):
    """Backward pass 1: d(lambda) of the modulation, (B, H, Tq, E) fp32,
    from g_out (B, Tq, C). CPU tensors: ``mau_blocked.glam_reference``;
    CUDA tensors: ``mau_glam_tc_kernel`` (bf16: heads zero-padded to 64
    channels, the one-hot to 64-event tiles, the key tiles of
    ``streamed_visited_tiles`` only) or ``mau_glam_kernel`` (fp32)."""
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("mau_streamed: dropout_rate > 0 needs dropout_seed")
    if not _on_card("mau_glam", q, k, v, key_mask, onehot, m, l, g_out,
                    entry="mau_streamed"):
        return glam_reference(q, k, v, key_mask, onehot, m, l, g_out,
                              causal=causal, diag_reset=diag_reset,
                              dropout_rate=dropout_rate,
                              dropout_seed=dropout_seed, num_heads=num_heads,
                              block_k=block_k)
    dh, e = q.shape[-1] // num_heads, onehot.shape[-1]
    _check(dh in KERNEL_BWD_HEAD_DIMS,
           f"mau_glam: head dim {dh} not in {KERNEL_BWD_HEAD_DIMS}")
    if q.dtype == torch.bfloat16:   # the wgmma kernel's 64-wide tiles
        q, k, v, g_out = (_pad_heads(x, num_heads) for x in (q, k, v, g_out))
        onehot = _bf16_events(onehot)
    b, tq, tk, kdh, _, seqs, km, oh, (mf, lf) = _attention_bwd_args(
        "mau_glam", q, (("k", k), ("v", v)), key_mask, onehot,
        (("m", m), ("l", l)), g_out, num_heads)
    lib = _bwd_lib()
    _bwd_fits(lib, _GLAM, "mau_glam", kdh, e, q.dtype, tk)
    seed = _seed_tensor(dropout_seed, dropout_rate, q.device)
    seed_ptr, thresh, dscale = _drop_args(seed, dropout_rate)
    glam = torch.empty((b, num_heads, tq, e), dtype=torch.float32,
                       device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.mau_glam_bwd(*(a for x in seqs for a in _seq(x)),
                              km.data_ptr(), oh.data_ptr(), mf.data_ptr(),
                              lf.data_ptr(), seed_ptr, thresh, dscale,
                              glam.data_ptr(), b, tq, tk, num_heads, kdh, e,
                              int(causal), int(diag_reset), 1.0 / dh ** 0.5,
                              _DTYPE_CODE[q.dtype], _stream(q.device))
    _raise_on(rc, "mau_glam", _lib().mau_streamed_error_string)
    mau_glam.launches += 1
    return glam


mau_glam.launches = 0


def mau_intensity_bwd(su, intervals, wd, bd, w, scaling, g_lam):
    """The intensity head's fp32 VJP at g_lam (B, H, Tq, E): (g_su
    (B, H, Tq, dh), gWd (dh+1, E*dh), gbd (E*dh,), gw (E, dh), gscaling
    (E,)), all fp32. CPU tensors: ``mau_blocked.intensity_vjp_reference``;
    CUDA tensors: ``mau_int_bwd_rows_tc_kernel`` then
    ``mau_int_bwd_cols_tc_kernel`` (one launch of the wrapper), whose
    products run on the tensor cores in three bf16 products of a hi/lo
    split of each fp32 operand (about 2^-16 of |a||b| a term)."""
    if not _on_card("mau_intensity_bwd", su, intervals, wd, bd, w, scaling,
                    g_lam, entry="mau_streamed"):
        return intensity_vjp_reference(su, intervals, wd, bd, w, scaling,
                                       g_lam)
    b, h, tq, dh = su.shape
    e = w.shape[0]
    _check(tuple(intervals.shape) == (b, tq), "intervals shape")
    _check(tuple(wd.shape) == (dh + 1, e * dh), "wd shape")
    _check(tuple(bd.shape) == (e * dh,), "bd shape")
    _check(tuple(w.shape) == (e, dh), "w shape")
    _check(tuple(scaling.shape) == (e,), "scaling shape")
    _check(tuple(g_lam.shape) == (b, h, tq, e), "g_lam shape")
    lib = _bwd_lib()
    for which in (_INT_ROWS, _INT_COLS):
        _bwd_fits(lib, which, "mau_intensity_bwd", dh, e, torch.float32)
    # contiguous fp32, at 16-byte boundaries for the kernels' vector loads
    suf, iv, wdf, bdf, wf, scf, gl = (
        x if x.data_ptr() % 16 == 0 else x.clone() for x in (
            _f32(y) for y in (su, intervals, wd, bd, w, scaling, g_lam)))
    f32 = dict(dtype=torch.float32, device=su.device)
    g_su = torch.empty((b, h, tq, dh), **f32)
    g_raw = torch.empty((b * h * tq, e), **f32)
    g_wd = torch.zeros((dh + 1, e * dh), **f32)
    g_bd, g_w = torch.zeros((e * dh,), **f32), torch.zeros((e * dh,), **f32)
    g_sc = torch.zeros((e,), **f32)
    with torch.cuda.device(su.device):
        rc = lib.mau_intensity_bwd(
            suf.data_ptr(), iv.data_ptr(), wdf.data_ptr(), bdf.data_ptr(),
            wf.data_ptr(), scf.data_ptr(), gl.data_ptr(), g_raw.data_ptr(),
            g_su.data_ptr(), g_wd.data_ptr(), g_bd.data_ptr(),
            g_w.data_ptr(), g_sc.data_ptr(), b, h, tq, dh, e,
            _stream(su.device))
    _raise_on(rc, "mau_intensity_bwd", _lib().mau_streamed_error_string)
    mau_intensity_bwd.launches += 1
    return g_su, g_wd, g_bd, g_w.reshape(e, dh), g_sc


mau_intensity_bwd.launches = 0


def _pass2_args(name, q, k, v, t, key_mask, onehot, lam, m, l, g_out, g_su,
                rho, num_heads):
    """The dq / dkvt kernels' arguments after their checks: (b, tq, tk, dh,
    e, the pointer and stride arguments, the tensors behind the pointers,
    which the caller keeps alive until the launch)."""
    _check(tuple(lam.shape) == (q.shape[0], num_heads, q.shape[1],
                                onehot.shape[-1]), f"{name}: lam shape")
    b, tq, tk, dh, e, seqs, km, oh, stats = _attention_bwd_args(
        name, q, (("k", k), ("v", v), ("t", t)), key_mask, onehot,
        (("lam", lam), ("m", m), ("l", l), ("rho", rho)), g_out, num_heads)
    _check(tuple(g_su.shape) == (b, num_heads, tq, dh),
           f"{name}: g_su shape")
    gsu = g_su.detach().to(q.dtype).contiguous()
    return (b, tq, tk, dh, e,
            [a for x in seqs for a in _seq(x)]
            + [x.data_ptr() for x in [gsu, km, oh] + stats],
            (seqs, gsu, km, oh, stats))


def mau_dq(q, k, v, t, key_mask, onehot, lam, m, l, g_out, g_su, rho, *,
           causal: bool = False, diag_reset: bool = False,
           dropout_rate: float = 0.0, dropout_seed=None, num_heads: int,
           block_k: int = 512):
    """Backward pass 2 (query-major): dQ (B, Tq, C) in q's dtype, from
    g_out (B, Tq, C), g_su (B, H, Tq, dh) fp32 (rounded to q's dtype for
    the products) and rho (B, H, Tq) fp32. CPU tensors:
    ``mau_blocked.dq_reference``; CUDA tensors: ``mau_dq_tc_kernel`` (bf16,
    on ``dkvt_tc_inputs``' padded operands, the key tiles of
    ``streamed_visited_tiles(..., visible_only=True)`` only) or
    ``mau_dq_kernel`` (fp32)."""
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("mau_streamed: dropout_rate > 0 needs dropout_seed")
    if not _on_card("mau_dq", q, k, v, t, key_mask, onehot, lam, m, l, g_out,
                    g_su, rho, entry="mau_streamed"):
        return dq_reference(q, k, v, t, key_mask, onehot, lam, m, l, g_out,
                            g_su, rho, causal=causal, diag_reset=diag_reset,
                            dropout_rate=dropout_rate,
                            dropout_seed=dropout_seed, num_heads=num_heads,
                            block_k=block_k)
    dh = q.shape[-1] // num_heads
    if q.dtype == torch.bfloat16:   # the wgmma kernel's 64-wide tiles
        q, k, v, t, g_out, g_su, lam, onehot = dkvt_tc_inputs(
            q, k, v, t, g_out, g_su, lam, onehot, num_heads)
    b, tq, tk, kdh, e, args, alive = _pass2_args(
        "mau_dq", q, k, v, t, key_mask, onehot, lam, m, l, g_out, g_su, rho,
        num_heads)
    lib = _bwd_lib()
    _bwd_fits(lib, _DQ, "mau_dq", kdh, e, q.dtype, tk)
    seed = _seed_tensor(dropout_seed, dropout_rate, q.device)
    seed_ptr, thresh, dscale = _drop_args(seed, dropout_rate)
    dq = torch.empty((b, tq, num_heads * kdh), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.mau_dq_bwd(*args, seed_ptr, thresh, dscale, dq.data_ptr(), b,
                            tq, tk, num_heads, kdh, e, int(causal),
                            int(diag_reset), 1.0 / dh ** 0.5,
                            _DTYPE_CODE[q.dtype], _stream(q.device))
    _raise_on(rc, "mau_dq", _lib().mau_streamed_error_string)
    mau_dq.launches += 1
    return _unpad_heads(dq, num_heads, dh)


mau_dq.launches = 0


def mau_dkvt(q, k, v, t, key_mask, onehot, lam, m, l, g_out, g_su, rho, *,
             causal: bool = False, diag_reset: bool = False,
             dropout_rate: float = 0.0, dropout_seed=None, num_heads: int,
             block_k: int = 512):
    """Backward pass 3 (key-major): (dK, dV, dT), each (B, Tk, C) in q's
    dtype; the arguments of ``mau_dq``. CPU tensors:
    ``mau_blocked.dkvt_reference``; CUDA tensors: ``mau_dkvt_tc_kernel``
    (bf16, on ``dkvt_tc_inputs``' padded operands) or ``mau_dkvt_kernel``
    (fp32)."""
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("mau_streamed: dropout_rate > 0 needs dropout_seed")
    if not _on_card("mau_dkvt", q, k, v, t, key_mask, onehot, lam, m, l,
                    g_out, g_su, rho, entry="mau_streamed"):
        return dkvt_reference(q, k, v, t, key_mask, onehot, lam, m, l, g_out,
                              g_su, rho, causal=causal, diag_reset=diag_reset,
                              dropout_rate=dropout_rate,
                              dropout_seed=dropout_seed, num_heads=num_heads,
                              block_k=block_k)
    dh = q.shape[-1] // num_heads
    if q.dtype == torch.bfloat16:   # the wgmma kernel's 64-wide tiles
        q, k, v, t, g_out, g_su, lam, onehot = dkvt_tc_inputs(
            q, k, v, t, g_out, g_su, lam, onehot, num_heads)
    b, tq, tk, kdh, e, args, alive = _pass2_args(
        "mau_dkvt", q, k, v, t, key_mask, onehot, lam, m, l, g_out, g_su, rho,
        num_heads)
    lib = _bwd_lib()
    _bwd_fits(lib, _DKVT, "mau_dkvt", kdh, e, q.dtype, tk)
    seed = _seed_tensor(dropout_seed, dropout_rate, q.device)
    seed_ptr, thresh, dscale = _drop_args(seed, dropout_rate)
    dk, dv, dt = (torch.empty((b, tk, num_heads * kdh), dtype=q.dtype,
                              device=q.device) for _ in range(3))
    with torch.cuda.device(q.device):
        rc = lib.mau_dkvt_bwd(*args, seed_ptr, thresh, dscale, dk.data_ptr(),
                              dv.data_ptr(), dt.data_ptr(), b, tq, tk,
                              num_heads, kdh, e, int(causal), int(diag_reset),
                              1.0 / dh ** 0.5, _DTYPE_CODE[q.dtype],
                              _stream(q.device))
    _raise_on(rc, "mau_dkvt", _lib().mau_streamed_error_string)
    mau_dkvt.launches += 1
    return tuple(_unpad_heads(x, num_heads, dh) for x in (dk, dv, dt))


def dkvt_tc_inputs(q, k, v, t, g_out, g_su, lam, onehot, num_heads: int):
    """The bf16 dq and dkvt kernels' operands: heads zero-padded to 64 channels
    (q, k, v, t, g_out (B, T, C); g_su (B, H, Tq, dh)) and lam / one-hot
    zero-padded to a multiple of 64 events, so that every tile is (64 x 64).
    Zero channels and events add nothing to a product; the padded outputs'
    extra channels are dropped by ``_unpad_heads``. Where the widths are
    already 64 (the EasyDGL-LC shape) the tensors come back as they are."""
    dh = q.shape[-1] // num_heads
    e = onehot.shape[-1]
    ep = -(-e // 64) * 64
    if dh < 64:
        q, k, v, t, g_out = (_pad_heads(x, num_heads)
                             for x in (q, k, v, t, g_out))
        g_su = F.pad(g_su, (0, 64 - dh))
    if ep != e:
        lam, onehot = F.pad(lam, (0, ep - e)), F.pad(onehot, (0, ep - e))
    return q, k, v, t, g_out, g_su, lam, onehot


def _unpad_heads(x, num_heads: int, dh: int):
    """(B, T, H * kdh) -> (B, T, H * dh): each head's first dh channels."""
    b, n, c = x.shape
    if c == num_heads * dh:
        return x
    return x.reshape(b, n, num_heads, -1)[..., :dh].reshape(b, n,
                                                              num_heads * dh)


mau_dkvt.launches = 0

KERNEL_OPS = BackwardOps(mau_glam, mau_intensity_bwd, mau_dq, mau_dkvt)
_MauStreamed = autograd_function("_MauStreamed", _streamed_forward,
                                 KERNEL_OPS)
STREAMED_KERNELS = (mau_stats, mau_intensity, mau_modulated_out, mau_glam,
                    mau_intensity_bwd, mau_dq, mau_dkvt)


def mau_streamed(q, k, v, t, key_mask, intervals, onehot, wd, bd, w,
                 scaling, causal: bool = False, diag_reset: bool = False,
                 dropout_rate: float = 0.0, *, num_heads: int,
                 dropout_seed=None, block_k: int = 512):
    """Long-context self-modulating attention, the natural-layout wire
    format of ``mau_attention``: q (B, Tq, C); k/v/t (B, Tk, C); key_mask
    (B, Tk); intervals (B, Tq); onehot (B, Tk, E); the intensity-head
    parameters. Returns (out (B, Tq, C) in q's dtype, mark_intensity
    (B, H, Tq, E) fp32). CPU tensors take ``mau_blocked`` (its autograd
    Function ``_MauBlocked`` under autograd); CUDA tensors launch the three
    forward kernels and, under autograd, ``_MauStreamed``'s backward
    kernels, or raise."""
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("mau_streamed: dropout_rate > 0 needs dropout_seed")
    diff = (q, k, v, t, wd, bd, w, scaling)
    if not _on_card("mau_streamed", q, k, v, t, key_mask, intervals, onehot,
                    wd, bd, w, scaling):
        return mau_blocked(q, k, v, t, key_mask, intervals, onehot, wd, bd, w,
                           scaling, causal, diag_reset, dropout_rate,
                           num_heads=num_heads, dropout_seed=dropout_seed,
                           block_k=block_k)
    cfg = (causal, diag_reset, dropout_rate, num_heads, block_k)
    if differentiable(*diff):
        dh = q.shape[-1] // num_heads
        _check(dh in KERNEL_BWD_HEAD_DIMS,
               f"mau_streamed: training needs a head dim in "
               f"{KERNEL_BWD_HEAD_DIMS}, not {dh}")
        return _MauStreamed.apply(q, k, v, t, key_mask, intervals, onehot,
                                  wd, bd, w, scaling, dropout_seed, cfg)
    res = _streamed_forward(q, k, v, t, key_mask, intervals, onehot, wd, bd,
                            w, scaling, causal=causal, diag_reset=diag_reset,
                            dropout_rate=dropout_rate,
                            dropout_seed=dropout_seed, num_heads=num_heads,
                            block_k=block_k)
    return res.out, res.lam
