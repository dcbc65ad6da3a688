"""Streamed full-catalog NLL (port of ``easydgl_tpu.kernels.scoring``).

Every train step scores the B*masklen hidden rows against the whole
catalog through the tied embedding table, (N, C) @ (V, C)^T + bias, and
feeds a softmax loss. ``catalog_nll(hidden, table, bias, labels)`` returns
per row ``(lse, label_logit)`` without materialising the (N, V) logits on
the card: the CUDA kernels of ``csrc/catalog_nll.cu`` stream vocab tiles
(forward: online logsumexp and the label logit; backward: two recompute
passes for d_hidden and for d_table / d_bias, with
``g = dlse * softmax + dll * onehot``; in bf16 at C = 512 on ``wgmma``
with TMA-fed tiles, ``catalog_fwd_tc_kernel`` and
``catalog_bwd_tc_kernel``).

CPU tensors take ``catalog_nll_reference``, the plain version, which
materialises the logits; autograd differentiates it.
``catalog_nll_bwd_reference`` is the plain version of the backward, and
``catalog_nll_written_out`` the plain forward differentiated by it. CUDA
tensors launch the kernels or raise; ``catalog_nll_fwd.launches`` and
``catalog_nll_bwd.launches`` count the launches.

The backward skips rows whose gradient is exactly zero: a row with dlse = 0
and dll = 0 (a padded position, whose loss weight is 0) has g = 0 on every
vocab id. ``catalog_live_rows`` codes each 64-row tile from dlse and dll
with one reduction; a dead tile's d_hidden rows are 0 and it adds nothing
to d_table or d_bias, so the kernels compute nothing there.

The compute dtype is the table's (hidden and table alike): in bf16 the
products take bf16 operands and accumulate in fp32, g is rounded to bf16
before both backward products, and d_hidden and d_table are returned in
bf16 (as the TPU kernel returns them in its inputs' dtype); lse, the label
logit and d_bias are fp32. Vocab columns and rows outside (N, V) take no
part: the kernels mask their ragged edge rather than pad. The kernels take C
in whole 4-column vectors; any other C up to 512 (TGREC's is 50) is
zero-padded to the next multiple of 4 in the wrapper, exactly (a zero column
adds nothing to h . t), and the pad columns of d_hidden and d_table are
dropped. A table given as a strided view (GREC's untied head, the
transpose of its (C, V) kernel) is copied to a contiguous (V, C) table
once a call; the bias may be any learned (V,) vector.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from easydgl_tpu_torch.kernels import build
from easydgl_tpu_torch.kernels.mau_attention import _on_card, _raise_on

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_MAX_C = 512
C_VECTOR = 4               # the kernels read C in vectors of 4 columns
ROW_TILE = 64              # the rows a code of catalog_live_rows covers


def catalog_nll_reference(hidden, table, bias, labels
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: materialises the (N, V) fp32 logits. A label of -1
    (a row whose label lies in another rank's vocab slice,
    ``kernels/spmd.py``) has label logit 0, as in the kernels."""
    logits = hidden.float() @ table.float().t() + bias.float()
    lse = torch.logsumexp(logits, dim=-1)
    lab = labels.long()
    ll = torch.take_along_dim(logits, lab.clamp_min(0)[:, None], dim=1)[:, 0]
    return lse, torch.where(lab >= 0, ll, 0.0)


@torch.no_grad()
def catalog_nll_bwd_reference(hidden, table, bias, labels, lse, dlse, dll):
    """Plain version of the backward, written out: g = dlse * exp(s - lse)
    + dll * onehot(label), rounded to the compute dtype before both
    products; a row with label -1 takes no one-hot term. Returns
    (d_hidden in hidden's dtype, d_table in table's dtype, d_bias fp32)."""
    cdt = table.dtype
    logits = hidden.float() @ table.float().t() + bias.float()
    g = dlse.float()[:, None] * torch.exp(logits - lse.float()[:, None])
    lab = labels.long()
    rows = torch.nonzero(lab >= 0)[:, 0]
    g[rows, lab[rows]] += dll.float()[rows]
    gr = g.to(cdt).float()
    dh = gr @ table.float()
    dt = gr.t() @ hidden.float()
    return dh.to(hidden.dtype), dt.to(cdt), g.sum(0)


class _CatalogNLLWrittenOut(torch.autograd.Function):

    @staticmethod
    def forward(ctx, hidden, table, bias, labels):
        lse, ll = catalog_nll_reference(hidden, table, bias, labels)
        ctx.save_for_backward(hidden, table, bias, labels, lse)
        return lse, ll

    @staticmethod
    def backward(ctx, dlse, dll):
        hidden, table, bias, labels, lse = ctx.saved_tensors
        dh, dt, db = catalog_nll_bwd_reference(hidden, table, bias, labels,
                                               lse, dlse, dll)
        return dh, dt, db.to(bias.dtype), None


def catalog_nll_written_out(hidden, table, bias, labels):
    """``catalog_nll`` in plain ops on any device, differentiated by the
    written-out ``catalog_nll_bwd_reference`` (g rounded to the compute
    dtype before both products, as the kernels round it) rather than by
    autograd of ``catalog_nll_reference`` (g kept in fp32): the plain
    version a bf16 train step through the kernels is held to."""
    return _CatalogNLLWrittenOut.apply(hidden, table, bias, labels)


def catalog_live_rows(dlse: torch.Tensor, dll: torch.Tensor) -> torch.Tensor:
    """(ceil(N / 64),) int32 from the backward's cotangents (N,), one code a
    64-row tile: 0 where every row has dlse == 0 and dll == 0 (a dead tile:
    g is exactly 0 on each of its rows), 1 otherwise. Rows past N count as
    dead."""
    n = dlse.shape[0]
    nt = -(-n // ROW_TILE)
    live = torch.nn.functional.pad((dlse != 0) | (dll != 0),
                                   (0, nt * ROW_TILE - n))
    return live.view(nt, ROW_TILE).any(-1).int()


def _live_order(live: torch.Tensor) -> torch.Tensor:
    """(1 + T,) int32 on live's device, with no host sync: the number of
    live tiles, then their indices in order, then the dead ones."""
    idx = torch.argsort((live == 0).int(), stable=True)
    return torch.cat([live.sum().view(1), idx]).int().contiguous()


def catalog_nll(hidden, table, bias, labels):
    """(lse, label_logit) per row, fp32. hidden (N, C) and table (V, C) in
    the compute dtype; bias (V,) fp32; labels (N,) integer ids in [0, V),
    or -1: no column, so label logit 0 and no one-hot term in the
    backward (a label outside a rank's vocab slice, ``kernels/spmd.py``;
    ``easydgl_tpu/kernels/scoring.py:66-71`` matches no column either).
    Differentiable in hidden, table and bias."""
    if not _on_card("catalog_nll", hidden, table):
        return catalog_nll_reference(hidden, table, bias, labels)
    return _CatalogNLL.apply(hidden, table, bias, labels)


def catalog_nll_fwd(hidden, table, bias, labels):
    """The forward alone (no autograd): CPU tensors take the plain version,
    CUDA tensors launch the kernel or raise."""
    if not _on_card("catalog_nll_fwd", hidden, table):
        return catalog_nll_reference(hidden, table, bias, labels)
    return _launch_fwd(hidden, table, bias, labels)


catalog_nll_fwd.launches = 0


def catalog_nll_bwd(hidden, table, bias, labels, lse, dlse, dll):
    """The backward alone: (d_hidden, d_table, d_bias). CPU tensors take
    the plain version, CUDA tensors launch the kernel or raise."""
    if not _on_card("catalog_nll_bwd", hidden, table):
        return catalog_nll_bwd_reference(hidden, table, bias, labels, lse,
                                         dlse, dll)
    return _launch_bwd(hidden, table, bias, labels, lse, dlse, dll)


catalog_nll_bwd.launches = 0


class _CatalogNLL(torch.autograd.Function):

    @staticmethod
    def forward(ctx, hidden, table, bias, labels):
        lse, ll = _launch_fwd(hidden, table, bias, labels)
        ctx.save_for_backward(hidden, table, bias, labels, lse)
        return lse, ll

    @staticmethod
    def backward(ctx, dlse, dll):
        hidden, table, bias, labels, lse = ctx.saved_tensors
        dh, dt, db = _launch_bwd(hidden, table, bias, labels, lse, dlse, dll)
        return dh, dt, db.to(bias.dtype), None


# ---------------------------------------------------------------- launch


def _lib() -> ctypes.CDLL:
    lib = build.load("catalog_nll")
    p, i32 = ctypes.c_void_p, ctypes.c_int
    if lib.catalog_nll_fwd.argtypes is None:
        lib.catalog_nll_fwd.argtypes = [p] * 7 + [i32] * 5 + [p]
        lib.catalog_nll_fwd.restype = i32
        lib.catalog_nll_bwd.argtypes = [p] * 12 + [i32] * 6 + [p]
        lib.catalog_nll_bwd.restype = i32
        lib.catalog_splits.argtypes = [i32] * 4
        lib.catalog_splits.restype = i32
        lib.catalog_cuda_error_string.argtypes = [i32]
        lib.catalog_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"catalog_nll kernel: {msg}")


def _prep(hidden, table, bias, labels):
    dev, cdt = table.device, table.dtype
    _check(cdt in _DTYPE_CODE, f"table dtype {cdt} not float32/bfloat16")
    _check(hidden.dtype == cdt, f"hidden dtype {hidden.dtype} != table {cdt}")
    _check(hidden.dim() == 2 and table.dim() == 2, "hidden/table not 2-D")
    n, c = hidden.shape
    v = table.shape[0]
    _check(table.shape[1] == c, f"hidden C={c} != table C={table.shape[1]}")
    _check(1 <= c <= KERNEL_MAX_C, f"C={c} not in [1, {KERNEL_MAX_C}]")
    _check(tuple(bias.shape) == (v,) and tuple(labels.shape) == (n,),
           "bias (V,) / labels (N,) shape")
    for name, x in (("hidden", hidden), ("bias", bias), ("labels", labels)):
        _check(x.device == dev, f"{name} on {x.device}, table on {dev}")
    # zero-padded to whole vectors, contiguous, and at 16-byte boundaries
    # for the tensor maps
    pad = -c % C_VECTOR
    h, t = (x if x.data_ptr() % 16 == 0 else x.clone()
            for x in ((y.detach() if pad == 0 else
                       torch.nn.functional.pad(y.detach(), (0, pad)))
                      .contiguous() for y in (hidden, table)))
    b = bias.detach().float().contiguous()
    lab = labels.to(torch.int32).contiguous()
    return h, t, b, lab, n, v, c + pad


def _launch_fwd(hidden, table, bias, labels, splits=0):
    """The forward kernel and the merge of its vocab splits. The library
    picks the kernel and, where ``splits`` is 0, the number of splits."""
    h, t, b, lab, n, v, c = _prep(hidden, table, bias, labels)
    dev = t.device
    lib = _lib()
    with torch.cuda.device(dev):
        splits = splits or lib.catalog_splits(n, v, c, _DTYPE_CODE[t.dtype])
    _check(splits >= 1, "the library found no split count for this shape")
    lse = torch.empty(n, dtype=torch.float32, device=dev)
    ll = torch.empty(n, dtype=torch.float32, device=dev)
    part = torch.empty(3 * splits * n, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.catalog_nll_fwd(
            h.data_ptr(), t.data_ptr(), b.data_ptr(), lab.data_ptr(),
            lse.data_ptr(), ll.data_ptr(), part.data_ptr(), n, v, c, splits,
            _DTYPE_CODE[t.dtype], torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "catalog_nll", lib.catalog_cuda_error_string)
    catalog_nll_fwd.launches += 1
    return lse, ll


def _launch_bwd(hidden, table, bias, labels, lse, dlse, dll, splits=(0, 0)):
    """The backward kernels into zeroed fp32 accumulators, cast on the way
    out. The library picks the kernel and, where ``splits`` is (0, 0), how
    its two passes divide the work (d_hidden's vocab splits, d_table's
    row-tile splits)."""
    h, t, b, lab, n, v, c = _prep(hidden, table, bias, labels)
    dev, cdt = t.device, t.dtype
    f32 = lambda x: x.detach().to(device=dev, dtype=torch.float32).contiguous()  # noqa: E731
    lse_, dlse_, dll_ = f32(lse), f32(dlse), f32(dll)
    for name, x in (("lse", lse_), ("dlse", dlse_), ("dll", dll_)):
        _check(tuple(x.shape) == (n,), f"{name} shape {tuple(x.shape)}")
    live = catalog_live_rows(dlse_, dll_)
    order = _live_order(live)
    dh_acc = torch.zeros((n, c), dtype=torch.float32, device=dev)
    dt_acc = torch.zeros((v, c), dtype=torch.float32, device=dev)
    db = torch.zeros(v, dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.catalog_nll_bwd(
            h.data_ptr(), t.data_ptr(), b.data_ptr(), lab.data_ptr(),
            lse_.data_ptr(), dlse_.data_ptr(), dll_.data_ptr(),
            live.data_ptr(), order.data_ptr(), dh_acc.data_ptr(),
            dt_acc.data_ptr(), db.data_ptr(), n, v, c, *splits,
            _DTYPE_CODE[cdt], torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "catalog_nll", lib.catalog_cuda_error_string)
    catalog_nll_bwd.launches += 1
    c0 = hidden.shape[1]
    return dh_acc[:, :c0].to(hidden.dtype), dt_acc[:, :c0].to(cdt), db
