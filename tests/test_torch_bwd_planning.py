"""PyTorch port: the host-side planning of the two wgmma backward kernels,
on the CPU (the kernels run only on the card).

* ``mau_attention.int_plan``: the grid of the fused MAU backward's
  intensity-head kernel (128 Wd columns a block, chunks of 64-row tiles)
  covers every row tile exactly once, leaves no chunk empty and comes to
  about ``INT_WAVES`` waves of blocks; the flagship shape's plan by count;
* ``mau_attention.int_workspaces``: the shapes of the scratch that kernel
  reads and reduce-adds into, zero where it adds (dseq^T, dWd^T, the
  interval lane) and where the attention pass writes nothing (rows past
  B*H*Tq, events past E), and ``int_dwd`` reassembling dWd from them; 64
  lanes at dh <= 64, 128 at dh = 128 (CTSMA's heads);
* ``mau_attention._wd_tiles``: bf16 Wd's seq_units lanes, zero-padded to the
  kernel's (64 or 128 lanes x 128k columns) TMA boxes;
* ``mau_attention._bwd_query_chunk`` and ``bwd_smem_bytes``: the query rows
  a block of the attention kernel takes, by the shared memory of the modes
  that run (kPre and kPost in bf16, kFull in fp32), at the 227 KB edge;
* ``mau_streamed.dkvt_tc_inputs`` / ``_unpad_heads``: the streamed dkvt
  kernel's operands padded to 64-channel heads and 64-event tiles with
  zeros, and the padded outputs cut back; untouched at the EasyDGL-LC
  widths.
"""
import numpy as np
import pytest
import torch

from easydgl_tpu_torch.kernels import mau_attention as ma
from easydgl_tpu_torch.kernels import mau_streamed as ms


@pytest.mark.parametrize("rows,edh,sms", [
    (512 * 8 * 31, 4096, 132), (24, 64, 132), (66, 64, 132),
    (2 * 4 * 128, 256, 132), (1, 48, 1), (16 * 8 * 128, 4096, 132),
    (3 * 2 * 11, 384, 114), (512 * 4 * 30, 64 * 128, 132)])
def test_int_plan_covers_every_row_tile_once(rows, edh, sms):
    col_blocks, chunks, per = ma.int_plan(rows, edh, sms)
    tiles = -(-rows // 64)
    assert col_blocks * ma.INT_COLS >= edh > (col_blocks - 1) * ma.INT_COLS
    assert per >= 1 and chunks >= 1
    covered = np.zeros(tiles, dtype=int)
    for c in range(chunks):
        part = range(c * per, min((c + 1) * per, tiles))
        assert len(part) > 0                      # no chunk is empty
        covered[list(part)] += 1
    assert (covered == 1).all()
    if tiles >= ma.INT_WAVES * sms:               # enough tiles to fill
        blocks = col_blocks * chunks
        assert ma.INT_WAVES * sms * 0.9 <= blocks <= ma.INT_WAVES * sms * 1.1


def test_int_plan_at_the_flagship_train_shape():
    assert ma.int_plan(512 * 8 * 31, 64 * 64, 132) == (32, 33, 61)


def test_int_plan_at_the_ctsma_train_shape():
    """61,440 rows (B=512, H=4, T=30) by E*dh = 8,192 columns: one event a
    column block, 16 chunks of 60 tiles, every one of the 960 tiles in
    exactly one chunk."""
    assert ma.int_plan(512 * 4 * 30, 64 * 128, 132) == (64, 16, 60)
    assert 16 * 60 == -(-512 * 4 * 30 // 64)


def test_int_workspaces_shapes_and_zeros():
    rows, tk, e, dh = 70, 5, 5, 16
    ws = ma.int_workspaces(rows, tk, e, dh, torch.device("cpu"))
    assert ws["rows_pad"] == 128
    assert ws["x"].shape == (128, 64) and ws["x"].dtype == torch.bfloat16
    assert bool((ws["x"][rows:] == 0).all())
    assert ws["draw"].shape == (8, 128) and ws["draw"].dtype == torch.bfloat16
    assert bool((ws["draw"][e:] == 0).all())
    assert bool((ws["draw"][:, rows:] == 0).all())
    assert ws["probs"].shape == ws["dprobs"].shape == (rows, tk)
    assert ws["dseq"].shape == (64, 128) and not ws["dseq"].any()
    assert ws["dwd"].shape == (128, 64) and not ws["dwd"].any()
    assert ws["dwd_iv"].shape == (e * dh,) and not ws["dwd_iv"].any()
    for name in ("probs", "dprobs", "dseq", "dwd", "dwd_iv"):
        assert ws[name].dtype == torch.float32


def test_int_workspaces_take_128_lanes_at_dh128():
    """At dh = 128, x, dseq^T and dWd^T are two 64-lane halves wide; the
    rest is as at dh <= 64."""
    rows, tk, e, dh = 130, 30, 3, 128
    ws = ma.int_workspaces(rows, tk, e, dh, torch.device("cpu"))
    assert ma.int_lanes(dh) == 128 and ma.int_lanes(64) == 64
    assert ws["rows_pad"] == 192
    assert ws["x"].shape == (192, 128) and ws["x"].dtype == torch.bfloat16
    assert bool((ws["x"][rows:] == 0).all())
    assert ws["draw"].shape == (8, 192)
    assert bool((ws["draw"][e:] == 0).all())
    assert bool((ws["draw"][:, rows:] == 0).all())
    assert ws["probs"].shape == ws["dprobs"].shape == (rows, tk)
    assert ws["dseq"].shape == (128, 192) and not ws["dseq"].any()
    assert ws["dwd"].shape == (384, 128) and not ws["dwd"].any()
    assert ws["dwd_iv"].shape == (e * dh,) and not ws["dwd_iv"].any()


def test_int_dwd_reassembles_the_transposed_lanes():
    _check_int_dwd(3, 16)


def test_int_dwd_reassembles_128_lanes():
    _check_int_dwd(3, 128)


def _check_int_dwd(e, dh):
    ws = ma.int_workspaces(64, 4, e, dh, torch.device("cpu"))
    g = torch.Generator().manual_seed(0)
    want = torch.randn(dh + 1, e * dh, generator=g)
    ws["dwd"][:e * dh, :dh] = want[:dh].t()
    ws["dwd"][:e * dh, dh:] = 7.0     # lanes past dh are not dWd's
    ws["dwd_iv"][:] = want[dh]
    got = ma.int_dwd(ws, e, dh)
    assert got.shape == (dh + 1, e * dh)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dh,e", [(64, 64), (16, 3), (32, 12), (128, 3)])
def test_wd_tiles_pad_the_seq_units_lanes(dh, e):
    g = torch.Generator().manual_seed(1)
    wd = torch.randn(dh + 1, e * dh, generator=g)
    tiles = ma._wd_tiles(wd, dh)
    n = e * dh
    assert tiles.shape == (ma.int_lanes(dh), -(-n // 128) * 128)
    assert tiles.dtype == torch.bfloat16
    assert torch.equal(tiles[:dh, :n], wd[:dh].to(torch.bfloat16))
    assert not tiles[dh:].any() and not tiles[:, n:].any()


def test_bwd_query_chunk_at_dh128_by_the_modes_that_run():
    """bf16 at Tk = 128, dh = 128 (E = 64): kPre takes 271,360 bytes at 32
    query rows, past the 232,448 a block may use, and 221,056 at 16, so a
    block takes 16; kPost needs less than kPre. fp32 (kFull, with its Wd
    and dz chunks) fits at none of 32/16/8 there and is refused. At the
    CTSMA shape (Tq = Tk = 30) a block takes all 30 rows: kPre 106,944
    bytes, kFull 148,288."""
    lim = ma.KERNEL_SMEM_MAX
    assert ma.bwd_smem_bytes(32, 128, 128, 64, True) == 271360 > lim
    assert lim >= ma.bwd_smem_bytes(16, 128, 128, 64, True) == 221056
    assert ma._bwd_query_chunk(128, 128, 128, 64, True) == 16
    with pytest.raises(ValueError, match="shared"):
        ma._bwd_query_chunk(128, 128, 128, 64, False)
    assert ma.bwd_smem_bytes(30, 30, 128, 64, True) == 106944
    assert ma.bwd_smem_bytes(30, 30, 128, 64, False) == 148288
    assert ma._bwd_query_chunk(30, 30, 128, 64, True) == 30
    # the tensor-core path's bytes never exceed kFull's: kPre drops its
    # phase-3 chunks, kPost its g_out side
    for qc, tk, dh, e in ((32, 128, 64, 64), (8, 20, 16, 3), (31, 31, 64, 64),
                          (16, 128, 128, 64)):
        assert (ma.bwd_smem_bytes(qc, tk, dh, e, True)
                <= ma.bwd_smem_bytes(qc, tk, dh, e, False))


@pytest.mark.parametrize("dh,e", [(16, 4), (32, 12), (64, 70)])
def test_dkvt_tc_inputs_pad_with_zeros_and_cut_back(dh, e):
    b, tq, h = 2, 9, 3
    g = torch.Generator().manual_seed(2)
    seq = lambda: torch.randn(b, tq, h * dh, generator=g)  # noqa: E731
    q, k, v, t, go = (seq() for _ in range(5))
    gsu = torch.randn(b, h, tq, dh, generator=g)
    lam = torch.rand(b, h, tq, e, generator=g)
    oh = (torch.rand(b, tq, e, generator=g) < 0.3).float()
    out = ms.dkvt_tc_inputs(q, k, v, t, go, gsu, lam, oh, h)
    ep = -(-e // 64) * 64
    for x, y in zip(out[:5], (q, k, v, t, go)):
        assert x.shape == (b, tq, h * 64)
        heads = x.reshape(b, tq, h, 64)
        assert torch.equal(heads[..., :dh], y.reshape(b, tq, h, dh))
        assert not heads[..., dh:].any()
        assert torch.equal(ms._unpad_heads(x, h, dh), y)
    assert out[5].shape == (b, h, tq, 64)
    assert torch.equal(out[5][..., :dh], gsu) and not out[5][..., dh:].any()
    for x, y in zip(out[6:], (lam, oh)):
        assert x.shape[-1] == ep and torch.equal(x[..., :e], y)
        assert not x[..., e:].any()


def test_dkvt_tc_inputs_leave_the_lc_widths_alone():
    b, tq, h, dh, e = 1, 5, 2, 64, 64
    xs = [torch.zeros(b, tq, h * dh) for _ in range(5)]
    gsu, lam = torch.zeros(b, h, tq, dh), torch.zeros(b, h, tq, e)
    oh = torch.zeros(b, tq, e)
    out = ms.dkvt_tc_inputs(*xs, gsu, lam, oh, h)
    assert all(a is b_ for a, b_ in zip(out, (*xs, gsu, lam, oh)))
    assert ms._unpad_heads(xs[0], h, dh) is xs[0]
