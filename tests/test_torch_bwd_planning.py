"""PyTorch port: the host-side planning of the two wgmma backward kernels,
on the CPU (the kernels run only on the card).

* ``mau_attention.int_plan``: the grid of the fused MAU backward's
  intensity-head kernel (128 Wd columns a block, chunks of 64-row tiles)
  covers every row tile exactly once, leaves no chunk empty and comes to
  about ``INT_WAVES`` waves of blocks; the flagship shape's plan by count;
* ``mau_attention.int_workspaces``: the shapes of the scratch that kernel
  reads and reduce-adds into, zero where it adds (dseq^T, dWd^T, the
  interval lane) and where the attention pass writes nothing (rows past
  B*H*Tq, events past E), and ``int_dwd`` reassembling dWd from them;
* ``mau_attention._wd_tiles``: bf16 Wd's seq_units lanes, zero-padded to the
  kernel's (64 x 128k) TMA boxes;
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
    (3 * 2 * 11, 384, 114)])
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


def test_int_dwd_reassembles_the_transposed_lanes():
    e, dh = 3, 16
    ws = ma.int_workspaces(64, 4, e, dh, torch.device("cpu"))
    g = torch.Generator().manual_seed(0)
    want = torch.randn(dh + 1, e * dh, generator=g)
    ws["dwd"][:e * dh, :dh] = want[:dh].t()
    ws["dwd"][:e * dh, dh:] = 7.0     # lanes past dh are not dWd's
    ws["dwd_iv"][:] = want[dh]
    got = ma.int_dwd(ws, e, dh)
    assert got.shape == (dh + 1, e * dh)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dh,e", [(64, 64), (16, 3), (32, 12)])
def test_wd_tiles_pad_the_seq_units_lanes(dh, e):
    g = torch.Generator().manual_seed(1)
    wd = torch.randn(dh + 1, e * dh, generator=g)
    tiles = ma._wd_tiles(wd, dh)
    n = e * dh
    assert tiles.shape == (64, -(-n // 128) * 128)
    assert tiles.dtype == torch.bfloat16
    assert torch.equal(tiles[:dh, :n], wd[:dh].to(torch.bfloat16))
    assert not tiles[dh:].any() and not tiles[:, n:].any()


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
