"""PyTorch port: flash attention (``easydgl_tpu_torch.kernels.flash_attention``)
vs the JAX package, on the CPU.

The plain forward (out and lse), the forward wrapper's CPU branch and the
plain backward pieces (dq, dk/dv) against JAX ``flash_attention_reference``
and against JAX ``flash_attention`` in interpret mode (``block_q=16,
block_k=128``, as the JAX package's own tests run it) and ``jax.vjp`` of it: causal and not, lengths that are not
multiples of a tile, Tq != Tk, left-padded rows and a fully masked row, dh 8
and 64, fp32 to 1e-5. Then ``_FlashAttention``'s backward with dropout
against autograd of the plain forward; the dropout mask read back from the
forward, dq and dk/dv (keep fraction, rescale, one mask); the backward
wrapper ``flash_attention_bwd`` on CPU tensors against ``jax.vjp``;
property tests of the backward's and the forward's tile schedules
(``flash_live_tiles``, ``flash_visited_tiles``); and the CPU dispatch
(plain versions, counters untouched). Inputs come from numpy seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from easydgl_tpu.kernels import flash_attention as jflash
from easydgl_tpu_torch.kernels import flash_attention as flash
from easydgl_tpu_torch.kernels.flash_attention import (
    FLASH_KERNELS, TILE, flash_attention, flash_attention_bwd,
    flash_attention_fwd, flash_attention_reference, flash_bwd_reference,
    flash_delta, flash_dkv_reference, flash_dq_reference, flash_fwd_reference,
    flash_live_tiles, flash_visited_tiles)
from easydgl_tpu_torch.kernels.mau_attention import dropout_factor

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)


def _data(seed, b=2, h=2, tq=37, tk=37, dh=8):
    """q, k, v, dO ~ N(0, 1); a key mask with holes, left-padded where
    Tq == Tk, with row 0 fully masked."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, tq, dh)).astype(np.float32)
    k = rng.standard_normal((b, h, tk, dh)).astype(np.float32)
    v = rng.standard_normal((b, h, tk, dh)).astype(np.float32)
    dout = rng.standard_normal((b, h, tq, dh)).astype(np.float32)
    km = (rng.random((b, tk)) > 0.2).astype(np.float32)
    if tq == tk:
        km[:, :5] = 0.0
    km[0] = 0.0
    return q, k, v, km, dout


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


CASES = [  # (seed, tq, tk, dh, causal)
    (0, 37, 37, 8, False), (1, 37, 37, 8, True), (2, 48, 48, 64, True),
    (3, 24, 40, 8, True), (4, 40, 24, 64, False)]


@pytest.mark.parametrize("seed,tq,tk,dh,causal", CASES)
def test_forward_matches_jax(seed, tq, tk, dh, causal):
    """The plain forward and the forward wrapper's CPU branch against the
    JAX reference and the JAX kernel in interpret mode: out and lse at
    1e-5, out exactly 0 on the dead row."""
    q, k, v, km, _ = _data(seed, tq=tq, tk=tk, dh=dh)
    want = jflash.flash_attention_reference(q, k, v, km, causal=causal)
    kern, (*_, lse_j) = jflash._flash_fwd(
        q, k, v, km, 0, 1.0 / dh ** 0.5, causal, 0.0, (16, 128), True)
    for out, lse in (flash_fwd_reference(*_t(q, k, v, km), causal=causal),
                     flash_attention_fwd(*_t(q, k, v, km), causal=causal)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(out.numpy(), np.asarray(kern), **TOL)
        lse_want = np.asarray(lse_j)[:, :tq, 0].reshape(lse.shape)
        np.testing.assert_allclose(lse.numpy(), lse_want, **TOL)
        assert float(out[0].abs().max()) == 0.0          # the dead row
        assert float(lse[0].max()) < -1e37


@pytest.mark.parametrize("seed,tq,tk,dh,causal", CASES)
def test_backward_pieces_match_jax_vjp(seed, tq, tk, dh, causal):
    """dq and dk/dv from the plain forward's lse and delta against jax.vjp
    of the interpret-mode kernel at the same cotangent."""
    q, k, v, km, dout = _data(seed, tq=tq, tk=tk, dh=dh)
    tq_, tk_, tv_, tkm, tdo = _t(q, k, v, km, dout)
    out, lse = flash_fwd_reference(tq_, tk_, tv_, tkm, causal=causal)
    delta = flash_delta(tdo, out)
    args = (tq_, tk_, tv_, tkm, tdo, lse, delta)
    dq = flash_dq_reference(*args, causal=causal)
    dk, dv = flash_dkv_reference(*args, causal=causal)
    _, vjp = jax.vjp(lambda a, b, c: jflash.flash_attention(
        a, b, c, km, causal=causal, block_q=16, block_k=128,
        interpret=True), q, k, v)
    for got, want in zip((dq, dk, dv), vjp(jnp.asarray(dout))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for g in (dq, dk, dv):
        assert float(g[0].abs().max()) == 0.0


def _jax_vjp(q, k, v, km, dout, causal):
    _, vjp = jax.vjp(lambda a, b, c: jflash.flash_attention(
        a, b, c, km, causal=causal, block_q=16, block_k=128,
        interpret=True), q, k, v)
    return vjp(jnp.asarray(dout))


@pytest.mark.parametrize("seed,tq,tk,dh,causal", CASES)
def test_backward_wrapper_on_cpu_matches_jax_vjp(seed, tq, tk, dh, causal):
    """``flash_attention_bwd`` on CPU tensors (``flash_bwd_reference``)
    from the plain forward's lse and delta against jax.vjp of the
    interpret-mode kernel: dq, dk and dv at 1e-5, exact zeros on the dead
    row."""
    q, k, v, km, dout = _data(seed, tq=tq, tk=tk, dh=dh)
    tq_, tk_, tv_, tkm, tdo = _t(q, k, v, km, dout)
    out, lse = flash_fwd_reference(tq_, tk_, tv_, tkm, causal=causal)
    grads = flash_attention_bwd(tq_, tk_, tv_, tkm, tdo, lse,
                                flash_delta(tdo, out), causal=causal)
    for got, want in zip(grads, _jax_vjp(q, k, v, km, dout, causal)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for g in grads:
        assert float(g[0].abs().max()) == 0.0


@st.composite
def _tile_masks(draw):
    """(key mask (B, Tk) with left padding, holes and all-masked rows, Tq,
    causal)."""
    b = draw(st.integers(1, 3))
    tk = draw(st.integers(1, 3 * TILE + 5))
    tq = draw(st.one_of(st.just(tk), st.integers(1, 3 * TILE + 5)))
    rows = []
    for _ in range(b):
        pad = draw(st.integers(0, tk))     # tk: a row of padding
        holes = draw(st.lists(st.integers(0, tk - 1), max_size=8))
        row = np.arange(tk) >= pad
        row[holes] = False
        rows.append(row)
    return np.stack(rows).astype(np.float32), tq, draw(st.booleans())


@settings(max_examples=60, deadline=None)
@given(_tile_masks())
def test_visited_tiles_cover_every_visible_pair(case):
    """The backward's schedule: every visible (query, key) pair lies in a
    visited (query tile, key tile), and no dead key tile holds one; a full
    tile has every key visible."""
    km, tq, causal = case
    b, tk = km.shape
    live = flash_live_tiles(torch.tensor(km))
    visited = flash_visited_tiles(live, tq, causal).numpy()
    live = live.numpy()
    vis = np.broadcast_to(km[:, None, :] > 0, (b, tq, tk))
    if causal:
        vis = vis & np.tril(np.ones((tq, tk), bool))
    bi, qi, kj = np.nonzero(vis)
    assert visited[bi, qi // TILE, kj // TILE].all()
    assert (live[bi, kj // TILE] > 0).all()     # no dead tile holds one
    nkt = -(-tk // TILE)
    tiles = np.zeros((b, nkt * TILE), bool)
    tiles[:, :tk] = km > 0
    tiles = tiles.reshape(b, nkt, TILE)
    assert ((live == 0) == ~tiles.any(-1)).all()
    assert ((live == 2) == tiles.all(-1)).all()
    assert not visited.transpose(0, 2, 1)[live == 0].any()


def _forward_schedule(live, tq, causal):
    """(B, nqt, nkt) bool: the (query tile, key tile) pairs the forward
    kernels compute, as their loops walk them: query tile qt (queries
    [64 qt, 64 qt + 64) within Tq) takes the key tiles kt with a live code
    (``flash_live_tiles``) and, under causal, a first key at or before the
    tile's last query."""
    b, nkt = live.shape
    nqt = -(-tq // TILE)
    seen = np.zeros((b, nqt, nkt), bool)
    for qt in range(nqt):
        last = min(TILE * qt + TILE, tq) - 1
        top = min(nkt, last // TILE + 1) if causal else nkt
        seen[:, qt, :top] = live[:, :top] > 0
    return seen


@settings(max_examples=60, deadline=None)
@given(_tile_masks())
def test_forward_visits_every_visible_pair(case):
    """The forward's schedule: every visible (query, key) pair lies in a
    visited (query tile, key tile), no dead key tile is visited, and the
    forward visits what the backward does (``flash_visited_tiles``)."""
    km, tq, causal = case
    b, tk = km.shape
    live = flash_live_tiles(torch.tensor(km)).numpy()
    seen = _forward_schedule(live, tq, causal)
    vis = np.broadcast_to(km[:, None, :] > 0, (b, tq, tk))
    if causal:
        vis = vis & np.tril(np.ones((tq, tk), bool))
    bi, qi, kj = np.nonzero(vis)
    assert seen[bi, qi // TILE, kj // TILE].all()
    assert not seen.transpose(0, 2, 1)[live == 0].any()
    backward = flash_visited_tiles(torch.tensor(live), tq, causal).numpy()
    assert (seen == backward).all()


@pytest.mark.parametrize("causal", [False, True])
def test_flash_function_backward_with_dropout(causal):
    """``_FlashAttention`` (the plain pieces on the CPU) against autograd of
    the plain forward, the same seed on both sides."""
    q, k, v, km, dout = _data(5, tq=29, tk=29, dh=8)
    kw = dict(causal=causal, dropout_rate=0.3, seed=11)

    def grads(fn):
        x = [t.requires_grad_() for t in _t(q, k, v)]
        out = fn(*x, torch.tensor(km), **kw)
        return out, torch.autograd.grad((out * torch.tensor(dout)).sum(), x)

    out, got = grads(flash_attention)
    ref_out, want = grads(flash_attention_reference)
    torch.testing.assert_close(out, ref_out, **TOL)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **TOL)


def test_dropout_is_one_mask():
    """With q = 0 (uniform probs 1/n over the n keys) and k = v = I, the
    forward's out, dq at dO = 1 and dv at dO = I each show the keep factor
    of every (i, j): out_ij = keep_ij / n, dq_ij = (keep_ij - delta_i) / n,
    dv_ji = keep_ij / n. All three equal ``dropout_factor``: values 0 or
    1/(1 - rate), kept with frequency ~ 1 - rate."""
    b, h, t, rate = 2, 3, 32, 0.25
    eye = torch.eye(t).expand(b, h, t, t).contiguous()
    q = torch.zeros(b, h, t, t)
    km = torch.ones(b, t)
    kw = dict(causal=False, dropout_rate=rate, seed=123, scale=1.0)
    out, lse = flash_fwd_reference(q, eye, eye, km, **kw)
    ones = torch.ones(b, h, t, t)
    delta = flash_delta(ones, out)
    dq = flash_dq_reference(q, eye, eye, km, ones, lse, delta, **kw)
    _, dv = flash_dkv_reference(q, eye, eye, km, eye, lse,
                                flash_delta(eye, out), **kw)
    keep = dropout_factor(123, (b, h, t, t), rate, "cpu")
    torch.testing.assert_close(out * t, keep)
    torch.testing.assert_close(dv.transpose(-1, -2) * t, keep)
    torch.testing.assert_close(dq * t + delta[..., None], keep)
    assert set(keep.unique().tolist()) == {0.0, float(np.float32(1 / (1 - rate)))}
    frac = float((keep > 0).float().mean())
    assert abs(frac - (1.0 - rate)) < 0.03   # 6144 draws: ~5 sigma
    # another seed, another mask
    other = flash_fwd_reference(q, eye, eye, km, **dict(kw, seed=124))[0]
    assert not torch.equal(other, out)


def test_cpu_tensors_take_the_plain_version():
    q, k, v, km, dout = _t(*_data(6, tq=20, tk=20, dh=8))
    for fn in FLASH_KERNELS:
        fn.launches = 0
    out, lse = flash_attention_fwd(q, k, v, km, causal=True)
    want_out, want_lse = flash_fwd_reference(q, k, v, km, causal=True)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    delta = flash_delta(dout, out)
    args = (q, k, v, km, dout, lse, delta)
    want = (flash_dq_reference(*args, causal=True),) + flash_dkv_reference(
        *args, causal=True)
    for got, ref in ((flash_attention_bwd(*args, causal=True), want),
                     (flash_bwd_reference(*args, causal=True), want)):
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    assert torch.equal(flash_attention(q, k, v, km, causal=True), want_out)
    assert all(fn.launches == 0 for fn in FLASH_KERNELS)
    with pytest.raises(ValueError, match="seed"):
        flash_attention(q, k, v, km, dropout_rate=0.1)


@pytest.mark.parametrize("wrapper", ["flash_attention_fwd", "mau_stats"])
def test_other_devices_raise(wrapper):
    """The one device rule the kernel wrappers share: a tensor on a device
    that is neither the CPU nor a card raises before any kernel is built."""
    from easydgl_tpu_torch.kernels.mau_streamed import mau_stats
    q, k, v, km, _ = (x.to("meta") for x in _t(*_data(6, tq=20, tk=20,
                                                       dh=8)))
    with pytest.raises(ValueError, match="unsupported device meta"):
        if wrapper == "mau_stats":
            b, h, t, dh = q.shape
            seq = q.transpose(1, 2).reshape(b, t, h * dh)
            mau_stats(seq, seq, seq, km, num_heads=h)
        else:
            flash_attention_fwd(q, k, v, km, causal=True)
    assert flash.NEG == jflash.NEG
