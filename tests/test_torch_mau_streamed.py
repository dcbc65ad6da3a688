"""PyTorch port: the long-context MAU/BiMAU forward, on the CPU.

* the blocked plain version (``kernels/mau_blocked.py``) and its
  intermediates m, l, seq_units and lam against JAX ``mau_blocked``'s
  ``_fwd_impl`` at rate 0: causal and bidirectional, fp32 (atol = rtol =
  1e-5: sums of a few dozen fp32 terms in another order) and a bf16 compute
  dtype (both round the same operands at the same points; a sum taken in
  another order can flip one bf16 rounding, so 1e-2 of each output's
  largest entry), Tk not a multiple of block_k, a fully masked batch row,
  dh 8 and 128. At dh = 128 JAX's streamed kernel drops the interval term
  (ROADMAP.md C2), so there the oracles are ``mau_blocked`` and the XLA MAU;
* one small forward against JAX ``mau_streamed`` in Pallas interpret mode;
* the port's fused plain version at T <= 128 in fp32, values and autograd
  gradients, and at rate 0.1 the same dropout mask for one seed;
* the ``MAU`` module's streamed engine against the JAX XLA MAU;
* the CPU dispatch of ``mau_streamed`` and its three phase wrappers;
* the live-tile rule of the card's bf16 output, d-lambda and dk/dv/dt
  kernels (``streamed_key_plan``, ``streamed_visited_tiles``) against a
  direct count from the key mask, and its exactness on the plain versions:
  ``output_reference`` and ``glam_reference`` give each query tile the same
  rows when the K, V and one-hot rows of every key tile it skips are
  replaced by random values; the same for the rule's visible-only form,
  which the bf16 dq kernel visits, on ``dq_reference`` (K, V, T and one-hot
  rows replaced).

The CUDA kernels are held against these plain versions in
``test_torch_cuda.py`` (card only) and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easydgl_tpu.kernels import mau_blocked as jblocked
from easydgl_tpu.kernels.mau_streamed import mau_streamed as jstreamed
from easydgl_tpu.nn import temporal as jtemporal
from easydgl_tpu_torch.kernels.mau_attention import mau_attention_reference
from easydgl_tpu_torch.kernels.mau_blocked import (dq_reference,
                                                   glam_reference,
                                                   intensity_reference,
                                                   mau_blocked,
                                                   mau_blocked_forward,
                                                   output_reference,
                                                   stats_reference)
from easydgl_tpu_torch.kernels.mau_streamed import (mau_intensity,
                                                    mau_modulated_out,
                                                    mau_stats, mau_streamed,
                                                    streamed_key_plan,
                                                    streamed_visited_tiles)
from easydgl_tpu_torch.nn.temporal import MAU, BiMAU
from easydgl_tpu_torch.parity import flax_to_torch

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)
B, T, H, E, BK = 3, 37, 2, 4, 16


def _inputs(seed, *, t=T, dh=8):
    """(B, T, C) q/k/v/t, a left-padded key mask with row 0 fully masked,
    Exp(1) intervals, multi-hot marks, intensity parameters (numpy)."""
    rng = np.random.default_rng(seed)
    c, f32 = H * dh, np.float32
    q, k, v, tt = (rng.normal(size=(B, t, c)).astype(f32) for _ in range(4))
    lengths = rng.integers(1, t + 1, B)
    km = (np.arange(t)[None] >= t - lengths[:, None]).astype(f32)
    km[0] = 0.0
    iv = rng.exponential(1.0, (B, t)).astype(f32)
    oh = (rng.random((B, t, E)) < 0.3).astype(f32)
    wd = rng.normal(0, 0.2, (dh + 1, E * dh)).astype(f32)
    bd = rng.normal(0, 0.1, E * dh).astype(f32)
    w = rng.normal(0, 0.2, (E, dh)).astype(f32)
    sc = rng.normal(0, 0.3, E).astype(f32)
    return q, k, v, tt, km, iv, oh, wd, bd, w, sc


def _heads(x):
    b, t, c = x.shape
    return x.reshape(b, t, H, c // H).transpose(0, 2, 1, 3)


def _torch(args, dtype=torch.float32):
    ts = [torch.tensor(a) for a in args]
    return [x.to(dtype) if i < 4 else x for i, x in enumerate(ts)]


def _assert_scaled(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)


@pytest.mark.parametrize("causal,diag,dtype,dh", [
    (False, True, "float32", 8), (True, False, "float32", 8),
    (False, True, "bfloat16", 8), (True, False, "bfloat16", 8),
    (False, True, "float32", 128), (True, False, "float32", 128)])
def test_blocked_matches_jax_mau_blocked(causal, diag, dtype, dh):
    args = _inputs(3, dh=dh)
    q, k, v, t, km, iv, oh, wd, bd, w, sc = args
    jdt = jnp.dtype(dtype)
    jq, jk, jv, jt = (jnp.asarray(_heads(x)).astype(jdt) for x in (q, k, v, t))
    jo, jl, (jm, jll, jsu) = jblocked._fwd_impl(
        jq, jk, jv, jt, *(jnp.asarray(a) for a in (km, iv, oh, wd, bd, w, sc)),
        jnp.int32(0), causal, diag, 0.0, BK)
    got = mau_blocked_forward(*_torch(args, getattr(torch, dtype)),
                              causal=causal, diag_reset=diag, num_heads=H,
                              block_k=BK)
    jo = np.asarray(jo.astype(jnp.float32)).transpose(0, 2, 1, 3).reshape(
        q.shape)
    pairs = (("out", got.out, jo), ("lam", got.lam, jl),
             ("m", got.m, np.asarray(jm)[..., 0]),
             ("l", got.l, np.asarray(jll)[..., 0]), ("su", got.su, jsu))
    for name, a, b in pairs:
        a = a.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(a, np.asarray(b), err_msg=name, **TOL)
        else:
            _assert_scaled(a, b, 1e-2, name)
    assert got.out.dtype == getattr(torch, dtype)
    # the fully masked row 0 attends uniformly over its T real keys
    np.testing.assert_array_equal(got.l[0].numpy(), np.full((H, T), T,
                                                            np.float32))


def test_blocked_matches_jax_streamed_kernel_in_interpret_mode():
    args = _inputs(5, t=19)
    q, k, v, t, km, iv, oh, wd, bd, w, sc = args
    jo, jl = jstreamed(*(jnp.asarray(_heads(x)) for x in (q, k, v, t)),
                       *(jnp.asarray(a) for a in (km, iv, oh, wd, bd, w, sc)),
                       causal=False, diag_reset=True, interpret=True)
    out, lam = mau_blocked(*_torch(args), False, True, num_heads=H,
                           block_k=8)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jo).transpose(0, 2, 1, 3).reshape(q.shape),
        **TOL)
    np.testing.assert_allclose(lam.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("causal,diag", [(False, True), (True, False)])
def test_blocked_matches_fused_plain_version(causal, diag):
    """T <= 128 in fp32: values, every autograd gradient (to 1e-5 of its
    largest entry), and at rate 0.1 the same dropout mask for one seed."""
    args = _inputs(7)
    diff = [torch.tensor(a, requires_grad=i not in (4, 5, 6))
            for i, a in enumerate(args)]
    g = np.random.default_rng(8)
    go = torch.tensor(g.normal(size=args[0].shape).astype(np.float32))
    gl = torch.tensor(g.normal(size=(B, H, T, E)).astype(np.float32))
    res = {}
    for name, fn, kw in (("blocked", mau_blocked, dict(block_k=BK)),
                         ("fused", mau_attention_reference, {})):
        out, lam = fn(*diff, causal=causal, diag_reset=diag, num_heads=H,
                      **kw)
        grads = torch.autograd.grad((out * go).sum() + (lam * gl).sum(),
                                    [x for x in diff if x.requires_grad])
        drop = fn(*diff, causal=causal, diag_reset=diag, dropout_rate=0.1,
                  dropout_seed=12345, num_heads=H, **kw)[0]
        res[name] = (out, lam, drop, grads)
    (o1, l1, d1, g1), (o2, l2, d2, g2) = res["blocked"], res["fused"]
    for a, b in ((o1, o2), (l1, l2), (d1, d2)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   **TOL)
    assert not torch.equal(d1, o1)
    for a, b in zip(g1, g2):
        _assert_scaled(a.numpy(), b.numpy(), 1e-5, "grad")


@pytest.mark.parametrize("dh", [8, 128])
def test_mau_module_streamed_engine_matches_jax_xla_mau(dh):
    rng = np.random.default_rng(11)
    c = H * dh
    x = rng.normal(size=(B, T, 3 * c)).astype(np.float32)
    _, _, _, _, km, iv, oh, *_ = _inputs(5, dh=dh)
    jm = jtemporal.MAU(c, H, E, 0.0, fused_qkvt=True, causal_default=False,
                       diag_reset=True, intensity_impl="xla")
    jx = jnp.asarray(x)
    params = jm.init({"params": jax.random.key(0)}, jx, jx, jnp.asarray(km),
                     jnp.asarray(iv), jnp.asarray(oh), deterministic=True)
    p = jax.tree.map(np.asarray, params["params"])
    p["intensity_dense_bias"] = rng.normal(0, 0.1, E * dh).astype(np.float32)
    p["intensity_scaling"] = rng.normal(0, 0.3, E).astype(np.float32)
    jo, jl = jm.apply({"params": p}, jx, jx, jnp.asarray(km), jnp.asarray(iv),
                      jnp.asarray(oh), deterministic=True)
    tm = BiMAU(3 * c, c, H, E, intensity_impl="streamed", block_k=BK)
    tm.load_state_dict(flax_to_torch({"params": p}))
    with torch.no_grad():
        to, tl = tm(*(torch.tensor(a) for a in (x, x, km, iv, oh)))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    # the interval term counts at dh = 128 (the JAX streamed kernel's C2)
    with torch.no_grad():
        _, tl0 = tm(*(torch.tensor(a) for a in
                      (x, x, km, np.zeros_like(iv), oh)))
    assert float((tl - tl0).abs().max()) > 1e-2
    with pytest.raises(ValueError, match="intensity_impl"):
        MAU(3 * c, c, H, E, intensity_impl="blocked")


def test_cpu_dispatch_takes_the_plain_versions():
    """CPU tensors launch nothing: ``mau_streamed`` equals ``mau_blocked``
    and each phase wrapper its plain sweep, bit for bit; dropout without a
    seed raises."""
    args = _torch(_inputs(9))
    q, k, v, t, km, iv, oh, wd, bd, w, sc = args
    counters = (mau_stats, mau_intensity, mau_modulated_out)
    before = [f.launches for f in counters]
    kw = dict(causal=True, num_heads=H, block_k=BK)
    got = mau_streamed(*args, True, False, 0.2, num_heads=H,
                       dropout_seed=3, block_k=BK)
    want = mau_blocked(*args, True, False, 0.2, num_heads=H, dropout_seed=3,
                       block_k=BK)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    m, l, su = mau_stats(q, k, t, km, **kw)
    for a, b in zip((m, l, su), stats_reference(q, k, t, km, **kw)):
        assert torch.equal(a, b)
    lam = mau_intensity(su, iv, wd, bd, w, sc)
    assert torch.equal(lam, intensity_reference(su, iv, wd, bd, w, sc))
    out = mau_modulated_out(q, k, v, km, oh, lam, m, l, dropout_rate=0.2,
                            dropout_seed=3, **kw)
    assert torch.equal(out, output_reference(q, k, v, km, oh, lam, m, l,
                                             dropout_rate=0.2,
                                             dropout_seed=3, **kw))
    assert torch.equal(out, got[0]) and torch.equal(lam, got[1])
    assert [f.launches for f in counters] == before
    with pytest.raises(ValueError, match="seed"):
        mau_streamed(*args, False, True, 0.1, num_heads=H)


def _tile_masks():
    """(B, Tk) key masks that exercise the live-tile rule: a fully masked
    row, a left-padded row whose first real key falls inside a tile, every
    key real, and holes (a tile with no real key between live ones)."""
    km = np.zeros((4, 200), np.float32)
    km[1, 70:] = 1.0
    km[2] = 1.0
    km[3, 5:40] = km[3, 150:] = 1.0
    return torch.tensor(km)


@pytest.mark.parametrize("tq,tk", [(150, 150), (128, 200), (200, 130)])
@pytest.mark.parametrize("causal", [False, True])
def test_live_tile_rule_matches_a_direct_count(causal, tq, tk):
    """The plan's tile codes and first real keys, counted directly; the
    visited (query tile, key tile) pairs hold every pair with a nonzero
    prob (a visible entry, or a row that sees no key and a real key: such a
    row is uniform over the real keys), and no other where Tq is a multiple
    of 64 (under causal a ragged last query tile takes its whole range)."""
    km = _tile_masks()[:, :tk]
    plan = streamed_key_plan(km)
    nkt, nqt = -(-tk // 64), -(-tq // 64)
    real = np.asarray(km) > 0
    assert plan.dtype == torch.int32 and tuple(plan.shape) == (4, nkt + 1)
    for b in range(4):
        firsts = np.flatnonzero(real[b])
        assert int(plan[b, -1]) == (firsts[0] if len(firsts) else tk)
        for kt in range(nkt):
            tile = real[b, 64 * kt:64 * kt + 64]
            want = 2 if tile.size == 64 and tile.all() else int(tile.any())
            assert int(plan[b, kt]) == want, (b, kt)
    i = np.arange(tq)[:, None]
    j = np.arange(tk)[None, :]
    vis = real[:, None, :] & ((j <= i) | (not causal))[None]   # (B, Tq, Tk)
    blind = ~vis.any(-1, keepdims=True)
    nonzero = vis | blind                                    # j < Tk always
    need = np.zeros((4, nqt, nkt), bool)
    for qt in range(nqt):
        for kt in range(nkt):
            need[:, qt, kt] = nonzero[:, 64 * qt:64 * qt + 64,
                                      64 * kt:64 * kt + 64].any((1, 2))
    got = streamed_visited_tiles(km, tq, causal).numpy()
    assert got.shape == need.shape
    assert not (need & ~got).any(), "a pair with a nonzero prob is skipped"
    if tq % 64 == 0:
        assert (got == need).all()


@pytest.mark.parametrize("causal,diag", [(False, True), (True, False)])
@pytest.mark.parametrize("piece", ["out", "glam", "stats"])
def test_live_tile_rule_is_exact_on_the_plain_versions(piece, causal, diag):
    """Each query tile's rows of ``output_reference`` / ``glam_reference``
    / ``stats_reference`` (m, l and seq_units) are unchanged (1e-6) when
    the K, V (T) and one-hot rows of every key tile it skips are random
    values: what the kernels leave out adds exactly 0."""
    rng = np.random.default_rng(11)
    km = _tile_masks()
    b, t, h, dh, e = 4, 200, 2, 8, 4
    q, k, v = (torch.tensor(rng.normal(size=(b, t, h * dh)),
                            dtype=torch.float32) for _ in range(3))
    oh = torch.tensor((rng.random((b, t, e)) < 0.3).astype(np.float32))
    lam = torch.tensor(rng.random((b, h, t, e)).astype(np.float32))
    g_out = torch.tensor(rng.normal(size=(b, t, h * dh)), dtype=torch.float32)
    m, l, _ = stats_reference(q, k, k, km, causal=causal, num_heads=h)
    kw = dict(causal=causal, diag_reset=diag, dropout_rate=0.1,
              dropout_seed=5, num_heads=h, block_k=64)

    def run(k, v, oh):
        if piece == "out":
            return output_reference(q, k, v, km, oh, lam, m, l, **kw)
        if piece == "stats":   # v stands for t
            return stats_reference(q, k, v, km, causal=causal, num_heads=h,
                                   block_k=64)
        return glam_reference(q, k, v, km, oh, m, l, g_out, **kw)

    want = run(k, v, oh)
    vis = streamed_visited_tiles(km, t, causal)
    assert not bool(vis.all())
    for qt in range(vis.shape[1]):
        k2, v2, oh2 = k.clone(), v.clone(), oh.clone()
        for bb, kt in (~vis[:, qt]).nonzero().tolist():
            rows = slice(64 * kt, 64 * kt + 64)
            for x in (k2, v2, oh2):
                x[bb, rows] = torch.tensor(
                    rng.normal(size=x[bb, rows].shape), dtype=torch.float32)
        got = run(k2, v2, oh2)
        rows = slice(64 * qt, 64 * qt + 64)
        if piece == "out":
            err = (got[:, rows] - want[:, rows]).abs().max()
        elif piece == "stats":
            err = max(float((a[:, :, rows] - b[:, :, rows]).abs().max())
                      for a, b in zip(got, want))
        else:
            err = (got[:, :, rows] - want[:, :, rows]).abs().max()
        assert float(err) <= 1e-6, (qt, float(err))


@pytest.mark.parametrize("tq,tk", [(150, 150), (128, 200), (200, 130)])
@pytest.mark.parametrize("causal", [False, True])
def test_visible_only_rule_matches_a_direct_count(causal, tq, tk):
    """The rule's visible-only form (the bf16 dq kernel's) holds every
    (query tile, key tile) pair with a visible entry, and no other where Tq
    is a multiple of 64: a row that sees no key visits nothing, and a tile
    with no real key is never visited."""
    km = _tile_masks()[:, :tk]
    nkt, nqt = -(-tk // 64), -(-tq // 64)
    real = np.asarray(km) > 0
    i = np.arange(tq)[:, None]
    j = np.arange(tk)[None, :]
    vis = real[:, None, :] & ((j <= i) | (not causal))[None]   # (B, Tq, Tk)
    need = np.zeros((4, nqt, nkt), bool)
    for qt in range(nqt):
        for kt in range(nkt):
            need[:, qt, kt] = vis[:, 64 * qt:64 * qt + 64,
                                  64 * kt:64 * kt + 64].any((1, 2))
    got = streamed_visited_tiles(km, tq, causal, visible_only=True).numpy()
    assert got.shape == need.shape
    assert not (need & ~got).any(), "a pair with a visible entry is skipped"
    assert not got[0].any(), "a batch row with no real key visits a tile"
    assert not (got & ~streamed_visited_tiles(km, tq, causal).numpy()).any()
    if tq % 64 == 0:
        assert (got == need).all()


@pytest.mark.parametrize("causal,diag", [(False, True), (True, False)])
def test_visible_only_rule_is_exact_on_dq_reference(causal, diag):
    """Each query tile's rows of ``dq_reference`` are unchanged (1e-6) when
    the K, V, T and one-hot rows of every key tile the visible-only rule
    skips for it are random values: what the bf16 dq kernel leaves out,
    blind rows' tiles included, adds exactly 0."""
    rng = np.random.default_rng(12)
    km = _tile_masks()
    b, t, h, dh, e = 4, 200, 2, 8, 4

    def normal(*shape, std=1.0):
        return torch.tensor(rng.normal(0, std, shape), dtype=torch.float32)

    q, k, v, tt = (normal(b, t, h * dh) for _ in range(4))
    oh = torch.tensor((rng.random((b, t, e)) < 0.3).astype(np.float32))
    lam = torch.tensor(rng.random((b, h, t, e)).astype(np.float32))
    g_out, g_su = normal(b, t, h * dh), normal(b, h, t, dh, std=0.1)
    rho = normal(b, h, t, std=0.1)
    m, l, _ = stats_reference(q, k, tt, km, causal=causal, num_heads=h)
    kw = dict(causal=causal, diag_reset=diag, dropout_rate=0.1,
              dropout_seed=5, num_heads=h, block_k=64)

    def run(k, v, tt, oh):
        return dq_reference(q, k, v, tt, km, oh, lam, m, l, g_out, g_su, rho,
                            **kw)

    want = run(k, v, tt, oh)
    vis = streamed_visited_tiles(km, t, causal, visible_only=True)
    assert not bool(vis.all())
    for qt in range(vis.shape[1]):
        xs = [x.clone() for x in (k, v, tt, oh)]
        for bb, kt in (~vis[:, qt]).nonzero().tolist():
            rows = slice(64 * kt, 64 * kt + 64)
            for x in xs:
                x[bb, rows] = torch.tensor(
                    rng.normal(size=x[bb, rows].shape), dtype=torch.float32)
        got = run(*xs)
        rows = slice(64 * qt, 64 * qt + 64)
        err = float((got[:, rows] - want[:, rows]).abs().max())
        assert err <= 1e-6, (qt, err)
    assert float(want[0].abs().max()) == 0.0   # no real key: no gradient
