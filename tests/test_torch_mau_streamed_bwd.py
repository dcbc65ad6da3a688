"""PyTorch port: the long-context MAU/BiMAU backward, on the CPU.

* ``_MauBlocked``'s gradients (dq, dk, dv, dt, dWd, dbd, dw, dscaling, with
  non-zero cotangents for both out and mark_intensity) against ``jax.vjp``
  of JAX ``mau_blocked`` at rate 0: BiMAU and causal, dh 8 and 128, Tk not a
  multiple of block_k, a fully masked batch row and left-padded rows that
  see no key under causal. fp32; each leaf within 1e-5 of its largest entry
  (fp32 sums of a few dozen terms taken in another order);
* at one tiny shape with dh = 8 (never dh % 128 == 0, ROADMAP.md C2) the
  same against JAX ``mau_streamed``'s VJP in Pallas interpret mode;
* at dropout 0.1 with one seed, ``_MauBlocked`` against autograd through
  the plain forward's ops, and each of the four plain backward pieces
  against its slice of that result (1e-5 of each output's largest entry);
* the CPU dispatch under autograd: no kernel counter moves, and each new
  wrapper equals its plain version bit for bit;
* the card's intensity VJP runs its products on the tensor cores in three
  bf16 products of a hi/lo split of each fp32 operand (``split_bf16x2``
  in ``csrc/common.cuh``), the interval lane in fp32: emulated here at the
  EasyDGL-LC widths (K = 65 and 4,096), its error against fp64 sits well
  under the fp32 tolerance of 1e-4 of the largest entry, and a one-pass
  TF32 product (rounded by bit masking as ``cvt.rna.tf32.f32``) misses it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easydgl_tpu.kernels import mau_blocked as jblocked
from easydgl_tpu.kernels.mau_streamed import mau_streamed as jstreamed
from easydgl_tpu_torch.kernels import mau_streamed as streamed
from easydgl_tpu_torch.kernels.mau_blocked import (
    dkvt_reference, dq_reference, glam_reference, intensity_reference,
    intensity_vjp_reference, mau_blocked, mau_blocked_forward,
    output_reference, row_correction)

torch.set_num_threads(2)
B, T, H, E, BK = 3, 37, 2, 4, 16
WEIGHTS = (7, 8, 9, 10)   # wd, bd, w, scaling among the 11 inputs
DIFF = (0, 1, 2, 3) + WEIGHTS


def _inputs(seed, *, t=T, dh=8, lead_pad=0):
    """(B, T, C) q/k/v/t, a key mask with row 0 fully masked and the other
    rows left-padded by at least ``lead_pad`` keys, Exp(1) intervals,
    multi-hot marks, intensity parameters (numpy)."""
    rng = np.random.default_rng(seed)
    c, f32 = H * dh, np.float32
    q, k, v, tt = (rng.normal(size=(B, t, c)).astype(f32) for _ in range(4))
    lengths = rng.integers(1, t + 1 - lead_pad, B)
    km = (np.arange(t)[None] >= t - lengths[:, None]).astype(f32)
    km[0] = 0.0
    iv = rng.exponential(1.0, (B, t)).astype(f32)
    oh = (rng.random((B, t, E)) < 0.3).astype(f32)
    wd = rng.normal(0, 0.2, (dh + 1, E * dh)).astype(f32)
    bd = rng.normal(0, 0.1, E * dh).astype(f32)
    w = rng.normal(0, 0.2, (E, dh)).astype(f32)
    sc = rng.normal(0, 0.3, E).astype(f32)
    return q, k, v, tt, km, iv, oh, wd, bd, w, sc


def _cotangents(seed, q, dh=8):
    rng = np.random.default_rng(seed)
    go = rng.normal(size=q.shape).astype(np.float32)
    gl = rng.normal(size=(B, H, q.shape[1], E)).astype(np.float32)
    return go, gl


def _heads(x):
    b, t, c = x.shape
    return x.reshape(b, t, H, c // H).transpose(0, 2, 1, 3)


def _merge(x):
    b, h, t, d = x.shape
    return np.asarray(x).transpose(0, 2, 1, 3).reshape(b, t, h * d)


def _assert_scaled(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)


def _port_grads(args, go, gl, **kw):
    """(out, lam, the eight gradients) of ``mau_blocked`` by autograd."""
    ts = [torch.tensor(a, requires_grad=i in DIFF)
          for i, a in enumerate(args)]
    out, lam = mau_blocked(*ts, num_heads=H, block_k=BK, **kw)
    grads = torch.autograd.grad(
        (out * torch.tensor(go)).sum() + (lam * torch.tensor(gl)).sum(),
        [ts[i] for i in DIFF])
    return out, lam, [g.numpy() for g in grads]


def _jax_grads(fn, args, go, gl):
    """The eight gradients of a JAX head-layout MAU by ``jax.vjp``, with
    dq..dt back on the natural layout."""
    q, k, v, t, km, iv, oh, wd, bd, w, sc = (jnp.asarray(a) for a in args)

    def f(q_, k_, v_, t_, wd_, bd_, w_, sc_):
        return fn(q_, k_, v_, t_, km, iv, oh, wd_, bd_, w_, sc_)

    (jo, jl), vjp = jax.vjp(f, *(jnp.asarray(_heads(np.asarray(x)))
                                 for x in (q, k, v, t)), wd, bd, w, sc)
    grads = vjp((jnp.asarray(_heads(go)), jnp.asarray(gl)))
    return ([_merge(g) for g in grads[:4]]
            + [np.asarray(g) for g in grads[4:]])


NAMES = ("dq", "dk", "dv", "dt", "dWd", "dbd", "dw", "dscaling")


@pytest.mark.parametrize("dh", [8, 128])
@pytest.mark.parametrize("causal,diag", [(False, True), (True, False)])
def test_blocked_grads_match_jax_mau_blocked_vjp(causal, diag, dh):
    args = _inputs(3, dh=dh, lead_pad=5)
    go, gl = _cotangents(4, args[0])
    _, _, got = _port_grads(args, go, gl, causal=causal, diag_reset=diag)
    want = _jax_grads(lambda *a: jblocked.mau_blocked(
        *a, causal=causal, diag_reset=diag, block_k=BK), args, go, gl)
    for name, a, b in zip(NAMES, got, want):
        _assert_scaled(a, b, 1e-5, name)
    # a row that sees no key carries no gradient into q (its logits are
    # all masked) but still into t and v (it attends uniformly)
    assert float(np.abs(got[0][0]).max()) == 0.0


def test_blocked_grads_match_jax_streamed_vjp_in_interpret_mode():
    args = _inputs(5, t=19)
    go, gl = _cotangents(6, args[0])
    _, _, got = _port_grads(args, go, gl, causal=False, diag_reset=True)
    want = _jax_grads(lambda *a: jstreamed(
        *a, causal=False, diag_reset=True, interpret=True), args, go, gl)
    for name, a, b in zip(NAMES, got, want):
        _assert_scaled(a, b, 1e-5, name)


def _plain_forward_grads(args, go, gl, *, causal, diag, rate, seed):
    """The forward's intermediates and the eight gradients by autograd
    through the plain forward's own ops (no custom backward)."""
    ts = [torch.tensor(a, requires_grad=i in DIFF)
          for i, a in enumerate(args)]
    fwd = mau_blocked_forward(*ts, causal=causal, diag_reset=diag,
                              dropout_rate=rate, dropout_seed=seed,
                              num_heads=H, block_k=BK)
    grads = torch.autograd.grad(
        (fwd.out * torch.tensor(go)).sum()
        + (fwd.lam * torch.tensor(gl)).sum(), [ts[i] for i in DIFF])
    return fwd, [g.numpy() for g in grads]


@pytest.mark.parametrize("causal,diag", [(False, True), (True, False)])
def test_blocked_backward_with_dropout_matches_autograd_of_the_plain_ops(
        causal, diag):
    """Rate 0.1, one seed: the custom backward draws the forward's mask."""
    args = _inputs(13, lead_pad=4)
    go, gl = _cotangents(14, args[0])
    kw = dict(causal=causal, diag_reset=diag)
    _, _, got = _port_grads(args, go, gl, dropout_rate=0.1, dropout_seed=99,
                            **kw)
    _, want = _plain_forward_grads(args, go, gl, causal=causal, diag=diag,
                                   rate=0.1, seed=99)
    for name, a, b in zip(NAMES, got, want):
        _assert_scaled(a, b, 1e-5, name)
    _, _, undropped = _port_grads(args, go, gl, **kw)
    assert not np.allclose(got[2], undropped[2], rtol=1e-3, atol=0)


def test_each_plain_piece_matches_its_slice_of_autograd():
    """BiMAU at rate 0.1: glam_reference is the gradient of the output
    sweep wrt lam; intensity_vjp_reference the VJP of intensity_reference
    at the total d(lambda); dq_reference and dkvt_reference the autograd
    dq and (dk, dv, dt) of the whole plain forward. 1e-5 of each output's
    largest entry (fp32 sums in another order)."""
    args = _inputs(15)
    go, gl = _cotangents(16, args[0])
    flags = dict(causal=False, diag_reset=True, dropout_rate=0.1,
                 dropout_seed=5, num_heads=H, block_k=BK)
    fwd, want = _plain_forward_grads(args, go, gl, causal=False, diag=True,
                                     rate=0.1, seed=5)
    q, k, v, t, km, iv, oh, wd, bd, w, sc = (torch.tensor(a) for a in args)
    go_t, gl_t = torch.tensor(go), torch.tensor(gl)
    m, l, su, lam = (x.detach() for x in (fwd.m, fwd.l, fwd.su, fwd.lam))

    lam_leaf = lam.clone().requires_grad_(True)
    out = output_reference(q, k, v, km, oh, lam_leaf, m, l, **flags)
    g_lam_mod = glam_reference(q, k, v, km, oh, m, l, go_t, **flags)
    _assert_scaled(g_lam_mod, torch.autograd.grad((out * go_t).sum(),
                                                  lam_leaf)[0], 1e-5, "glam")

    g_lam = g_lam_mod + gl_t
    leaves = [x.clone().requires_grad_(True) for x in (su, wd, bd, w, sc)]
    lam2 = intensity_reference(leaves[0], iv, *leaves[1:])
    auto = torch.autograd.grad((lam2 * g_lam).sum(), leaves)
    vjp = intensity_vjp_reference(su, iv, wd, bd, w, sc, g_lam)
    for name, a, b in zip(("g_su", "dWd", "dbd", "dw", "dscaling"), vjp,
                          auto):
        _assert_scaled(a, b, 1e-5, name)

    rho = row_correction(fwd.out.detach(), go_t, su, vjp[0], H)
    p2 = (q, k, v, t, km, oh, lam, m, l, go_t, vjp[0], rho)
    _assert_scaled(dq_reference(*p2, **flags), want[0], 1e-5, "dq")
    for name, a, b in zip(("dk", "dv", "dt"), dkvt_reference(*p2, **flags),
                          want[1:4]):
        _assert_scaled(a, b, 1e-5, name)


def test_cpu_dispatch_under_autograd_moves_no_counter():
    """On CPU tensors ``mau_streamed`` under autograd is ``mau_blocked``'s
    ``_MauBlocked``, bit for bit, each backward wrapper is its plain
    version, and no kernel counter moves; dropout without a seed raises."""
    args = _inputs(17)
    go, gl = _cotangents(18, args[0])
    before = [f.launches for f in streamed.STREAMED_KERNELS]
    kw = dict(dropout_rate=0.2, dropout_seed=3)
    ts = [torch.tensor(a, requires_grad=i in DIFF)
          for i, a in enumerate(args)]
    out, lam = streamed.mau_streamed(*ts, True, False, num_heads=H,
                                     block_k=BK, **kw)
    assert out.grad_fn is not None
    assert type(out.grad_fn).__name__.startswith("_MauBlocked")
    got = torch.autograd.grad((out * torch.tensor(go)).sum()
                              + (lam * torch.tensor(gl)).sum(),
                              [ts[i] for i in DIFF])
    _, _, want = _port_grads(args, go, gl, causal=True, diag_reset=False,
                             **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)

    q, k, v, t, km, iv, oh, wd, bd, w, sc = (torch.tensor(a) for a in args)
    go_t, gl_t = torch.tensor(go), torch.tensor(gl)
    flags = dict(causal=True, diag_reset=False, num_heads=H, block_k=BK,
                 **kw)
    fwd = mau_blocked_forward(q, k, v, t, km, iv, oh, wd, bd, w, sc, **flags)
    pairs = [(streamed.mau_glam, glam_reference,
              (q, k, v, km, oh, fwd.m, fwd.l, go_t), flags),
             (streamed.mau_intensity_bwd, intensity_vjp_reference,
              (fwd.su, iv, wd, bd, w, sc, gl_t), {})]
    g_su = intensity_vjp_reference(fwd.su, iv, wd, bd, w, sc, gl_t)[0]
    p2 = (q, k, v, t, km, oh, fwd.lam, fwd.m, fwd.l, go_t, g_su,
          row_correction(fwd.out, go_t, fwd.su, g_su, H))
    pairs += [(streamed.mau_dq, dq_reference, p2, flags),
              (streamed.mau_dkvt, dkvt_reference, p2, flags)]
    for wrapper, plain, a, kwargs in pairs:
        mine, ref = wrapper(*a, **kwargs), plain(*a, **kwargs)
        for x, y in zip(mine if isinstance(mine, tuple) else (mine,),
                        ref if isinstance(ref, tuple) else (ref,)):
            assert torch.equal(x, y), wrapper.__name__
    assert [f.launches for f in streamed.STREAMED_KERNELS] == before
    for wrapper in (streamed.mau_glam, streamed.mau_dq, streamed.mau_dkvt):
        n = 8 if wrapper is streamed.mau_glam else 12
        a = pairs[0][2] if n == 8 else p2
        with pytest.raises(ValueError, match="seed"):
            wrapper(*a[:n], dropout_rate=0.1, num_heads=H)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32``: the 13 dropped bits of the magnitude
    rounded by adding half their range, then masked."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _product_split_bf16(a, b):
    """a @ b as the kernels form it: each operand split into a bf16 pair
    (hi = bf16(x), lo = bf16(x - hi)), lo hi + hi lo, then hi hi, each
    product exact in fp32 and summed in fp32 (lo lo dropped)."""
    ah, bh = a.bfloat16().float(), b.bfloat16().float()
    al, bl = (a - ah).bfloat16().float(), (b - bh).bfloat16().float()
    return (al @ bh + ah @ bl) + ah @ bh


def test_tf32_rounding_is_to_nearest_ties_away():
    one = torch.tensor([1.0, -1.0])
    for mag, want in ((2.0 ** -11, 2.0 ** -10), (2.0 ** -12, 0.0),
                      (3 * 2.0 ** -12, 2.0 ** -10)):
        got = _tf32(one * (1.0 + mag))
        assert got.tolist() == [1.0 + want, -(1.0 + want)], mag


@pytest.mark.parametrize("k", [65, 4096])
def test_split_bf16_products_reach_the_fp32_tolerance(k):
    """The intensity VJP's products at the EasyDGL-LC widths, 512 rows: z =
    x Wd (K = dh + 1 = 65: x = [su | iv], su ~ N(0, 0.5), iv ~ Exp(1), Wd ~
    N(0, 0.2); the 64 seq_units lanes in split bf16, the interval lane in
    fp32, as the kernels) and g_x = g_z Wd^T (K = E * dh = 4,096, g_z ~
    1e-4). Against fp64 the split stays within 2.5e-5 of the largest entry
    (a quarter of the card checks' fp32 tolerance), one TF32 pass does not
    reach 1e-4."""
    rng = np.random.default_rng(k)
    rows = 512
    if k == 65:
        a = np.concatenate([rng.normal(0, 0.5, (rows, 64)),
                            rng.exponential(1.0, (rows, 1))], axis=1)
        b = rng.normal(0, 0.2, (65, 4096))
    else:
        a = rng.normal(0, 1e-4, (rows, k))
        b = rng.normal(0, 0.2, (k, 64))
    a = torch.tensor(a, dtype=torch.float32)
    b = torch.tensor(b, dtype=torch.float32)
    want = a.double() @ b.double()
    scale = float(want.abs().max())

    def err(x):
        return float((x.double() - want).abs().max()) / scale

    if k == 65:
        split = _product_split_bf16(a[:, :64], b[:64]) + a[:, 64:] * b[64]
    else:
        split = _product_split_bf16(a, b)
    assert err(split) <= 2.5e-5
    assert err(_tf32(a) @ _tf32(b)) > 1e-4
