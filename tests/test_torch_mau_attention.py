"""PyTorch port: the MAU/BiMAU chain, forward and backward.

* the plain ``mau_attention_reference`` vs the JAX ``mau_attention``
  (Pallas, interpret mode) and the JAX reference, values and all eight
  gradients (cotangents on both ``out`` and ``lam``), the gradients also at
  CTSMA's head width dh = 128;
* the explicit plain backward ``mau_attention_bwd_reference`` vs autograd
  of the plain forward;
* the port's ``MAU``/``BiMAU`` module vs the JAX ``MAU`` (``xla`` engine),
  with weights carried by the bridge;
* Philox4x32-10 against the Random123 known answers, and the attention
  dropout's statistics and determinism;
* the wrapper's CPU dispatch.

The CUDA kernels themselves are held against the plain versions in
``test_torch_cuda.py`` (card only).

Inputs come from numpy with a seed. fp32 tolerance atol = rtol = 1e-5 for
values; gradients are held to 1e-5 of each gradient's largest entry (sums
of a few dozen fp32 terms in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from easydgl_tpu.kernels import mau_attention as jmau
from easydgl_tpu.nn import temporal as jtemporal
from easydgl_tpu_torch.kernels.mau_attention import (
    dropout_factor, fused_fwd_workspaces, mau_attention, mau_attention_bwd,
    mau_attention_bwd_reference, mau_attention_reference, philox4x32_10)
from easydgl_tpu_torch.nn.temporal import MAU, BiMAU
from easydgl_tpu_torch.parity import flax_to_torch

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)
B, T, H, DH, E = 3, 11, 2, 16, 4
# PRESETS["CTSMA"]'s head width (C = 512, H = 4) at a few rows
DH128 = dict(B=2, T=6, H=2, DH=128, E=3)


def _inputs(seed, tq=T, gathered=False, dims=None):
    """(B, T, C) q/k/v/t, left-padded key mask with row 0 fully masked,
    Exp(1) intervals, multi-hot marks, intensity params; qpos sorted and
    distinct when gathered. ``dims``: B, T, H, DH, E other than the
    module's."""
    d = {**dict(B=B, T=T, H=H, DH=DH, E=E), **(dims or {})}
    B_, T_, H_, DH_, E_ = (d[k] for k in ("B", "T", "H", "DH", "E"))
    rng = np.random.default_rng(seed)
    c = H_ * DH_
    f32 = np.float32
    q = rng.normal(size=(B_, tq, c)).astype(f32)
    k, v, t = (rng.normal(size=(B_, T_, c)).astype(f32) for _ in range(3))
    lengths = rng.integers(1, T_ + 1, B_)
    key_mask = (np.arange(T_)[None] >= T_ - lengths[:, None]).astype(f32)
    key_mask[0] = 0.0
    intervals = rng.exponential(1.0, (B_, tq)).astype(f32)
    onehot = (rng.random((B_, T_, E_)) < 0.3).astype(f32)
    wd = rng.normal(0, 0.2, (DH_ + 1, E_ * DH_)).astype(f32)
    bd = rng.normal(0, 0.1, E_ * DH_).astype(f32)
    w = rng.normal(0, 0.2, (E_, DH_)).astype(f32)
    sc = rng.normal(0, 0.3, E_).astype(f32)
    qpos = (np.sort(rng.permuted(np.tile(np.arange(T_), (B_, 1)), axis=1)
                    [:, :tq], axis=1).astype(np.int32) if gathered else None)
    return q, k, v, t, key_mask, intervals, onehot, wd, bd, w, sc, qpos


def _heads(x, h=H):
    b, t, c = x.shape
    return x.reshape(b, t, h, c // h).transpose(0, 2, 1, 3)


CASES = [  # (causal, diag_reset, Tq, gathered)
    (False, True, T, False),     # BiMAU
    (True, False, T, False),     # causal MAU
    (False, True, 4, True),      # BiMAU, gathered qpos, Tq < Tk
    (True, False, 4, True),      # causal, gathered qpos
]


@pytest.mark.parametrize("causal,diag,tq,gathered", CASES)
def test_plain_version_matches_jax_kernel_and_reference(causal, diag, tq,
                                                        gathered):
    args = _inputs(7, tq, gathered)
    q, k, v, t, km, iv, oh, wd, bd, w, sc, qpos = args
    out, lam = mau_attention_reference(
        *(torch.tensor(a) for a in args[:11]), causal=causal,
        diag_reset=diag, num_heads=H,
        qpos=None if qpos is None else torch.tensor(qpos))
    jq = None if qpos is None else jnp.asarray(qpos)
    with pltpu.force_tpu_interpret_mode():
        ko, kl = jmau.mau_attention(*(jnp.asarray(a) for a in args[:11]), 0,
                                    causal, diag, 0.0, num_heads=H, qpos=jq)
    ro, rl = jmau.mau_attention_reference(
        *(jnp.asarray(a) for a in (_heads(q), _heads(k), _heads(v),
                                   _heads(t), km, iv, oh, wd, bd, w, sc)),
        causal=causal, diag_reset=diag, qpos=jq)
    ro = np.asarray(ro).transpose(0, 2, 1, 3).reshape(out.shape)
    for want_o, want_l in ((np.asarray(ko), np.asarray(kl)), (ro, rl)):
        np.testing.assert_allclose(out.numpy(), want_o, **TOL)
        np.testing.assert_allclose(lam.numpy(), np.asarray(want_l), **TOL)
    # the fully masked row 0 attends uniformly: finite and not all zero
    assert np.isfinite(out[0].numpy()).all() and out[0].abs().sum() > 0


def test_cpu_tensors_take_the_plain_version_and_dropout_raises():
    """CPU tensors launch nothing and equal the plain version, with and
    without dropout; dropout without a seed raises; the same seed gives the
    same out, another seed another."""
    args = [torch.tensor(a) for a in _inputs(3)[:11]]
    before = (mau_attention.launches, mau_attention_bwd.launches)
    got = mau_attention(*args, False, True, num_heads=H)
    want = mau_attention_reference(*args, diag_reset=True, num_heads=H)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    d1 = mau_attention(*args, False, True, 0.3, num_heads=H, dropout_seed=5)
    d2 = mau_attention_reference(*args, diag_reset=True, dropout_rate=0.3,
                                 dropout_seed=torch.tensor(5), num_heads=H)
    d3 = mau_attention(*args, False, True, 0.3, num_heads=H, dropout_seed=6)
    assert torch.equal(d1[0], d2[0]) and torch.equal(d1[1], want[1])
    assert not torch.equal(d1[0], got[0]) and not torch.equal(d1[0], d3[0])
    go, gl = torch.ones_like(got[0]), torch.ones_like(got[1])
    mau_attention_bwd(*args, None, go, gl, causal=False, diag_reset=True,
                      dropout_rate=0.0, dropout_seed=None, num_heads=H)
    assert (mau_attention.launches,
            mau_attention_bwd.launches) == before  # nothing launched
    with pytest.raises(ValueError, match="seed"):
        mau_attention(*args, False, True, 0.1, num_heads=H)


@pytest.mark.parametrize("bidirectional,gathered",
                         [(True, False), (False, False), (True, True)])
def test_mau_module_matches_jax_xla_engine(bidirectional, gathered):
    rng = np.random.default_rng(11)
    c = H * DH
    x = rng.normal(size=(B, T, 3 * c)).astype(np.float32)
    _, _, _, _, km, iv, oh, *_ = _inputs(5)
    jm = jtemporal.MAU(c, H, E, 0.0, fused_qkvt=True,
                       causal_default=not bidirectional,
                       diag_reset=bidirectional, intensity_impl="xla")
    jx = jnp.asarray(x)
    params = jm.init({"params": jax.random.key(0)}, jx, jx,
                     jnp.asarray(km), jnp.asarray(iv), jnp.asarray(oh),
                     deterministic=True)
    # non-zero biases and scaling so every parameter matters
    p = {k: (np.asarray(v) if not isinstance(v, dict) else
             {kk: np.asarray(vv) for kk, vv in v.items()})
         for k, v in params["params"].items()}
    p["intensity_dense_bias"] = rng.normal(0, 0.1, E * DH).astype(np.float32)
    p["intensity_scaling"] = rng.normal(0, 0.3, E).astype(np.float32)
    p["qkvt"]["bias"] = rng.normal(0, 0.1, 4 * c).astype(np.float32)
    qpos = np.array([[T - 1, 2], [0, T - 1], [5, 6]], np.int32) \
        if gathered else None
    jo, jl = jm.apply({"params": p}, jx, jx, jnp.asarray(km),
                      jnp.asarray(iv), jnp.asarray(oh), deterministic=True,
                      query_positions=None if qpos is None
                      else jnp.asarray(qpos))
    if bidirectional:
        tm = BiMAU(3 * c, c, H, E)
    else:
        tm = MAU(3 * c, c, H, E, fused_qkvt=True, causal_default=True,
                 diag_reset=False)
    tm.load_state_dict(flax_to_torch({"params": p}))
    with torch.no_grad():
        tx = torch.tensor(x)
        to, tl = tm(tx, tx, torch.tensor(km), torch.tensor(iv),
                    torch.tensor(oh), query_positions=None if qpos is None
                    else torch.tensor(qpos))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)

    # the plain intensity head and the TPP likelihood, same inputs
    h_units = rng.normal(size=(B, H, T, DH)).astype(np.float32)
    jqk, jmi = jm.apply({"params": p}, jnp.asarray(h_units), jnp.asarray(iv),
                        jnp.asarray(oh), method=jtemporal.MAU.intensity)
    with torch.no_grad():
        tqk, tmi = tm.intensity(torch.tensor(h_units), torch.tensor(iv),
                                torch.tensor(oh))
    np.testing.assert_allclose(tqk.numpy(), np.asarray(jqk), **TOL)
    np.testing.assert_allclose(tmi.numpy(), np.asarray(jmi), **TOL)
    nxt = np.broadcast_to(oh[:, None], (B, H, T, E)).copy()
    nxt[:, :, 0] = 0.0  # a position with no next event
    spans = np.broadcast_to(iv[:, None], (B, H, T)).copy()
    want = jtemporal.MAU.biased_likelihood(jnp.asarray(jmi), jnp.asarray(nxt),
                                           jnp.asarray(spans))
    got = MAU.biased_likelihood(tmi, torch.tensor(nxt), torch.tensor(spans))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _grad_inputs(seed, tq, gathered, dims=None):
    q, k, v, t, km, iv, oh, wd, bd, w, sc, qpos = _inputs(seed, tq, gathered,
                                                          dims)
    rng = np.random.default_rng(seed + 100)
    go = rng.normal(size=q.shape).astype(np.float32)
    h = (dims or {}).get("H", H)
    gl = rng.normal(size=(q.shape[0], h, tq, w.shape[0])).astype(np.float32)
    return (q, k, v, t, wd, bd, w, sc), (km, iv, oh), qpos, go, gl


def _assert_grads(got, want, what):
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a), np.asarray(b)
        scale = float(np.abs(b).max())
        np.testing.assert_allclose(a, b, atol=1e-5 * scale + 1e-7, rtol=0,
                                   err_msg=f"{what}: grad {i}")


@pytest.mark.parametrize("causal,diag,tq,gathered", CASES)
def test_plain_grads_match_jax_kernel_and_reference(causal, diag, tq,
                                                    gathered):
    """All eight gradients (q, k, v, t, Wd, bd, w, scaling) of
    sum(out * g_out) + sum(lam * g_lam): autograd of the port's plain
    forward and its explicit backward, against jax.grad of the JAX Pallas
    kernel (its custom_vjp backward, interpret mode) and of the JAX
    reference."""
    _check_grads_against_jax(causal, diag, tq, gathered)


@pytest.mark.parametrize("causal,diag", [(True, False), (False, True)])
def test_plain_grads_match_jax_at_dh128(causal, diag):
    """As above at CTSMA's head width dh = 128 (the width of the bf16
    backward's two-half tensor-core path on the card), causal MAU and BiMAU
    with the diagonal reset: the plain backward that the card's kernels are
    held to, against JAX's."""
    _check_grads_against_jax(causal, diag, DH128["T"], False, DH128)


def _check_grads_against_jax(causal, diag, tq, gathered, dims=None):
    h = (dims or {}).get("H", H)
    diff, (km, iv, oh), qpos, go, gl = _grad_inputs(9, tq, gathered, dims)
    jq = None if qpos is None else jnp.asarray(qpos)

    def jloss_kernel(a):
        o, lam = jmau.mau_attention(*a[:4], km, iv, oh, *a[4:], 0, causal,
                                    diag, 0.0, num_heads=h, qpos=jq)
        return jnp.sum(o * go) + jnp.sum(lam * gl)

    def jloss_ref(a):
        o, lam = jmau.mau_attention_reference(
            *(_heads(x, h) for x in a[:4]), km, iv, oh, *a[4:],
            causal=causal, diag_reset=diag, qpos=jq)
        o = o.transpose(0, 2, 1, 3).reshape(go.shape)
        return jnp.sum(o * go) + jnp.sum(lam * gl)

    ja = tuple(jnp.asarray(x) for x in diff)
    with pltpu.force_tpu_interpret_mode():
        want_k = jax.grad(jloss_kernel)(ja)
    want_r = jax.grad(jloss_ref)(ja)

    tdiff = [torch.tensor(x, requires_grad=True) for x in diff]
    tsmall = [torch.tensor(x) for x in (km, iv, oh)]
    tq_ = None if qpos is None else torch.tensor(qpos)
    out, lam = mau_attention(*tdiff[:4], *tsmall, *tdiff[4:], causal, diag,
                             num_heads=h, qpos=tq_)
    loss = (out * torch.tensor(go)).sum() + (lam * torch.tensor(gl)).sum()
    got_auto = [g.numpy() for g in torch.autograd.grad(loss, tdiff)]
    got_expl = mau_attention_bwd_reference(
        *(torch.tensor(x) for x in diff[:4]), *tsmall,
        *(torch.tensor(x) for x in diff[4:]), torch.tensor(go),
        torch.tensor(gl), causal=causal, diag_reset=diag, num_heads=h,
        qpos=tq_)
    got_expl = [g.numpy() for g in got_expl]
    for got, name in ((got_auto, "autograd"), (got_expl, "explicit")):
        _assert_grads(got, want_k, f"{name} vs JAX kernel")
        _assert_grads(got, want_r, f"{name} vs JAX reference")


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("causal,diag,tq,gathered", CASES[:3])
def test_explicit_backward_matches_autograd(causal, diag, tq, gathered,
                                           rate):
    """The written-out backward against autograd of the plain forward, in
    fp32, with and without dropout (the same seed on both sides, so the
    regenerated mask is the forward's)."""
    diff, (km, iv, oh), qpos, go, gl = _grad_inputs(4, tq, gathered)
    tdiff = [torch.tensor(x, requires_grad=True) for x in diff]
    tsmall = [torch.tensor(x) for x in (km, iv, oh)]
    tq_ = None if qpos is None else torch.tensor(qpos)
    kw = dict(causal=causal, diag_reset=diag, dropout_rate=rate,
              dropout_seed=1234567, num_heads=H, qpos=tq_)
    out, lam = mau_attention_reference(*tdiff[:4], *tsmall, *tdiff[4:], **kw)
    loss = (out * torch.tensor(go)).sum() + (lam * torch.tensor(gl)).sum()
    want = torch.autograd.grad(loss, tdiff)
    got = mau_attention_bwd_reference(
        *(x.detach() for x in tdiff[:4]), *tsmall,
        *(x.detach() for x in tdiff[4:]), torch.tensor(go), torch.tensor(gl),
        **kw)
    _assert_grads([g.numpy() for g in got], [g.numpy() for g in want],
                  "explicit vs autograd")


def test_philox_known_answers():
    """Philox4x32-10, the Random123 known-answer vectors (counter, key ->
    four output words)."""
    cases = [
        ((0, 0, 0, 0), (0, 0),
         (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
        ((0xffffffff,) * 4, (0xffffffff,) * 2,
         (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
        ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
         (0xa4093822, 0x299f31d0),
         (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
    ]
    for ctr, key, want in cases:
        got = philox4x32_10(*(torch.tensor(c, dtype=torch.int64)
                              for c in ctr + key))
        assert tuple(int(x) for x in got) == want


def test_attention_dropout_statistics():
    """Keep fraction within 5 sigma of 1-p over ~123k entries; kept
    entries are exactly float32(1/(1-p)); the mask is a function of the seed
    (same seed same mask, a seed differing only in its high word differs);
    rate 0 keeps everything."""
    shape, p = (4, 8, 31, 124), 0.1
    n = int(np.prod(shape))
    f = dropout_factor(123, shape, p, "cpu")
    kept = f != 0
    frac = float(kept.float().mean())
    assert abs(frac - (1 - p)) < 5 * np.sqrt(p * (1 - p) / n)
    assert torch.equal(f[kept], torch.full_like(f[kept],
                                                np.float32(1 / (1 - p))))
    assert torch.equal(f, dropout_factor(torch.tensor(123), shape, p, "cpu"))
    assert not torch.equal(f, dropout_factor(123 + (1 << 32), shape, p,
                                             "cpu"))
    assert bool((dropout_factor(7, shape, 0.0, "cpu") == 1.0).all())


@pytest.mark.parametrize("b,h,tq,tk,dh,e", [(512, 8, 31, 31, 64, 64),
                                            (3, 2, 11, 20, 16, 3),
                                            (2, 4, 9, 128, 128, 128)])
def test_fused_forward_workspaces_hold_every_row(b, h, tq, tk, dh, e):
    """The bf16 forward's scratch: probs one row a (b, h), a multiple of 4
    fp32 long (its 16-byte loads) with room for its (Tq, Tk) and less than
    4 to spare; x one bf16 row of dh lanes a (b, h, i), rows of whole 4-byte
    pairs; Wd's tiles (dh, E*dh) bf16 in rows of whole 16-byte units (the
    tensor map's stride); the interval lane and w (2, E*dh) fp32."""
    ws = fused_fwd_workspaces(b, h, tq, tk, dh, e, "cpu")
    probs = ws["probs"]
    assert probs.dtype == torch.float32 and probs.is_contiguous()
    assert probs.shape[0] == b * h and probs.shape[1] % 4 == 0
    assert tq * tk <= probs.shape[1] < tq * tk + 4
    assert ws["x"].dtype == torch.bfloat16 and ws["x"].is_contiguous()
    assert tuple(ws["x"].shape) == (b * h * tq, dh) and dh % 2 == 0
    assert ws["wd"].dtype == torch.bfloat16
    assert tuple(ws["wd"].shape) == (dh, e * dh) and e * dh * 2 % 16 == 0
    assert ws["side"].dtype == torch.float32
    assert tuple(ws["side"].shape) == (2, e * dh)
