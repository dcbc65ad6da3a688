"""PyTorch port: the modules of TGAT and TGREC vs the JAX package, on the
CPU (the whole models are held in ``test_torch_tgat.py`` and
``test_torch_tgrec.py``).

* ``LastAxisLayerNorm`` to 1e-5;
* ``TimeFunctionCoding``: ``code`` of (B, T) and (B, Tq, Tk) spans and
  ``factors`` (times centred on the row's latest query time) to 1e-5,
  against the JAX module at stamps of ~1e4 days;
* ``TfMultiHeadAttention`` (TGAT) and ``TgMultiHeadAttention`` (TGREC) in
  their three forms (dense codes; factored; flash: JAX's Pallas kernel in
  interpret mode, the port's plain flash version), causal, on left-padded
  keys with a batch row of padding only: the output to 1e-5 and
  ``jax.vjp`` of it (every weight, the inputs, the codes or the factors)
  to 1e-6 + 1e-4 of each leaf's scale. The JAX modules run jitted: their
  inputs carry no stamp division;
* the plain flash pieces at the augmented widths (TGAT: q and k 2,048
  wide, v 512 (the port's) and 2,048 (JAX's zero-padded one); TGREC: 150,
  fp32) against JAX ``flash_attention_reference`` and interpret-mode
  ``flash_attention`` (forward and ``jax.vjp``), and the ``scale``
  argument of ``flash_context`` (1/sqrt of the un-augmented head, not of
  the width it is given);
* the catalog wrapper's zero-padding of C = 50 (TGREC's width) to whole
  4-column vectors: exact against the unpadded plain version, forward and
  backward;
* the port's flash and factored forms of TGAT and TGREC against its dense
  form on every position's logits (the flash form's dead-row patch).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import easydgl_tpu.kernels.flash_attention as jfa
from easydgl_tpu.nn.coding import TimeFunctionCoding as JTimeFunctionCoding
from easydgl_tpu.nn.layers import LastAxisLayerNorm as JLastAxisLayerNorm
from easydgl_tpu.nn.temporal import TfMultiHeadAttention as JTfMHA
from easydgl_tpu.nn.temporal import TgMultiHeadAttention as JTgMHA
from easydgl_tpu_torch.kernels.flash_attention import (
    flash_attention, flash_attention_written_out, flash_fwd_reference)
from easydgl_tpu_torch.kernels.scoring import (_prep,
                                               catalog_nll_bwd_reference,
                                               catalog_nll_reference)
from easydgl_tpu_torch.nn.attention import attention_probs, flash_context
from easydgl_tpu_torch.nn.coding import TimeFunctionCoding
from easydgl_tpu_torch.nn.layers import LastAxisLayerNorm
from easydgl_tpu_torch.nn.temporal import (TfMultiHeadAttention,
                                           TgMultiHeadAttention)
from easydgl_tpu_torch.parity import flax_to_torch

torch.set_num_threads(2)
C, H, T, B = 16, 2, 12, 3
FORMS = ("xla", "factored", "flash")


def jax_vjp(form, fn, args, go=None):
    """(out, cotangent, VJP) of ``fn`` jitted at ``args``, its flash form's
    Pallas kernel in interpret mode; the cotangent ``go(shape)``, by
    default N(0, 1) from seed 9."""
    mode = (pltpu.force_tpu_interpret_mode() if form == "flash"
            else contextlib.nullcontext())
    with mode:
        out, vjp = jax.vjp(jax.jit(fn), *args)
        g = (np.random.default_rng(9).normal(size=out.shape) if go is None
             else go(out.shape)).astype(np.float32)
        return np.asarray(out), g, vjp(jnp.asarray(g))


def test_last_axis_layer_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = (3.0 + rng.normal(size=(B, T, 2 * C))).astype(np.float32)
    jm = JLastAxisLayerNorm()
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(0), x))
    params["params"]["gamma"] = rng.normal(1, 0.2, 2 * C).astype(np.float32)
    params["params"]["beta"] = rng.normal(0, 0.2, 2 * C).astype(np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    mine = LastAxisLayerNorm(2 * C)
    assert mine.epsilon == 1e-8
    mine.load_state_dict(flax_to_torch(params))
    with torch.no_grad():
        got = mine(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def stamps(rng, b, t, pad):
    """(b, t) scaled stamps: nondecreasing, ~1.2e4 days, with ``pad[r]``
    leading zeros in row r (the padding's stamps)."""
    ts = 11574.0 + np.cumsum(rng.exponential(3.0, (b, t)), axis=1)
    for r, n in enumerate(pad):
        ts[r, :n] = 0.0
    return ts.astype(np.float32)


def _coding_params():
    tc = JTimeFunctionCoding(C)
    params = tc.init(jax.random.key(0), jnp.zeros((1, 2)), method=tc.code)
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(1)
    params["params"]["phase"] = rng.normal(0, 0.5, C).astype(np.float32)
    return tc, params


def _port_coding(params):
    mine = TimeFunctionCoding(C)
    mine.load_state_dict(flax_to_torch(params))
    return mine


def test_time_function_coding_matches_jax():
    tc, params = _coding_params()
    np.testing.assert_array_equal(params["params"]["basis_freq"],
                                  np.linspace(0, 9, C).astype(np.float32))
    mine = _port_coding(params)
    rng = np.random.default_rng(2)
    ts = stamps(rng, B, T + 1, (0, 4, T + 1))
    spans = np.maximum(ts[:, 1:, None] - ts[:, None, :-1], 0)
    with torch.no_grad():
        for x in (ts[:, 1:] - ts[:, :-1], spans, np.zeros((B, T, 1),
                                                           np.float32)):
            want = np.asarray(tc.apply(params, jnp.asarray(x),
                                       method=tc.code))
            got = mine.code(torch.tensor(x)).numpy()
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        want = tc.apply(params, jnp.asarray(ts[:, 1:]),
                        jnp.asarray(ts[:, :-1]), method=tc.factors)
        got = mine.factors(torch.tensor(ts[:, 1:]), torch.tensor(ts[:, :-1]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)
    # the factors carry the pairwise codes where tq >= tk
    cq, sq, ck, sk = got
    pair = (cq[:, :, None] * ck[:, None] + sq[:, :, None] * sk[:, None])
    code = mine.code(torch.tensor(spans)).detach()
    live = torch.tensor(ts[:, 1:, None] >= ts[:, None, :-1]) & torch.tensor(
        ts[:, None, :-1] > 0)
    np.testing.assert_allclose(pair.detach()[live].numpy(),
                               code[live].numpy(), atol=2e-5)


def _attention_setup(seed):
    """The JAX module and its params (non-zero biases); LN-like queries,
    left-padded keys (batch row 0 all padding, row 1 four pad rows) and
    position codes; the time codes of the spans and their factors from one
    coding."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    queries = rng.normal(size=(B, T, C)).astype(f32)
    keys = rng.normal(size=(B, T, C)).astype(f32)
    keys[0] = 0.0
    keys[1, :4] = 0.0
    k_pos = rng.normal(size=(B, T, C)).astype(f32)
    ts = stamps(rng, B, T + 1, (T + 1, 5, 0))
    tc, cp = _coding_params()
    spans = np.maximum(ts[:, 1:, None] - ts[:, None, :-1], 0)
    k_int = np.asarray(tc.apply(cp, jnp.asarray(spans), method=tc.code))
    factors = tuple(np.asarray(f) for f in tc.apply(
        cp, jnp.asarray(ts[:, 1:]), jnp.asarray(ts[:, :-1]),
        method=tc.factors))
    params = jax.tree.map(np.asarray, JTfMHA(C, H).init(
        jax.random.key(3), queries, keys, k_pos, k_int, deterministic=True,
        causality=True))
    for proj in ("q", "k", "v"):
        params["params"][proj]["bias"] = rng.normal(0, 0.1, C).astype(f32)
    return params, (queries, keys, k_pos), k_int, factors


def _jax_tf(params, x, time, form):
    jm = JTfMHA(C, H, 0.0, impl="flash" if form == "flash" else "xla")

    def fn(p, q, k, kp, *tm):
        if form == "xla":
            return jm.apply(p, q, k, kp, tm[0], deterministic=True,
                            causality=True)
        return jm.apply(p, q, k, kp, None, deterministic=True,
                        causality=True, time_factors=tm)

    return jax_vjp(form, fn, [params] + [jnp.asarray(a) for a in x + time])


def check_vjp(got_w, want_w, got_x, want_x):
    """Every weight and input gradient to 1e-6 + 1e-4 of its scale; the key
    bias, whose gradient is 0 in exact arithmetic (it adds q . b to a whole
    row of logits, which the softmax cancels), of its key weight's."""
    want_w = flax_to_torch(jax.tree.map(np.asarray, want_w))
    assert set(want_w) == set(got_w)
    pairs = [(got_w[n], want_w[n], want_w["k.weight" if n == "k.bias"
                                          else n], n) for n in want_w] + [
        (a, torch.tensor(np.asarray(b)), torch.tensor(np.asarray(b)),
         f"input {i}") for i, (a, b) in enumerate(zip(got_x, want_x))]
    for got_g, want_g, scale, name in pairs:
        np.testing.assert_allclose(
            got_g.numpy(), want_g.numpy(), rtol=0, err_msg=name,
            atol=1e-6 + 1e-4 * float(scale.abs().max()))


@pytest.mark.parametrize("form", FORMS)
def test_tf_attention_matches_jax(form):
    params, x, k_int, factors = _attention_setup(4)
    time = (k_int,) if form == "xla" else factors
    want, go, (gp, *gx) = _jax_tf(params, x, time, form)
    mine = TfMultiHeadAttention(C, H, impl=form)
    mine.load_state_dict(flax_to_torch(params))
    xs = [torch.tensor(a, requires_grad=True) for a in x + time]
    if form == "xla":
        out = mine(*xs[:3], xs[3], causality=True)
    else:
        out = mine(*xs[:3], None, causality=True, time_factors=tuple(xs[3:]))
    assert out.shape == (B, T, C)
    np.testing.assert_allclose(out.detach().numpy(), want, atol=1e-5,
                               rtol=1e-5)
    names, weights = zip(*mine.named_parameters())
    grads = torch.autograd.grad((out * torch.tensor(go)).sum(),
                                weights + tuple(xs))
    check_vjp(dict(zip(names, grads[:len(names)])), gp, grads[len(names):],
              gx)


def _tg_setup(seed):
    """The JAX module and its params (non-zero biases, LN scale and shift);
    items x (TGREC passes them as queries and keys) with left padding
    (batch row 0 all padding, row 1 five pad rows) and the key mask of the
    ids; coding(0) and the codes of the clamped spans, and the factors,
    from one coding."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.normal(size=(B, T, C)).astype(f32)
    pad = (T, 5, 0)
    key_mask = np.ones((B, T), f32)
    for r, n in enumerate(pad):
        key_mask[r, :n] = 0.0
    ts = stamps(rng, B, T + 1, (T + 1, 6, 0))
    tc, cp = _coding_params()
    spans = np.maximum(ts[:, 1:, None] - ts[:, None, :-1], 0)
    code = lambda a: np.asarray(tc.apply(cp, jnp.asarray(a),  # noqa: E731
                                         method=tc.code))
    q_time, k_time = code(np.zeros((B, T, 1), f32)), code(spans)
    factors = tuple(np.asarray(f) for f in tc.apply(
        cp, jnp.asarray(ts[:, 1:]), jnp.asarray(ts[:, :-1]),
        method=tc.factors))
    params = jax.tree.map(np.asarray, JTgMHA(C, H).init(
        jax.random.key(3), x, x, key_mask, q_time, k_time,
        deterministic=True, causality=True))
    p = params["params"]
    for proj in ("q", "k", "v", "merge"):
        p[proj]["bias"] = rng.normal(0, 0.1, p[proj]["bias"].shape).astype(f32)
    p["ln"]["gamma"] = rng.normal(1, 0.2, 2 * C).astype(f32)
    p["ln"]["beta"] = rng.normal(0, 0.2, 2 * C).astype(f32)
    return params, (x, x, q_time), key_mask, k_time, factors


@pytest.mark.parametrize("form", FORMS)
def test_tg_attention_matches_jax(form):
    params, x, key_mask, k_time, factors = _tg_setup(5)
    time = (k_time,) if form == "xla" else factors
    jm = JTgMHA(C, H, 0.0, impl="flash" if form == "flash" else "xla")
    km = jnp.asarray(key_mask)

    def fn(p, q, k, qt, *tm):
        if form == "xla":
            return jm.apply(p, q, k, km, qt, tm[0], deterministic=True,
                            causality=True)
        return jm.apply(p, q, k, km, qt, None, deterministic=True,
                        causality=True, time_factors=tm)

    want, go, (gp, *gx) = jax_vjp(
        form, fn, [params] + [jnp.asarray(a) for a in x + time])
    mine = TgMultiHeadAttention(C, H, impl=form)
    mine.load_state_dict(flax_to_torch(params))
    xs = [torch.tensor(a, requires_grad=True) for a in x + time]
    tkm = torch.tensor(key_mask)
    if form == "xla":
        out = mine(xs[0], xs[1], tkm, xs[2], xs[3], causality=True)
    else:
        out = mine(xs[0], xs[1], tkm, xs[2], None, causality=True,
                   time_factors=tuple(xs[3:]))
    assert out.shape == (B, T, 2 * C)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    names, weights = zip(*mine.named_parameters())
    grads = torch.autograd.grad((out * torch.tensor(go)).sum(),
                                weights + tuple(xs))
    check_vjp(dict(zip(names, grads[:len(names)])), gp, grads[len(names):],
              gx)


# (q and k width, v width, scale's head): TGAT's preset (v at dh = 512, as
# the port passes it, and zero-padded to 2,048, as JAX does) and TGREC's
# (dh + 2C = 150, scale 1/sqrt(50))
WIDE = ((2048, 512, 512), (2048, 2048, 512), (150, 150, 50))


@pytest.mark.parametrize("d, dv, dh", WIDE)
def test_plain_flash_at_wide_heads(d, dv, dh):
    """q and k ``d`` wide, v ``dv`` wide, causal, left-padded keys with a
    row of padding only, scale 1/sqrt(dh): the port's flash_attention (the
    plain forward, and the plain backward pieces through _FlashAttention)
    against JAX's reference and its interpret-mode kernel (out, and
    ``jax.vjp`` of it; JAX's v zero-padded to d)."""
    rng = np.random.default_rng(11)
    b, h, t = 2, 1, 40
    q, k = (rng.normal(0, 0.3, (b, h, t, d)).astype(np.float32)
            for _ in range(2))
    v = rng.normal(size=(b, h, t, dv)).astype(np.float32)
    km = np.ones((b, t), np.float32)
    km[0, :] = 0.0
    km[1, :13] = 0.0
    scale = dh ** -0.5
    vpad = np.concatenate([v, np.zeros((b, h, t, d - dv), np.float32)], -1)
    jx = [jnp.asarray(a) for a in (q, k, vpad, km)]
    want_ref = np.asarray(jfa.flash_attention_reference(*jx, causal=True, scale=scale))
    def cotangent(shape):
        g = rng.normal(size=shape)
        g[..., dv:] = 0.0
        return g

    want, go, jgrads = jax_vjp("flash", lambda q_, k_, v_: jfa.flash_attention(
        q_, k_, v_, jx[3], causal=True, scale=scale), jx[:3], cotangent)
    tx = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = flash_attention(*tx, torch.tensor(km), causal=True, scale=scale)
    assert out.shape == (b, h, t, dv)
    for w in (want_ref, np.asarray(want)):
        np.testing.assert_allclose(out.detach().numpy(), w[..., :dv],
                                   atol=1e-5, rtol=1e-5)
    assert not out[0].detach().abs().max()       # no key seen: 0
    grads = torch.autograd.grad((out * torch.tensor(go[..., :dv])).sum(), tx)
    # the written-out plain version (the card tests' reference) is the CPU
    # path's chain
    again = torch.autograd.grad((flash_attention_written_out(
        *tx, torch.tensor(km), causal=True, scale=scale)
        * torch.tensor(go[..., :dv])).sum(), tx)
    for g, w in zip(again, grads):
        assert torch.equal(g, w)
    for g, w in zip(grads, jgrads):
        w = np.asarray(w)[..., :g.shape[-1]]
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-6 + 1e-4 * np.abs(w).max())


def test_flash_context_scale():
    """``flash_context(scale=s)`` multiplies q . k by s, not by 1/sqrt of
    the width it is given: against the materialised softmax at s, where no
    row is dead."""
    rng = np.random.default_rng(12)
    q, k = (torch.tensor(rng.normal(size=(2, 1, 9, 64)).astype(np.float32))
            for _ in range(2))
    v = torch.tensor(rng.normal(size=(2, 1, 9, 16)).astype(np.float32))
    km = torch.ones(2, 9)
    s = 16 ** -0.5
    got = flash_context(q, k, v, km, causal=True, rate=0.0, generator=None,
                        scale=s)
    want = attention_probs(q, k, key_mask=km, causal=True, scale=s) @ v
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                               rtol=1e-5)
    default = flash_fwd_reference(q, k, v, km, causal=True)[0]
    assert float((default - got).abs().max()) > 1e-2




def test_catalog_pads_c_to_whole_vectors():
    """C = 50 (TGREC's) zero-padded to 52 by the kernels' wrapper: the pad
    columns are zero, and the plain version on the padded operands equals
    the unpadded one exactly (lse, label logit; d_hidden and d_table on
    the real columns, zero on the pad ones; d_bias)."""
    rng = np.random.default_rng(13)
    n, v, c = 37, 29, 50
    hidden = torch.tensor(rng.normal(size=(n, c)).astype(np.float32))
    table = torch.tensor(rng.normal(0, 0.3, (v, c)).astype(np.float32))
    bias = torch.tensor(rng.normal(size=v).astype(np.float32))
    labels = torch.tensor(rng.integers(0, v, n))
    hp, tp, bp, lab, n2, v2, cp = _prep(hidden, table, bias, labels)
    assert (n2, v2, cp) == (n, v, 52)
    assert not hp[:, c:].any() and not tp[:, c:].any()
    assert torch.equal(hp[:, :c], hidden) and torch.equal(tp[:, :c], table)
    want = catalog_nll_reference(hidden, table, bias, labels)
    got = catalog_nll_reference(hp, tp, bp, lab)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6)
    dlse = torch.tensor(rng.normal(size=n).astype(np.float32))
    dll = torch.tensor(rng.normal(size=n).astype(np.float32))
    want = catalog_nll_bwd_reference(hidden, table, bias, labels, want[0],
                                     dlse, dll)
    got = catalog_nll_bwd_reference(hp, tp, bp, lab, got[0], dlse, dll)
    assert not got[0][:, c:].any() and not got[1][:, c:].any()
    for g, w in zip((got[0][:, :c], got[1][:, :c], got[2]), want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("name", ["TGAT", "TGREC"])
def test_flash_and_factored_match_dense_on_every_row(name):
    """The port's flash and factored forms against its dense form, every
    position's training logits at dropout 0 (as JAX's
    ``test_flash_matches_dense``): 2e-4 on the live query rows, 1e-3 on
    the padding's rows, whose large-argument trig (pad keys at ts = 0)
    the forms reduce differently; the flash form's rows that see no key
    take the dense form's uniform value (the dead-row patch, and TGREC's
    ``tm_dead``)."""
    from easydgl_tpu_torch.config import preset
    from easydgl_tpu_torch.data.loader import BatchLoader
    from easydgl_tpu_torch.data.synthetic import synthetic_split
    from easydgl_tpu_torch.models.base import SCORING, tied_logits
    from easydgl_tpu_torch.models.registry import build_model
    from easydgl_tpu_torch.parity import random_flax_params
    cfg = preset(name, num_items=50, seqslen=12, num_units=C, num_heads=H,
                 num_blocks=2, batch_size=4, hidden_dropout_rate=0.0,
                 attention_probs_dropout_rate=0.0)
    ds = synthetic_split(num_rows=8, num_items=50, seqslen=12, seed=7)
    features, _, _ = next(BatchLoader(ds, data_mode="regressive",
                                      batch_size=4,
                                      is_training=True).epoch(0))
    feats = {k: torch.as_tensor(v) for k, v in features.items()}
    ids = features["seqs_i"]
    assert (ids == 0).any(), "the batch needs padding"
    live = torch.tensor(np.cumsum(ids != 0, axis=1) > 0).reshape(-1)
    params = random_flax_params(cfg, 3)
    logits = {}
    for form in FORMS:
        model = build_model(cfg.replace(attention_impl=form), device="cpu",
                            params=params)
        with torch.no_grad():
            hidden, table, bias = model(feats, is_training=True)[1][SCORING]
            logits[form] = tied_logits(hidden, table, bias)
    for form in ("factored", "flash"):
        got, want = logits[form], logits["xla"]
        np.testing.assert_allclose(got[live].numpy(), want[live].numpy(),
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-3,
                                   atol=1e-3)
