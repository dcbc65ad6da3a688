"""PyTorch port: GREC's and TimelyREC's modules vs the JAX package's, on
the CPU, in fp32, forward and ``jax.vjp`` (the same cotangent through
autograd), each to 1e-5 (atol and rtol): ``gelu_tanh``, ``DilatedConv1D``
in both padding forms at filter widths 3 and 2 (the even width pins which
side takes the odd pad of SAME) and dilations 1 and 2, ``MaskedCNN`` in
both forms, ``MATEncoder``, ``l2_normalize`` and ``TAHEncoder`` (with an
all-zero row, whose gradient must be finite), and ``_timeslot``'s window
and floored modulo. Inputs from numpy seeds; weights drawn at a scale
where every term shows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easydgl_tpu.nn import cnn as jcnn
from easydgl_tpu.nn import mate as jmate
from easydgl_tpu.nn.layers import gelu_tanh as jgelu_tanh
from easydgl_tpu_torch.models.timelyrec import timeslot_window
from easydgl_tpu_torch.nn.cnn import DilatedConv1D, MaskedCNN
from easydgl_tpu_torch.nn.layers import gelu_tanh
from easydgl_tpu_torch.nn.mate import MATEncoder, TAHEncoder, l2_normalize
from easydgl_tpu_torch.parity import flax_to_torch

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)
B, T, C = 3, 12, 8


def draw(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def params_like(tree, rng, scale=0.3):
    """``tree``'s leaves redrawn from ``rng`` at ``scale`` (LN gammas
    around 1)."""
    def go(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = go(v)
            else:
                out[k] = draw(rng, *np.shape(v), scale=scale) + (
                    1.0 if k == "gamma" else 0.0)
        return out
    return go(tree)


def hold(jfn, tfn, inputs, params, seed):
    """jfn(params, *inputs) in JAX and tfn(*inputs) in the port (weights
    loaded from ``params``): the outputs and, for one random cotangent, the
    gradients of every input and every parameter, to 1e-5."""
    want, vjp = jax.vjp(jfn, params, *[jnp.asarray(x) for x in inputs])
    ct = draw(np.random.default_rng(seed), *np.shape(want))
    jgrads = vjp(jnp.asarray(ct))
    xs = [torch.tensor(x, requires_grad=True) for x in inputs]
    named = list(tfn.__self__.named_parameters())
    names, leaves = zip(*named) if named else ((), ())
    got = tfn(*xs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    grads = torch.autograd.grad(got, xs + list(leaves), torch.tensor(ct))
    for g, jg in zip(grads[:len(xs)], jgrads[1:]):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL)
    if names:
        jp = flax_to_torch(jax.tree.map(np.asarray, jgrads[0]))
        for name, g in zip(names, grads[len(xs):]):
            np.testing.assert_allclose(g.numpy(), jp[name].numpy(), **TOL,
                                       err_msg=name)
    return got


def test_gelu_tanh_matches_jax():
    x = draw(np.random.default_rng(0), 64, 17, scale=3.0)
    want, vjp = jax.vjp(jgelu_tanh, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = gelu_tanh(xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    ct = draw(np.random.default_rng(1), 64, 17)
    (g,) = torch.autograd.grad(got, xt, torch.tensor(ct))
    np.testing.assert_allclose(g.numpy(), np.asarray(vjp(jnp.asarray(ct))[0]),
                               **TOL)


def module_pair(jmod, tmod, x, seed):
    """The JAX module's params at ``x``, redrawn, and the port's module
    loaded with them."""
    p = jax.tree.map(np.asarray, jmod.init(jax.random.key(0),
                                           jnp.asarray(x)))["params"]
    p = params_like(p, np.random.default_rng(seed))
    tmod.load_state_dict(flax_to_torch({"params": p}))
    return p


@pytest.mark.parametrize("width", [3, 2])
@pytest.mark.parametrize("dilation", [1, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_dilated_conv_matches_jax(width, dilation, causal):
    rng = np.random.default_rng(10 * width + dilation)
    x = draw(rng, B, T, C)
    jmod = jcnn.DilatedConv1D(width, C + 2, dilation, causal)
    tmod = DilatedConv1D(width, C, C + 2, dilation, causal)
    p = module_pair(jmod, tmod, x, 3)
    assert tmod.weight.shape == (width, C, C + 2)
    got = hold(lambda q, xx: jmod.apply({"params": q}, xx), tmod.forward,
               [x], p, 4)
    assert got.dtype == torch.float32 and got.shape == (B, T, C + 2)


@pytest.mark.parametrize("causal", [True, False])
def test_masked_cnn_matches_jax(causal):
    rng = np.random.default_rng(20)
    x = draw(rng, B, T, C)
    jmod = jcnn.MaskedCNN(3, C, 2, causal)
    tmod = MaskedCNN(3, C, 2, causal)
    p = module_pair(jmod, tmod, x, 5)
    hold(lambda q, xx: jmod.apply({"params": q}, xx), tmod.forward, [x], p,
         6)


def test_causal_conv_sees_no_later_position():
    """Changing position t moves no output before t."""
    tmod = DilatedConv1D(3, C, C, 2, True)
    with torch.no_grad():
        for prm in tmod.parameters():
            prm.normal_()
        x = torch.randn(1, T, C)
        y = x.clone()
        y[:, 7] += 1.0
        assert torch.equal(tmod(x)[:, :7], tmod(y)[:, :7])
        assert not torch.equal(tmod(x)[:, 7:], tmod(y)[:, 7:])


def test_mat_encoder_matches_jax():
    rng = np.random.default_rng(30)
    w = 4   # the W + 1 slot keys of a window of 3 (month's)
    q, k, u = draw(rng, B, T, 1, C), draw(rng, B, T, w, C), draw(rng, B, T, C)
    jmod = jmate.MATEncoder()
    p = jax.tree.map(np.asarray, jmod.init(
        jax.random.key(0), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(u)))["params"]
    p = params_like(p, rng)
    tmod = MATEncoder(C)
    tmod.load_state_dict(flax_to_torch({"params": p}))
    got = hold(lambda pp, *xs: jmod.apply({"params": pp}, *xs),
               tmod.forward, [q, k, u], p, 7)
    assert got.shape == (B, T, C)


def test_l2_normalize_and_tahe_match_jax_with_a_zero_row():
    rng = np.random.default_rng(40)
    x = draw(rng, B, T, C)
    x[1, 3] = 0.0                     # an all-zero row
    x[2, 5] = 1e-7                    # a small one, below F.normalize's eps
    want, vjp = jax.vjp(jmate._l2_normalize, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = l2_normalize(xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    ct = draw(rng, B, T, C)
    (g,) = torch.autograd.grad(got, xt, torch.tensor(ct))
    assert bool(torch.isfinite(g).all())
    np.testing.assert_allclose(g.numpy(), np.asarray(vjp(jnp.asarray(ct))[0]),
                               **TOL)

    hist = draw(rng, B, T, C)
    jmod = jmate.TAHEncoder()
    got = hold(lambda pp, a, b, c: jmod.apply({"params": pp}, a, b, c),
               TAHEncoder().forward, [x, x, hist], {}, 8)
    assert got.shape == (B, T, C)


def test_timeslot_windows_and_floored_modulo():
    """Windows 3, 7, 2, 6 for month, day, weekday and hour at the preset's
    ratio; an ETL pad's month 0 less 1 wraps as JAX's ``jnp.mod`` does."""
    assert [timeslot_window(m, 0.2) for m in (12, 31, 7, 24)] == [3, 7, 2, 6]
    feat = torch.tensor([-1, 0, 11])
    d = torch.arange(1, 4)
    got = torch.remainder(feat[:, None] + torch.cat([d, -d]), 12)
    want = jnp.mod(jnp.asarray([-1, 0, 11])[:, None]
                   + jnp.concatenate([jnp.arange(1, 4), -jnp.arange(1, 4)]),
                   12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
