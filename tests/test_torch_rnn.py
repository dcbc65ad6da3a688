"""PyTorch port: the recurrent layers (``easydgl_tpu_torch.nn.rnn``) vs the
JAX package, on the CPU.

* ``CudnnGRU`` with 2 layers (C_in = 24, C = 16, T = 8), with and without
  an initial state, in fp32 and with the bf16 compute dtype: outputs and
  final states to 1e-5 (``_assert_close``: in bf16 all but a few entries),
  and ``jax.vjp`` of both against autograd (the input, the initial state
  and every weight) to 1e-4 of each leaf's scale (in bf16 to 2^-8 of it,
  one bf16 ulp: see ``_assert_close``);
* ``BlockLSTM`` (forget bias 1) with and without an initial state;
* the fp32 GRU against ``torch.nn.GRU`` with the mapped weights, an
  independent cross-check of the cuDNN gate math;
* each gate block of ``random_flax_params``' GRU kernels, and of
  ``FlaxInit.per_gate_orthogonal`` at wide and narrow inputs, orthogonal.

Weights come from the JAX modules' ``init`` with non-zero biases; inputs
are drawn by numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easydgl_tpu.nn.layers import use_compute_dtype
from easydgl_tpu.nn.rnn import BlockLSTM as JBlockLSTM
from easydgl_tpu.nn.rnn import CudnnGRU as JCudnnGRU
from easydgl_tpu_torch.config import preset
from easydgl_tpu_torch.nn.rnn import BlockLSTM, CudnnGRU
from easydgl_tpu_torch.parity import (FlaxInit, flax_to_torch,
                                      random_flax_params)

torch.set_num_threads(2)
B, T, C_IN, C = 3, 8, 24, 16
DTYPES = {"float32": (None, None), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _biased(params, rng):
    """JAX ``init`` weights with every bias drawn non-zero."""
    p = jax.tree.map(np.asarray, params)
    for name in list(p["params"]):
        if name.startswith("b"):
            p["params"][name] = rng.normal(
                0, 0.3, p["params"][name].shape).astype(np.float32)
    return p


def _assert_close(got, want, bf16):
    """1e-5 (atol and rtol). In bf16 the two sides round the same carry to
    bf16 before each step's product, but their fp32 sums run in another
    order, and a sum that lands within an fp32 ulp of a bf16 rounding
    boundary rounds the other way on one side: that carry entry then
    differs by one bf16 ulp (2^-8 of it) in every later step. So in bf16 at
    most 1% of the entries may miss 1e-5, and none by more than 2^-8 of
    the largest output (the carry's scale). The same flips reach the
    gradients, which bf16 holds to 2^-8 of each leaf's scale (fp32: 1e-4).
    A port that kept its carry or gates in bf16, or summed the recurrent
    kernel's gradient in fp32 before rounding it once, misses by far more
    (2^-8 of every entry; ~6% of a gradient's scale)."""
    got, want = np.asarray(got), np.asarray(want)
    if not bf16:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        return
    err = np.abs(got - want)
    assert np.mean(err > 1e-5 + 1e-5 * np.abs(want)) <= 0.01, err.max()
    assert err.max() <= 2.0 ** -8 * np.abs(want).max(), err.max()


def _inputs(seed, with_h0, layers=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, C_IN)).astype(np.float32)
    h0 = (rng.normal(0, 0.5, (layers, B, C)).astype(np.float32)
          if with_h0 else None)
    return rng, x, h0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cudnn_gru_matches_jax_forward_and_vjp(dtype, with_h0):
    jdt, tdt = DTYPES[dtype]
    rng, x, h0 = _inputs(1, with_h0)
    jm = JCudnnGRU(2, C)
    params = _biased(jm.init(jax.random.key(0), x), rng)
    go = rng.normal(size=(B, T, C)).astype(np.float32)
    gf = rng.normal(size=(2, B, C)).astype(np.float32)

    def fn(p, xx, hh):
        with use_compute_dtype(jdt):
            return jm.apply(p, xx, hh)

    (want_o, want_f), vjp = jax.vjp(fn, params, jnp.asarray(x),
                                    None if h0 is None else jnp.asarray(h0))
    jgp, jgx, jgh = vjp((jnp.asarray(go), jnp.asarray(gf)))

    gru = CudnnGRU(2, C_IN, C, compute_dtype=tdt)
    gru.load_state_dict(flax_to_torch(params))
    tx = torch.tensor(x, requires_grad=True)
    th = None if h0 is None else torch.tensor(h0, requires_grad=True)
    out, finals = gru(tx, th)
    assert out.dtype == finals.dtype == torch.float32
    assert out.shape == (B, T, C) and finals.shape == (2, B, C)
    _assert_close(out.detach().numpy(), want_o, tdt is not None)
    _assert_close(finals.detach().numpy(), want_f, tdt is not None)
    # the last layer's final state is its last output
    assert torch.equal(finals[1], out[:, -1])

    names, leaves = zip(*gru.named_parameters())
    wrt = leaves + (tx,) + (() if th is None else (th,))
    grads = torch.autograd.grad(
        (out * torch.tensor(go)).sum() + (finals * torch.tensor(gf)).sum(),
        wrt)
    want = dict(flax_to_torch(jax.tree.map(np.asarray, jgp)))
    want["x"] = torch.tensor(np.asarray(jgx))
    if th is not None:
        want["h0"] = torch.tensor(np.asarray(jgh))
    got = dict(zip(names + ("x", "h0"), grads))
    assert set(got) == set(want)
    frac = 2.0 ** -8 if tdt is not None else 1e-4
    for name, w in want.items():
        np.testing.assert_allclose(
            got[name].numpy(), w.numpy(), rtol=0, err_msg=name,
            atol=frac * float(w.abs().max()))


@pytest.mark.parametrize("with_init", [False, True])
def test_block_lstm_matches_jax(with_init):
    rng, x, _ = _inputs(2, False)
    jm = JBlockLSTM(C, forget_bias=1.0)
    params = _biased(jm.init(jax.random.key(1), x), rng)
    init = None
    if with_init:
        init = tuple(rng.normal(0, 0.5, (B, C)).astype(np.float32)
                     for _ in range(2))
    want_o, (want_c, want_h) = jm.apply(
        params, jnp.asarray(x),
        None if init is None else tuple(jnp.asarray(a) for a in init))
    lstm = BlockLSTM(C_IN, C, forget_bias=1.0)
    lstm.load_state_dict(flax_to_torch(params))
    with torch.no_grad():
        out, (c, h) = lstm(torch.tensor(x), None if init is None
                           else tuple(torch.tensor(a) for a in init))
    for got, want in ((out, want_o), (c, want_c), (h, want_h)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


def test_cudnn_gru_matches_torch_nn_gru_in_fp32():
    """``torch.nn.GRU`` has the cuDNN gate layout (r, z, n; the reset gate
    on the recurrent product plus its bias): weight_ih = w^T,
    weight_hh = r^T, bias_ih = bw, bias_hh = br."""
    rng, x, h0 = _inputs(3, True)
    params = _biased(JCudnnGRU(2, C).init(jax.random.key(2), x), rng)
    gru = CudnnGRU(2, C_IN, C)
    gru.load_state_dict(flax_to_torch(params))
    ref = torch.nn.GRU(C_IN, C, num_layers=2, batch_first=True)
    with torch.no_grad():
        for layer in range(2):
            for theirs, mine in (("weight_ih", "w"), ("weight_hh", "r")):
                getattr(ref, f"{theirs}_l{layer}").copy_(
                    getattr(gru, f"{mine}_{layer}").t())
            for theirs, mine in (("bias_ih", "bw"), ("bias_hh", "br")):
                getattr(ref, f"{theirs}_l{layer}").copy_(
                    getattr(gru, f"{mine}_{layer}"))
        out, finals = gru(torch.tensor(x), torch.tensor(h0))
        want_o, want_f = ref(torch.tensor(x), torch.tensor(h0))
    torch.testing.assert_close(out, want_o, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(finals, want_f, atol=1e-5, rtol=1e-5)


def _assert_orthogonal_blocks(kernel, gates):
    in_c, total = kernel.shape
    c = total // gates
    for g in range(gates):
        blk = kernel[:, g * c:(g + 1) * c].astype(np.float64)
        gram = blk.T @ blk if in_c >= c else blk @ blk.T
        np.testing.assert_allclose(gram, np.eye(min(in_c, c)), atol=1e-5)
    # independent draws: two gate blocks are not the same matrix
    assert not np.allclose(kernel[:, :c], kernel[:, c:2 * c])


def test_random_params_gate_blocks_are_orthogonal():
    cfg = preset("GRU4REC", num_items=50, num_units=C, num_blocks=2)
    gru = random_flax_params(cfg, 0)["params"]["gru"]
    assert set(gru) == {f"{n}_{i}" for n in ("w", "r", "bw", "br")
                        for i in range(2)}
    for layer in range(2):
        for name in ("w", "r"):
            kernel = gru[f"{name}_{layer}"]
            assert kernel.shape == (C, 3 * C) and kernel.dtype == np.float32
            _assert_orthogonal_blocks(kernel, 3)
        assert not gru[f"bw_{layer}"].any() and not gru[f"br_{layer}"].any()
    init = FlaxInit(1)
    for in_c in (C_IN, 8):          # wider and narrower than C
        kernel = init.per_gate_orthogonal(in_c, C, 4)
        assert kernel.shape == (in_c, 4 * C)
        _assert_orthogonal_blocks(kernel, 4)
