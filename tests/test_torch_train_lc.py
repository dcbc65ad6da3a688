"""PyTorch port: the EasyDGL-LC train step vs the JAX package, on the CPU.

The port's ``build_train_step`` on a small EasyDGL-LC configuration
(``attention_impl="flash"``: the streamed engine, whose CPU form is the
blocked plain version with its two-pass custom backward ``_MauBlocked``)
against ``easydgl_tpu.train.steps.build_train_step`` with
``use_pallas=False`` (JAX's blocked engine ``mau_blocked`` and its custom
VJP): the loss, every gradient leaf and the parameters after one TF-Adam
update.

Config: C=16, H=2, E=4, L+1=256 (key blocks of 64), B=2, masklen 16,
dropout 0 (the two PRNG streams differ by design), l2_reg 1e-4 and ct_reg
raised to 0.1 so that the TPP gradient through the intensities shows at
the tolerance. Weights from the port's seeded flax-initialiser tree with
non-zero biases and scalings. Tolerances are stated at each assertion.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easydgl_tpu.config import preset as jpreset
from easydgl_tpu.data.loader import BatchLoader as JBatchLoader
from easydgl_tpu.data.synthetic import synthetic_mark_table, synthetic_split
from easydgl_tpu.models.base import mau_impl as jmau_impl
from easydgl_tpu.models.registry import build_model as jbuild
from easydgl_tpu.train import optim as joptim
from easydgl_tpu.train import steps as jsteps
from easydgl_tpu_torch.config import preset
from easydgl_tpu_torch.kernels import mau_blocked
from easydgl_tpu_torch.models.base import mau_impl
from easydgl_tpu_torch.models.registry import build_model
from easydgl_tpu_torch.parity import flax_to_torch, random_flax_params
from easydgl_tpu_torch.train.steps import (build_train_step, init_state,
                                           loss_and_grads, to_device)

torch.set_num_threads(2)
V, B, E = 60, 2, 4
KW = dict(num_items=V, seqslen=255, masklen=16, num_units=16, num_heads=2,
          num_events=E, batch_size=B, mau_block_k=64,
          compute_dtype="float32", hidden_dropout_rate=0.0,
          attention_probs_dropout_rate=0.0, l2_reg=1e-4, ct_reg=0.1)
LR = 5e-4  # PRESETS["EasyDGL-LC"]


@pytest.fixture(scope="module")
def lc_world():
    """One training batch with marks, weights with non-zero biases and
    scalings, and the JAX loss, gradients and state after one step."""
    ds = synthetic_split(num_rows=B, num_items=V, seqslen=255, seed=3)
    table = synthetic_mark_table(V, E, seed=2)
    loader = JBatchLoader(ds, data_mode="mau", batch_size=B, masklen=16,
                          is_training=True, mark_table=table,
                          needs_marks=True, use_native=False)
    features, labels, _ = next(loader.epoch(0))
    params = random_flax_params(preset("EasyDGL-LC", **KW), 1)
    rng = np.random.default_rng(6)
    p = params["params"]
    p["out_bias"]["output_bias"] = rng.normal(0, 0.5, V).astype(
        np.float32)
    blk = p["block0_bimau"]
    blk["intensity_dense_bias"] = rng.normal(
        0, 0.1, blk["intensity_dense_bias"].shape).astype(np.float32)
    blk["intensity_scaling"] = rng.normal(0, 0.3, E).astype(np.float32)
    jcfg = jpreset("EasyDGL-LC").replace(use_pallas=False, **KW)
    assert jmau_impl(jcfg) == "blocked"
    jm = jbuild(jcfg)
    jf = {k: jnp.asarray(v) for k, v in features.items()}
    loss, grads = jax.jit(jax.value_and_grad(lambda q: jsteps.compute_loss(
        jm, q, jf, jnp.asarray(labels))))(params)
    tx = joptim.build_optimizer(jcfg.optim)
    state0 = jsteps.TrainState(params, tx.init(params),
                               jnp.zeros((), jnp.int32))
    state1, loss1 = jsteps.build_train_step(jm, donate=False)(
        state0, jf, jnp.asarray(labels), jax.random.key(0))
    return dict(features=features, labels=labels, params=params,
                loss=float(loss), loss1=float(loss1),
                grads=flax_to_torch(jax.tree.map(np.asarray, grads)),
                params1=flax_to_torch(jax.tree.map(np.asarray,
                                                   state1.params)))


@pytest.fixture(scope="module")
def port(lc_world):
    """The port's model on the CPU, and its loss and gradients, with every
    call of ``_MauBlocked`` (the custom backward) recorded."""
    cfg = preset("EasyDGL-LC", **KW)
    model = build_model(cfg, device="cpu", params=lc_world["params"])
    calls = []
    apply = mau_blocked._MauBlocked.apply

    def spy(*args):
        calls.append(tuple(args[0].shape))
        return apply(*args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mau_blocked._MauBlocked, "apply", spy)
        loss, grads = loss_and_grads(model, to_device(lc_world["features"],
                                                      "cpu"),
                                     torch.as_tensor(lc_world["labels"]))
    return dict(cfg=cfg, model=model, loss=float(loss), grads=grads,
                calls=calls)


def test_lc_loss_matches_jax_through_the_custom_backward(lc_world, port):
    """The streamed engine, as ``_MauBlocked`` once per block; loss 1e-5
    relative (fp32 sums in another order)."""
    assert mau_impl(port["cfg"]) == "streamed"
    assert port["calls"] == [(B, 256, 16)]
    np.testing.assert_allclose(port["loss"], lc_world["loss"], rtol=1e-5)


def test_lc_gradients_match_jax(lc_world, port):
    """Every gradient leaf within 1e-6 + 1e-4 of the leaf's largest entry
    (fp32 sums taken in another order); the TPP term reaches the intensity
    head through the intensities."""
    jg, grads = lc_world["grads"], port["grads"]
    assert set(jg) == set(grads)
    for name, want in jg.items():
        scale = float(want.abs().max())
        np.testing.assert_allclose(grads[name].numpy(), want.numpy(),
                                   atol=1e-6 + 1e-4 * scale, rtol=0,
                                   err_msg=name)
    assert float(jg["block0_bimau.intensity_scaling"].abs().max()) > 1e-4


def test_lc_adam_update_matches_jax(lc_world, port):
    """One ``build_train_step`` step: loss 1e-5 relative. Parameters after
    the update: TF-Adam's first step is u(g) = -lr g / (|g| + e'),
    e' = eps / sqrt(1 - b2), so a gradient known to within
    d = 1e-6 + 1e-4 max|g| moves it by up to lr e' d / (|g| - d)^2 where
    |g| > 2d — held to that plus 1e-7 + 1e-5 |p| — and by up to 2 lr (a
    flipped sign) where |g| <= 2d."""
    model = port["model"]
    state, loss1 = build_train_step(model)(
        init_state(model), lc_world["features"], lc_world["labels"],
        torch.Generator())
    np.testing.assert_allclose(float(loss1), lc_world["loss1"], rtol=1e-5)
    eps_t1 = 1e-8 / np.sqrt(1 - 0.999)
    jg = lc_world["grads"]
    for name, want in lc_world["params1"].items():
        g = jg[name].abs()
        d = 1e-6 + 1e-4 * float(g.max())
        bound = torch.where(
            g > 2 * d,
            1e-7 + 1e-5 * want.abs()
            + LR * eps_t1 * d / (g - d).clamp_min(d) ** 2,
            torch.tensor(2 * LR))
        err = (state.params[name].detach() - want).abs()
        assert bool((err <= bound).all()), name
