"""PyTorch port: EasyDGL-LC with ``gather_queries=True`` (MAU attention for
the prediction rows only) vs the JAX package, on the CPU, with the fused
MAU entry point made to raise in ``nn.temporal``'s namespace.

JAX routes a gathered-query call under its long-context engines
(``"streamed"``, ``"blocked"``) past both of them and past the fused
kernel to its materialised XLA chain (``easydgl_tpu/nn/temporal.py``); the
port's ``MAU`` sends it to ``mau_dense``, the port of that chain. The fused
kernels take at most 128 keys, and this configuration has L+1 = 160, so a
call that reached them would fail on the card; here it raises on the CPU
too. On the JAX side the blocked and fused engines are made to raise as
well, which shows the case takes JAX's dense chain.

A small EasyDGL-LC (C = 16, H = 2, E = 4, L+1 = 160, key blocks of 64,
B = 2, masklen 16, dropout 0, ct_reg 0.1, fp32), weights from the seeded
flax-initialiser tree with non-zero biases and scalings; JAX's forwards
op by op, its train step's loss and gradients jitted (as
``test_torch_train_lc.py`` takes them). Eval logits to 1e-4, the eval
step's sums (1e-6 relative) and ``recommend``; one train step: loss 1e-5 relative, every gradient to 1e-4
of its leaf's scale, the TF-Adam update within the bound of
``torch_model_checks.check_step``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import easydgl_tpu.kernels.mau_attention as jfused
import easydgl_tpu.kernels.mau_blocked as jblocked
from easydgl_tpu.config import preset as jpreset
from easydgl_tpu.data.loader import BatchLoader as JBatchLoader
from easydgl_tpu.data.synthetic import synthetic_mark_table, synthetic_split
from easydgl_tpu.eval import metrics as jmetrics
from easydgl_tpu.eval.recommender import Recommender as JRecommender
from easydgl_tpu.models.base import mau_impl as jmau_impl
from easydgl_tpu.models.registry import build_model as jbuild
from easydgl_tpu.train import optim as joptim
from easydgl_tpu.train import steps as jsteps
from easydgl_tpu_torch.config import preset
from easydgl_tpu_torch.eval import metrics
from easydgl_tpu_torch.eval.recommender import Recommender
from easydgl_tpu_torch.models.base import mau_impl
from easydgl_tpu_torch.models.registry import build_model
from easydgl_tpu_torch.nn import temporal
from easydgl_tpu_torch.parity import flax_to_torch, random_flax_params
from easydgl_tpu_torch.train.steps import (build_eval_step, build_train_step,
                                           init_state, loss_and_grads,
                                           to_device)

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
V, B, E = 60, 2, 4
KW = dict(num_items=V, seqslen=159, masklen=16, num_units=16, num_heads=2,
          num_events=E, batch_size=B, mau_block_k=64,
          compute_dtype="float32", hidden_dropout_rate=0.0,
          attention_probs_dropout_rate=0.0, l2_reg=1e-4, ct_reg=0.1,
          gather_queries=True)


def _raise(*args, **kw):
    raise AssertionError("the fused / blocked MAU engine was called")


@pytest.fixture(scope="module")
def engines_raise():
    """The port's fused entry point, and JAX's fused and blocked engines,
    raise while a test of this module runs."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(temporal, "mau_attention", _raise)
        mp.setattr(jfused, "mau_attention", _raise)
        mp.setattr(jblocked, "mau_blocked", _raise)
        yield


@pytest.fixture(scope="module")
def world(engines_raise):
    ds = synthetic_split(num_rows=2 * B, num_items=V, seqslen=159, seed=3)
    table = synthetic_mark_table(V, E, seed=2)
    params = random_flax_params(preset("EasyDGL-LC", **KW), 1)
    rng = np.random.default_rng(6)
    p = params["params"]
    p["out_bias"]["output_bias"] = rng.normal(0, 0.5, V).astype(np.float32)
    blk = p["block0_bimau"]
    blk["intensity_dense_bias"] = rng.normal(
        0, 0.1, blk["intensity_dense_bias"].shape).astype(np.float32)
    blk["intensity_scaling"] = rng.normal(0, 0.3, E).astype(np.float32)
    blk["qkvt"]["bias"] = rng.normal(0, 0.1, 64).astype(np.float32)
    jcfg = jpreset("EasyDGL-LC").replace(use_pallas=False, **KW)
    assert jmau_impl(jcfg) == "blocked"
    jm = jbuild(jcfg)

    def batch(train):
        return next(JBatchLoader(ds, data_mode="mau", batch_size=B,
                                 masklen=16, is_training=train,
                                 mark_table=table, needs_marks=True,
                                 use_native=False).epoch(0))

    (tf, tlab, _), ev = batch(True), batch(False)
    jf = {k: jnp.asarray(v) for k, v in tf.items()}
    loss, grads = jax.jit(jax.value_and_grad(lambda q: jsteps.compute_loss(
        jm, q, jf, jnp.asarray(tlab))))(params)
    tx = joptim.build_optimizer(jcfg.optim)
    upd, _ = tx.update(grads, tx.init(params), params)
    params1 = jax.tree.map(np.asarray, optax.apply_updates(params, upd))
    cfg = preset("EasyDGL-LC", **KW)
    assert mau_impl(cfg) == "streamed"
    return dict(ds=ds, table=table, params=params, jm=jm, jcfg=jcfg,
                cfg=cfg, eval=ev, train=(tf, tlab), loss=float(loss),
                grads=flax_to_torch(jax.tree.map(np.asarray, grads)),
                params1=flax_to_torch(params1),
                model=build_model(cfg, device="cpu", params=params))


def test_gathered_lc_eval_logits_match_jax(world):
    features = world["eval"][0]
    with jax.disable_jit():
        want, _ = world["jm"].apply(world["params"], {
            k: jnp.asarray(v) for k, v in features.items()},
            is_training=False)
    with torch.no_grad():
        got, aux = world["model"](to_device(features, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert aux["intensities"][0].shape == (B, 2, 1, E)   # the last row


def test_gathered_lc_eval_step_and_recommend_match_jax(world):
    features, labels, valid = world["eval"]
    jstep = jsteps.build_eval_step(world["jm"], mark_table=world["table"])
    step = build_eval_step(world["model"], mark_table=world["table"])
    jacc, acc = jmetrics.MetricAccumulator(), metrics.MetricAccumulator()
    with jax.disable_jit():
        jacc.update(jstep(world["params"],
                          {k: jnp.asarray(v) for k, v in features.items()},
                          jnp.asarray(labels), jnp.asarray(valid)))
    acc.update(step(world["model"], features, labels, valid))
    want, got = jacc.result(), acc.result()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)
    arrays = {k: v[:B] for k, v in world["ds"].arrays.items()}
    with jax.disable_jit():
        want_ids, want_scores = JRecommender(
            world["jcfg"], world["params"], world["table"]).recommend(
                arrays, k=7)
    ids, scores = Recommender(world["cfg"], world["model"],
                              world["table"]).recommend(arrays, k=7)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(scores, want_scores, **TOL)


def test_gathered_lc_train_step_matches_jax(world):
    """Loss 1e-5 relative; every gradient leaf within 1e-6 + 1e-4 of its
    largest entry; the parameters after one TF-Adam step within the bound
    ``torch_model_checks.check_step`` states (no clip here)."""
    model = world["model"]
    tf, tlab = world["train"]
    loss, grads = loss_and_grads(model, to_device(tf, "cpu"),
                                 torch.as_tensor(tlab))
    np.testing.assert_allclose(float(loss), world["loss"], rtol=1e-5)
    jg = world["grads"]
    assert set(jg) == set(grads)
    for name, want in jg.items():
        np.testing.assert_allclose(
            grads[name].numpy(), want.numpy(), rtol=0, err_msg=name,
            atol=1e-6 + 1e-4 * float(want.abs().max()))
    model = build_model(world["cfg"], device="cpu", params=world["params"])
    state, _ = build_train_step(model)(init_state(model), tf, tlab,
                                       torch.Generator())
    opt = world["cfg"].optim
    lr, eps_t1 = opt.learning_rate, opt.eps / np.sqrt(1 - opt.beta2)
    for name, want in world["params1"].items():
        g = jg[name].abs()
        d = 1e-6 + 1e-4 * float(g.max())
        bound = torch.where(
            g > 2 * d,
            1e-7 + 1e-5 * want.abs()
            + lr * eps_t1 * d / (g - d).clamp_min(d) ** 2,
            torch.tensor(2 * lr))
        err = (state.params[name].detach() - want).abs()
        assert bool((err <= bound).all()), name
