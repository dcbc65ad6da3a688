"""PyTorch port: the faithful EasyDGL train step vs the JAX package, on the
CPU.

* one full train step (loss, every gradient leaf, the parameters after one
  TF-Adam update) of the port's ``build_train_step`` against
  ``easydgl_tpu.train.steps.build_train_step``, then a third step continued
  from the JAX state after two steps, carried across by the optimizer-state
  bridge;
* ``compute_loss`` against JAX ``compute_loss`` with ``use_pallas=True``
  (the Pallas MAU and catalog kernels in interpret mode);
* the optimizers against optax;
* hidden dropout's statistics and the generator-seeded training forward.

Tiny config: C=16, H=2, E=4, L=8, B=8, masklen 2, dropout 0 (the two PRNG
streams differ by design), l2_reg 1e-4, and ct_reg raised to 0.1 so that
the TPP gradient through the intensities shows at the tolerance.

The JAX side runs jitted: at this configuration its jitted step and its
op-by-op step agree on the loss to ~1e-7 (unlike the eval logits of
ROADMAP C1), and op by op a step takes ~30 s here. Weights come from the
port's seeded flax-initialiser tree (``random_flax_params``, the layout of
flax ``init``) with a non-zero output bias. Tolerances are stated at each
assertion.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from easydgl_tpu.config import OptimConfig as JOptimConfig
from easydgl_tpu.config import preset as jpreset
from easydgl_tpu.data.loader import BatchLoader as JBatchLoader
from easydgl_tpu.data.synthetic import synthetic_mark_table, synthetic_split
from easydgl_tpu.models.registry import build_model as jbuild
from easydgl_tpu.train import optim as joptim
from easydgl_tpu.train import steps as jsteps
from easydgl_tpu_torch.config import OptimConfig, preset
from easydgl_tpu_torch.models.registry import build_model
from easydgl_tpu_torch.nn.layers import dropout
from easydgl_tpu_torch.parity import (flax_to_torch, random_flax_params,
                                      tf_adam_state_to_flax,
                                      tf_adam_state_to_torch)
from easydgl_tpu_torch.train import optim
from easydgl_tpu_torch.kernels.scoring import catalog_nll
from easydgl_tpu_torch.train.steps import (_label_nll, build_train_step,
                                           compute_loss, init_state,
                                           loss_and_grads, to_device)

torch.set_num_threads(2)
V, L, B, E = 40, 8, 8, 4
KW = dict(num_items=V, seqslen=L, num_units=16, num_heads=2, num_events=E,
          batch_size=B, masklen=2, hidden_dropout_rate=0.0,
          attention_probs_dropout_rate=0.0, l2_reg=1e-4, ct_reg=0.1)
LR = 5e-4  # PRESETS["EasyDGL"]


def _jfeats(features):
    return {k: jnp.asarray(v) for k, v in features.items()}


@pytest.fixture(scope="module")
def world():
    """Three training batches (marks from the loader), the JAX model and
    its initial state, and the JAX states after one and two steps."""
    ds = synthetic_split(num_rows=3 * B, num_items=V, seqslen=L, seed=3)
    table = synthetic_mark_table(V, E, seed=0)
    loader = JBatchLoader(ds, data_mode="mau", batch_size=B, masklen=2,
                          is_training=True, mark_table=table,
                          needs_marks=True, use_native=False)
    batches = [(f, lab) for f, lab, _ in loader.epoch(0)]
    jcfg = jpreset("EasyDGL").replace(use_pallas=False, **KW)
    jm = jbuild(jcfg)
    params = random_flax_params(preset("EasyDGL", **KW), seed=0)
    params["params"]["out_bias"]["output_bias"] = np.random.default_rng(
        5).normal(0, 0.5, V).astype(np.float32)
    tx = joptim.build_optimizer(jcfg.optim)
    state0 = jsteps.TrainState(params, tx.init(params),
                               jnp.zeros((), jnp.int32))
    jstep = jsteps.build_train_step(jm, donate=False)
    rng = jax.random.key(0)
    states, losses = [jax.tree.map(np.asarray, state0)], []
    for f, lab in batches:
        st, loss = jstep(states[-1], _jfeats(f), jnp.asarray(lab), rng)
        states.append(jax.tree.map(np.asarray, st))
        losses.append(float(loss))
    return dict(batches=batches, jm=jm, states=states, losses=losses)


def _port_model(params, **extra):
    return build_model(preset("EasyDGL", **{**KW, **extra}), device="cpu",
                       params=params)


def _jax_loss_and_grads(jm, params, features, labels):
    return jax.jit(jax.value_and_grad(lambda p: jsteps.compute_loss(
        jm, p, _jfeats(features), jnp.asarray(labels))))(params)


def _close(got: torch.Tensor, want: np.ndarray, atol, rtol, what):
    np.testing.assert_allclose(got.detach().numpy(), want, atol=atol,
                               rtol=rtol, err_msg=what)


def test_one_train_step_matches_jax(world):
    """Loss 1e-5 relative; every gradient leaf within d = 1e-6 + 1e-4 of
    the leaf's largest entry (fp32 sums over a few hundred terms taken in
    another order). Parameters after the update: TF-Adam's first step is
    u(g) = -lr g / (|g| + e'), e' = eps / sqrt(1 - b2), so a gradient known
    to within d moves it by up to lr e' d / (|g| - d)^2 where |g| > 2d —
    held to that plus 1e-7 + 1e-5 |p| — and by up to 2 lr (a flipped sign)
    where |g| <= 2d."""
    (features, labels), state0 = world["batches"][0], world["states"][0]
    model = _port_model(state0.params)
    loss, grads = loss_and_grads(model, to_device(features, "cpu"),
                                 torch.as_tensor(labels))
    want_loss, jg = _jax_loss_and_grads(world["jm"], state0.params,
                                        features, labels)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(float(loss), world["losses"][0], rtol=1e-5)
    jg = flax_to_torch(jg)
    assert set(jg) == set(grads)
    for name, want in jg.items():
        scale = float(want.abs().max())
        _close(grads[name], want.numpy(), 1e-6 + 1e-4 * scale, 0, name)
    # the TPP term reaches the intensity head through the intensities
    assert float(jg["block0_bimau.intensity_scaling"].abs().max()) > 1e-4

    step = build_train_step(model)
    state = init_state(model)
    state, loss1 = step(state, features, labels, torch.Generator())
    assert state.step == 1
    np.testing.assert_allclose(float(loss1), world["losses"][0], rtol=1e-5)
    eps_t1 = 1e-8 / np.sqrt(1 - 0.999)
    for name, want in flax_to_torch(world["states"][1].params).items():
        g = jg[name].abs()
        d = 1e-6 + 1e-4 * float(g.max())
        bound = torch.where(
            g > 2 * d,
            1e-7 + 1e-5 * want.abs()
            + LR * eps_t1 * d / (g - d).clamp_min(d) ** 2,
            torch.tensor(2 * LR))
        err = (state.params[name].detach() - want).abs()
        assert bool((err <= bound).all()), name


def test_step_continued_from_a_jax_state(world):
    """Port step 3 from the JAX state after two steps (params and TF-Adam
    state through the bridges): loss 1e-5 relative, parameters atol 2e-6
    (Adam's normalised update: lr times a ratio of fp32 moments) and the
    moments at 1e-4 relative of each leaf's scale; the bridge round trip is
    exact."""
    st2 = world["states"][2]
    adam = st2.opt_state[0]
    model = _port_model(st2.params)
    opt = tf_adam_state_to_torch(adam.count, adam.mu, adam.nu)
    back = tf_adam_state_to_flax(opt)
    assert back[0] == int(adam.count) == 2
    for a, b in zip(jax.tree.leaves(back[1:]),
                    jax.tree.leaves((adam.mu, adam.nu))):
        np.testing.assert_array_equal(a, b)
    state = init_state(model)._replace(opt_state=opt, step=2)
    features, labels = world["batches"][2]
    state, loss = build_train_step(model)(state, features, labels,
                                          torch.Generator())
    np.testing.assert_allclose(float(loss), world["losses"][2], rtol=1e-5)
    st3 = world["states"][3]
    for name, want in flax_to_torch(st3.params).items():
        _close(state.params[name], want.numpy(), 2e-6, 0, name)
    for mine, jtree in ((state.opt_state.mu, st3.opt_state[0].mu),
                        (state.opt_state.nu, st3.opt_state[0].nu)):
        for name, want in flax_to_torch(jtree).items():
            scale = float(want.abs().max())
            _close(mine[name], want.numpy(), 1e-4 * scale + 1e-12, 0, name)
    assert state.opt_state.count == 3


def test_label_nll_matches_jax_and_the_catalog_path():
    """``_label_nll`` on materialised logits against JAX ``_label_nll`` and
    against ``catalog_nll``'s (lse - ll, ll), fp32, 1e-5."""
    rng = np.random.default_rng(6)
    h = rng.normal(size=(9, 8)).astype(np.float32)
    t = rng.normal(size=(21, 8)).astype(np.float32)
    b = rng.normal(size=21).astype(np.float32)
    lab = rng.integers(0, 21, 9)
    logits = h @ t.T + b
    ce, ll = _label_nll(torch.tensor(logits), torch.tensor(lab))
    jce, jll = jsteps._label_nll(jnp.asarray(logits), jnp.asarray(lab))
    lse, cll = catalog_nll(*(torch.tensor(x) for x in (h, t, b, lab)))
    for got, want in ((ce, jce), (ll, jll), (ce, lse - cll), (ll, cll)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("gather_queries", [False, True])
def test_compute_loss_matches_jax_pallas_path(world, gather_queries):
    """The port's loss (plain MAU chain and plain catalog NLL on the CPU)
    against JAX compute_loss with use_pallas=True: the Pallas MAU and
    catalog kernels in interpret mode. fp32, 1e-5 relative; the gradient of
    the catalog path's inputs is held in test_one_train_step_matches_jax."""
    features, labels = world["batches"][1]
    jcfg = jpreset("EasyDGL").replace(use_pallas=True,
                                      gather_queries=gather_queries, **KW)
    jm = jbuild(jcfg)
    params = world["states"][0].params
    with pltpu.force_tpu_interpret_mode():
        want = float(jax.jit(lambda p: jsteps.compute_loss(
            jm, p, _jfeats(features), jnp.asarray(labels)))(params))
    model = _port_model(params, gather_queries=gather_queries)
    got = compute_loss(model, to_device(features, "cpu"),
                       torch.as_tensor(labels))
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-5)


def _tree(rng):
    """A small param tree with the names the decay mask looks at."""
    f32 = np.float32
    return {"params": {
        "dense": {"kernel": rng.normal(size=(3, 4)).astype(f32),
                  "bias": rng.normal(size=(4,)).astype(f32)},
        "ln": {"gamma": rng.normal(size=(4,)).astype(f32),
               "beta": rng.normal(size=(4,)).astype(f32)},
        "emb": {"lookup_table": rng.normal(size=(5, 4)).astype(f32)}}}


@pytest.mark.parametrize("name,clip", [("adam", 0.0), ("adam", 1.5),
                                       ("adamw_warmup", 0.0)])
def test_optimizer_matches_optax(name, clip):
    """Five updates on the same gradients: parameters atol 1e-6 (fp32
    moment arithmetic in another order). The adamw schedule is cut to 2
    warmup and 6 total steps so both of its segments run; clip 1.5 is
    below the gradients' global norm, so clipping acts."""
    rng = np.random.default_rng(0)
    kw = dict(name=name, learning_rate=0.01, clip_norm=clip,
              num_warmup_steps=2, num_train_steps=6, weight_decay=0.1)
    tx = joptim.build_optimizer(JOptimConfig(**kw))
    mine = optim.build_optimizer(OptimConfig(**kw))
    jp = _tree(rng)
    tp = flax_to_torch(jp)
    jstate, tstate = tx.init(jp), mine.init(tp)
    for _ in range(5):
        g = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(
            np.float32), jp)
        upd, jstate = tx.update(g, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tupd, tstate = mine.update(flax_to_torch(g), tstate, tp)
        optim.apply_updates(tp, tupd)
    for key, want in flax_to_torch(jp).items():
        _close(tp[key], want.numpy(), 1e-6, 0, key)


def test_hidden_dropout_statistics():
    """Keep fraction within 5 sigma of 1-p over 200k draws; kept entries
    are exactly x/(1-p) (in x's dtype), dropped ones 0; the same generator
    state gives the same mask; no generator or rate 0 is the identity."""
    p, n = 0.1, 200_000
    x = torch.rand(n) + 0.5
    y = dropout(x, p, torch.Generator().manual_seed(1))
    kept = y != 0
    frac = float(kept.float().mean())
    assert abs(frac - (1 - p)) < 5 * np.sqrt(p * (1 - p) / n)
    assert torch.equal(y[kept], x[kept] / (1 - p))
    assert torch.equal(y, dropout(x, p, torch.Generator().manual_seed(1)))
    assert not torch.equal(y, dropout(x, p, torch.Generator().manual_seed(2)))
    xb = x.to(torch.bfloat16)
    yb = dropout(xb, p, torch.Generator().manual_seed(1))
    assert yb.dtype == torch.bfloat16
    assert torch.equal(yb[yb != 0], xb[yb != 0] / (1 - p))
    assert dropout(x, p, None) is x and dropout(x, 0.0, torch.Generator()) is x


def test_training_forward_with_dropout_is_seeded_by_its_generator(world):
    """With the preset's dropout rates (0.1 / 0.1) the training loss is a
    function of the generator's state: equal for equal seeds, different
    otherwise, and different from the loss at dropout 0."""
    features, labels = world["batches"][0]
    params = world["states"][0].params
    model = _port_model(params, hidden_dropout_rate=0.1,
                        attention_probs_dropout_rate=0.1)
    feats, lab = to_device(features, "cpu"), torch.as_tensor(labels)
    with torch.no_grad():
        a, b, c = (float(compute_loss(model, feats, lab,
                                      torch.Generator().manual_seed(s)))
                   for s in (7, 7, 8))
        with pytest.raises(ValueError, match="Generator"):
            compute_loss(model, feats, lab, None)
    assert a == b and a != c
    assert a != pytest.approx(world["losses"][0], rel=1e-6)
