"""PyTorch port: BERT4REC and BERT4REC-LC (serving and the train step) vs
the JAX package, on the CPU.

* ``BERTAttention`` against the JAX module row by row, left-padded key rows
  and a batch row with no key included, for both cores (``"xla"`` with the
  (B, Tq, Tk) attention mask, and ``"flash"``, non-causal, with the key
  mask and the JAX kernel under ``force_tpu_interpret_mode``);
* BERT4REC (C=16, H=2, 2 blocks, L+1=9, masklen 3) eval logits, eval-step
  sums over the masked protocol's batches (the port's loader against the
  JAX loader) and ``Recommender.recommend`` top-k, for both cores;
* one ``build_train_step`` step at dropout 0 (the ``sparse_ce`` loss over
  the masked positions, L2, TF-Adam) against JAX ``build_train_step``: the
  loss, every gradient leaf and the parameters after the update;
* a small BERT4REC-LC model (L+1=256, ``attention_impl="flash"``: the
  plain flash version and ``_FlashAttention`` on the CPU): logits and one
  train step;
* the random param tree against JAX ``init``, and the truncated normal of
  the q/k/v kernels;
* ``cfg.remat``: at dropout 0.1 the loss, every gradient and the
  generator's state after the step equal those without it.

The JAX reference of a ``"flash"`` model outside the module test is its
``"xla"`` model: the two are one function on every row at dropout 0
(``tests/test_long_context.py::test_bert4rec_flash_equals_xla``). Dropout
is 0 where the two sides are compared (their PRNG streams differ by
design). Weights come from JAX ``init`` with a non-zero output bias.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from easydgl_tpu.config import preset as jpreset
from easydgl_tpu.data.loader import BatchLoader as JBatchLoader
from easydgl_tpu.data.synthetic import synthetic_split
from easydgl_tpu.eval import metrics as jmetrics
from easydgl_tpu.eval.recommender import Recommender as JRecommender
from easydgl_tpu.models.registry import build_model as jbuild
from easydgl_tpu.nn.attention import BERTAttention as JBERTAttention
from easydgl_tpu.train import optim as joptim
from easydgl_tpu.train import steps as jsteps
from easydgl_tpu.train.steps import build_eval_step as jbuild_eval_step
from easydgl_tpu_torch.config import preset
from easydgl_tpu_torch.data.loader import BatchLoader, PackedDataset
from easydgl_tpu_torch.eval import metrics
from easydgl_tpu_torch.eval.recommender import Recommender
from easydgl_tpu_torch.kernels import flash_attention as flash
from easydgl_tpu_torch.models.registry import build_model
from easydgl_tpu_torch.nn.attention import BERTAttention
from easydgl_tpu_torch.parity import (FlaxInit, flax_to_torch,
                                      random_flax_params)
from easydgl_tpu_torch.train.steps import (build_eval_step, build_train_step,
                                           compute_loss, init_state,
                                           loss_and_grads)

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
V, L, B = 50, 8, 4
SMALL = dict(num_items=V, seqslen=L, masklen=3, num_units=16, num_heads=2,
             num_blocks=2, batch_size=B, hidden_dropout_rate=0.0,
             attention_probs_dropout_rate=0.0, l2_reg=1e-4)
LC = dict(SMALL, num_items=60, seqslen=255, masklen=32, batch_size=2,
          compute_dtype="float32")
LR = 5e-5   # PRESETS["BERT4REC"] and PRESETS["BERT4REC-LC"]
IMPLS = ("xla", "flash")


def _jfeats(features):
    return {k: jnp.asarray(v) for k, v in features.items()}


def _jloader(world, batch_size, train):
    return JBatchLoader(world["ds"], data_mode="masked",
                        batch_size=batch_size,
                        masklen=world["kw"]["masklen"], is_training=train,
                        use_native=False)


def _world(name, kw, seed):
    """Eval and train batches of the masked protocol, JAX-initialised
    weights with a non-zero output bias, and the JAX (xla) loss and
    gradients, and the parameters after one JAX ``build_train_step``."""
    b, v = kw["batch_size"], kw["num_items"]
    ds = synthetic_split(num_rows=2 * b, num_items=v, seqslen=kw["seqslen"],
                         seed=seed)
    world = dict(ds=ds, kw=kw, name=name)
    batch = lambda train: next(_jloader(world, b, train).epoch(0))  # noqa
    jcfg = jpreset(name).replace(use_pallas=False, attention_impl="xla", **kw)
    jm = jbuild(jcfg)
    (ef, elab, ev), (tf, tlab, _) = batch(False), batch(True)
    params = jax.tree.map(np.asarray, jax.jit(lambda f: jm.init(
        {"params": jax.random.key(0)}, f, is_training=False))(_jfeats(ef)))
    params["params"]["out_bias"]["output_bias"] = np.random.default_rng(
        5).normal(0, 0.5, v + 1).astype(np.float32)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jsteps.compute_loss(
        jm, p, _jfeats(tf), jnp.asarray(tlab))))(params)
    tx = joptim.build_optimizer(jcfg.optim)
    state0 = jsteps.TrainState(params, tx.init(params),
                               jnp.zeros((), jnp.int32))
    state1, loss1 = jsteps.build_train_step(jm, donate=False)(
        state0, _jfeats(tf), jnp.asarray(tlab), jax.random.key(0))
    world.update(jm=jm, jcfg=jcfg, params=params, eval=(ef, elab, ev),
                 train=(tf, tlab), loss=float(loss), loss1=float(loss1),
                 grads=flax_to_torch(jax.tree.map(np.asarray, grads)),
                 params1=flax_to_torch(jax.tree.map(np.asarray,
                                                    state1.params)))
    return world


@pytest.fixture(scope="module")
def small():
    return _world("BERT4REC", SMALL, 7)


@pytest.fixture(scope="module")
def lc():
    return _world("BERT4REC-LC", LC, 8)


def _port(world, impl):
    cfg = preset(world["name"], **dict(world["kw"], attention_impl=impl))
    return build_model(cfg, device="cpu", params=world["params"])


@pytest.mark.parametrize("impl", IMPLS)
def test_bert_attention_matches_jax(impl):
    """Distinct queries and keys; left-padded key rows, and batch row 0
    with no real key at all (every row of it the mean of V)."""
    rng = np.random.default_rng(3)
    b, t, c = 3, 13, 16
    queries = rng.standard_normal((b, t, c)).astype(np.float32)
    keys = rng.standard_normal((b, t, c)).astype(np.float32)
    key_mask = np.ones((b, t), np.float32)
    key_mask[0] = 0.0
    key_mask[1, :4] = 0.0
    key_mask[2, :9] = 0.0
    attn_mask = np.ones((b, t, 1), np.float32) * key_mask[:, None, :]
    jm = JBERTAttention(c, 2, 0.0, impl=impl)
    params = JBERTAttention(c, 2, 0.0).init(
        jax.random.key(1), queries, keys, attn_mask, deterministic=True)
    with pltpu.force_tpu_interpret_mode():
        want = jm.apply(params, queries, keys, attn_mask,
                        deterministic=True, key_mask=key_mask)
    attn = BERTAttention(c, 2, impl=impl)
    attn.load_state_dict(flax_to_torch(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = attn(torch.tensor(queries), torch.tensor(keys),
                   torch.tensor(attn_mask), key_mask=torch.tensor(key_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("impl", IMPLS)
def test_eval_logits_match_jax(small, impl):
    ef = small["eval"][0]
    jm = jbuild(small["jcfg"].replace(attention_impl=impl))
    with pltpu.force_tpu_interpret_mode():
        want, _ = jm.apply(small["params"], _jfeats(ef), is_training=False)
    model = _port(small, impl)
    with torch.no_grad():
        got, _ = model({k: torch.as_tensor(v) for k, v in ef.items()})
    assert got.shape == (B, V + 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_lc_eval_logits_match_jax(lc):
    """The flash core's plain version at L+1=256 against the JAX model."""
    ef = lc["eval"][0]
    want, _ = lc["jm"].apply(lc["params"], _jfeats(ef), is_training=False)
    model = _port(lc, "flash")
    flash.flash_attention_fwd.launches = 0
    with torch.no_grad():
        got, _ = model({k: torch.as_tensor(v) for k, v in ef.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert flash.flash_attention_fwd.launches == 0   # the CPU: plain


def test_loader_matches_jax(small):
    """The port's loader makes the JAX loader's masked batches: eval with
    the last token the MASK id, training with masklen positions masked."""
    ds = PackedDataset(dict(small["ds"].arrays), small["ds"].num_items)
    for train in (False, True):
        mine = BatchLoader(ds, data_mode="masked", batch_size=3,
                           masklen=SMALL["masklen"], is_training=train,
                           use_native=False)
        theirs = _jloader(small, 3, train)
        for (f, lab, valid), (jf, jlab, jvalid) in zip(mine.epoch(0),
                                                       theirs.epoch(0)):
            assert set(f) == set(jf)
            for key in f:
                np.testing.assert_array_equal(f[key], jf[key])
            np.testing.assert_array_equal(lab, jlab)
            np.testing.assert_array_equal(valid, jvalid)
            if not train:
                assert (f["seqs_i"][:, -1] == V).all()


@pytest.mark.parametrize("impl", IMPLS)
def test_eval_step_and_recommend_match_jax(small, impl):
    model = _port(small, impl)
    cfg = model.cfg
    jstep = jbuild_eval_step(small["jm"])
    step = build_eval_step(model)
    jacc, acc = jmetrics.MetricAccumulator(), metrics.MetricAccumulator()
    for f, lab, valid in _jloader(small, 3, False).epoch(0):
        jacc.update(jstep(small["params"], _jfeats(f), jnp.asarray(lab),
                          jnp.asarray(valid)))
        acc.update(step(model, f, lab, valid))
    assert jacc.count == acc.count == 2 * B
    want, got = jacc.result(), acc.result()
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)

    arrays = {k: v[:B] for k, v in small["ds"].arrays.items()}
    with jax.disable_jit():
        want_ids, want_scores = JRecommender(
            small["jcfg"], small["params"]).recommend(arrays, k=7)
    rec = Recommender(cfg, small["params"], device="cpu")
    ids, scores = rec.recommend(arrays, k=7)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(scores, want_scores, **TOL)
    seen = rec.protocol(arrays, False, None)[0]["seqs_i"]
    assert (seen[:, -1] == V).all()   # the MASK id in the last position
    for r in range(B):
        assert not set(ids[r]) & set(seen[r].tolist())


def _check_step(world, model):
    """One ``build_train_step`` step: loss 1e-5 relative; every gradient
    leaf within 1e-6 + 1e-4 of its largest entry (fp32 sums in another
    order); parameters after the update: TF-Adam's first step is
    u(g) = -lr g / (|g| + e'), e' = eps / sqrt(1 - b2), so a gradient known
    to within d moves it by up to lr e' d / (|g| - d)^2 where |g| > 2d —
    held to that plus 1e-7 + 1e-5 |p| — and by up to 2 lr where |g| <= 2d."""
    tf, tlab = world["train"]
    assert model.loss_mode == "sparse_ce"
    names, leaves = zip(*model.named_parameters())
    feats = {k: torch.as_tensor(v) for k, v in tf.items()}
    loss = compute_loss(model, feats, torch.as_tensor(tlab))
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    loss = loss.detach()
    np.testing.assert_allclose(float(loss), world["loss"], rtol=1e-5)
    jg = world["grads"]
    assert set(jg) == set(grads)
    for name, want in jg.items():
        np.testing.assert_allclose(
            grads[name].numpy(), want.numpy(), rtol=0, err_msg=name,
            atol=1e-6 + 1e-4 * float(want.abs().max()))
    state, loss1 = build_train_step(model)(init_state(model), tf, tlab,
                                           torch.Generator())
    np.testing.assert_allclose(float(loss1), world["loss1"], rtol=1e-5)
    eps_t1 = 1e-8 / np.sqrt(1 - 0.999)
    for name, want in world["params1"].items():
        g = jg[name].abs()
        d = 1e-6 + 1e-4 * float(g.max())
        bound = torch.where(
            g > 2 * d,
            1e-7 + 1e-5 * want.abs()
            + LR * eps_t1 * d / (g - d).clamp_min(d) ** 2,
            torch.tensor(2 * LR))
        err = (state.params[name].detach() - want).abs()
        assert bool((err <= bound).all()), name


@pytest.mark.parametrize("impl", IMPLS)
def test_train_step_matches_jax(small, impl):
    _check_step(small, _port(small, impl))


def test_lc_train_step_matches_jax(lc):
    """Through ``_FlashAttention`` (its plain pieces on the CPU),
    non-causal."""
    calls = []
    apply = flash._FlashAttention.apply

    def spy(*args):
        calls.append((tuple(args[0].shape), args[5][0]))
        return apply(*args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flash._FlashAttention, "apply", spy)
        _check_step(lc, _port(lc, "flash"))
    # two blocks, in the gradient pass and in the step; not causal
    assert calls == [((2, 2, 256, 8), False)] * 4


def test_long_context_engine_is_the_function_the_model_calls(lc):
    """``BERT4REC.long_context_engine`` names the flash attention call of
    its blocks: a stand-in put there sees both blocks' calls, and the plain
    version it names gives the model's logits."""
    module, name, plain = type(_port(lc, "flash")).long_context_engine
    saved, calls = getattr(module, name), []

    def spy(*args, **kw):
        calls.append(kw["causal"])
        return plain(*args, **kw)

    ef = {k: torch.as_tensor(v) for k, v in lc["eval"][0].items()}
    model = _port(lc, "flash")
    with torch.no_grad():
        want, _ = model(ef)
        setattr(module, name, spy)
        try:
            got, _ = model(ef)
        finally:
            setattr(module, name, saved)
    assert calls == [False, False] and torch.equal(got, want)


def test_random_tree_matches_jax_init(small, lc):
    for world in (small, lc):
        cfg = preset(world["name"], **world["kw"])
        rand = random_flax_params(cfg, 0)
        assert (jax.tree_util.tree_structure(rand)
                == jax.tree_util.tree_structure(world["params"]))
        for a, b in zip(jax.tree.leaves(rand),
                        jax.tree.leaves(world["params"])):
            assert a.shape == b.shape and a.dtype == b.dtype
        for i in range(cfg.num_blocks):
            for proj in ("q", "k", "v"):
                w = rand["params"][f"block{i}_attn"][proj]["kernel"]
                assert np.abs(w).max() < 0.04


def test_truncated_normal_matches_jax():
    """(-2, 2) times std, no variance correction: the std is ~0.8796 std,
    as jax's initializer draws it."""
    got = FlaxInit(0).truncated_normal(0.02, 512, 512)
    want = np.asarray(jax.nn.initializers.truncated_normal(0.02)(
        jax.random.key(0), (512, 512)))
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got).max() < 0.04 and np.abs(want).max() < 0.04
    for x in (got, want):
        np.testing.assert_allclose(x.std(), 0.02 * 0.87962566, rtol=1e-2)
        assert abs(float(x.mean())) < 1e-4


def test_training_forward_needs_a_generator_for_dropout(small):
    cfg = preset("BERT4REC", **dict(small["kw"], hidden_dropout_rate=0.1,
                                    attention_probs_dropout_rate=0.1))
    model = build_model(cfg, device="cpu", params=small["params"])
    feats = {k: torch.as_tensor(v) for k, v in small["train"][0].items()}
    with pytest.raises(ValueError, match="Generator"):
        model(feats, is_training=True)
    none, aux = model(feats, is_training=True,
                      generator=torch.Generator().manual_seed(0))
    assert none is None
    hidden, table, bias = aux["scoring"]
    assert hidden.shape == (B * SMALL["masklen"], 16)
    assert table.shape == (V + 2, 16) and bias.shape == (V + 2,)
    assert bool(torch.isfinite(hidden).all())


@pytest.mark.parametrize("impl", IMPLS)
def test_remat_recomputes_blocks_with_the_forwards_masks(small, impl):
    """2 blocks, C=16, L+1=9, dropout 0.1 on both rates, one generator
    seed: with ``remat`` the blocks' activations are recomputed in the
    backward from the generator's state at each block's start, so every
    mask is the forward's; loss and gradients equal the run without it to
    1e-6, and the generator ends where the forward left it."""
    tf, tlab = small["train"]
    feats = {k: torch.as_tensor(v) for k, v in tf.items()}
    runs = {}
    for remat, seed in ((False, 3), (True, 3), (False, 4)):
        cfg = preset("BERT4REC", **dict(small["kw"], attention_impl=impl,
                                        hidden_dropout_rate=0.1,
                                        attention_probs_dropout_rate=0.1,
                                        remat=remat))
        model = build_model(cfg, device="cpu", params=small["params"])
        gen = torch.Generator().manual_seed(seed)
        loss, grads = loss_and_grads(model, feats, torch.as_tensor(tlab),
                                     gen)
        runs[remat, seed] = (loss, grads, gen.get_state())
    (loss0, g0, s0), (loss1, g1, s1) = runs[False, 3], runs[True, 3]
    assert float(runs[False, 4][0]) != float(loss0)   # the masks matter
    assert list(g0) == list(g1)
    np.testing.assert_allclose(float(loss1), float(loss0), rtol=0, atol=1e-6)
    for name, want in g0.items():
        np.testing.assert_allclose(g1[name].numpy(), want.numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)
    assert torch.equal(s0, s1)
