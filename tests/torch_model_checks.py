"""Parity checks of a whole model of the PyTorch port (its own data
protocol: regressive, GREC's masked encoder-decoder, TimelyREC's datetime
fields) against the JAX package on the CPU, shared by
``test_torch_gru4rec.py``, ``test_torch_tisasrec.py``, the Bochner models'
files, ``test_torch_grec.py`` and ``test_torch_timelyrec.py``: a
JAX-initialised world (``make_world``), the eval logits, the eval step
and ``recommend``, one train step with the presets' clipped TF-Adam, the
random param tree, the bridges' round trip and
``Recommender.from_checkpoint``. ``make_world(..., op_by_op=True)`` runs every JAX computation op by
op (``jax.disable_jit``) rather than jitted: the jitted CPU program divides
the stamps by ``time_scale`` as a product with its fp32 reciprocal, which
moves a ~1e9 s stamp by an ulp, and the time models' cos features with it.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from easydgl_tpu.config import preset as jpreset
from easydgl_tpu.data.loader import BatchLoader as JBatchLoader
from easydgl_tpu.data.synthetic import synthetic_split
from easydgl_tpu.eval import metrics as jmetrics
from easydgl_tpu.eval.recommender import Recommender as JRecommender
from easydgl_tpu.models.registry import build_model as jbuild
from easydgl_tpu.train import optim as joptim
from easydgl_tpu.train import steps as jsteps
from easydgl_tpu.train.steps import build_eval_step as jbuild_eval_step
from easydgl_tpu_torch.config import preset
from easydgl_tpu_torch.eval import metrics
from easydgl_tpu_torch.eval.recommender import Recommender
from easydgl_tpu_torch.models.registry import build_model
from easydgl_tpu_torch.parity import (flax_to_torch, random_flax_params,
                                      tf_adam_state_to_flax,
                                      tf_adam_state_to_torch, torch_to_flax)
from easydgl_tpu_torch.train.steps import (build_eval_step, build_train_step,
                                           compute_loss, init_state)

TOL = dict(atol=1e-4, rtol=1e-4)


def jfeats(features):
    return {k: jnp.asarray(v) for k, v in features.items()}


def tfeats(features):
    return {k: torch.as_tensor(v) for k, v in features.items()}


def _nonzero(params, rng):
    """Every bias and the output bias drawn non-zero, so each parameter
    moves the result."""
    def draw(tree):
        for key, val in tree.items():
            if isinstance(val, dict):
                draw(val)
            elif key in ("bias", "output_bias") or key.startswith("b"):
                tree[key] = rng.normal(0, 0.3, val.shape).astype(np.float32)
    draw(params["params"])
    return params


@contextlib.contextmanager
def jax_flash_reference():
    """JAX's flash kernel replaced by its plain reference
    (``flash_attention_reference``, the kernel's semantics in jnp) while a
    whole JAX model runs, as the JAX tests allow on the CPU: its Pallas
    kernel in interpret mode, op by op, takes minutes."""
    import easydgl_tpu.kernels.flash_attention as jfa
    saved = jfa.flash_attention

    def plain(q, k, v, key_mask=None, *, causal=False, scale=None,
              dropout_rate=0.0, seed=None):
        del seed
        return jfa.flash_attention_reference(q, k, v, key_mask,
                                             causal=causal, scale=scale,
                                             dropout_rate=dropout_rate)

    jfa.flash_attention = plain
    try:
        yield
    finally:
        jfa.flash_attention = saved


def model_context(form):
    """The context a whole JAX model of ``attention_impl`` ``form`` runs
    in (``jax_flash_reference`` for ``"flash"``)."""
    return jax_flash_reference() if form == "flash" else \
        contextlib.nullcontext()


def _context(world):
    """The world's context for its JAX computations (``make_world``)."""
    return world.get("context", contextlib.nullcontext)()


def _jax_mode(world):
    """The context the world's JAX computations run in: op by op, or as
    written (jitted)."""
    return jax.disable_jit() if world.get("op_by_op") else \
        contextlib.nullcontext()


def make_world(name, kw, seed, clip_norm=None, op_by_op=False,
               context=contextlib.nullcontext, data=None):
    """Eval and train batches of the model's protocol, JAX-initialised
    weights (``_nonzero``), in one jitted program (op by op with
    ``op_by_op``) the JAX loss, its gradients and the parameters after
    JAX's TF-Adam update, and the loss of JAX ``build_train_step`` (op by
    op, where the models have no dropout, the loss of the same forward).
    ``clip_norm``: another global-norm clip than the preset's, on both
    sides. ``context``: a context manager factory every JAX computation
    runs under (e.g. Pallas interpret mode). ``data``: a function that
    edits the split's arrays in place (the split has the datetime
    fields)."""
    b, v = kw["batch_size"], kw["num_items"]
    ds = synthetic_split(num_rows=2 * b, num_items=v, seqslen=kw["seqslen"],
                         seed=seed, with_datetime=True)
    if data is not None:
        data(ds.arrays)
    jcfg = jpreset(name).replace(use_pallas=False, **kw)
    if clip_norm is not None:
        jcfg = jcfg.replace(optim=dataclasses.replace(jcfg.optim,
                                                      clip_norm=clip_norm))
    jm = jbuild(jcfg)
    batch = lambda train: next(JBatchLoader(  # noqa: E731
        ds, data_mode=jm.data_mode, batch_size=b, masklen=jcfg.masklen,
        is_training=train, use_native=False).epoch(0))
    (ef, elab, ev), (tf, tlab, _) = batch(False), batch(True)
    params = jax.tree.map(np.asarray, jax.jit(lambda f: jm.init(
        {"params": jax.random.key(0)}, f, is_training=False))(jfeats(ef)))
    params = _nonzero(params, np.random.default_rng(5))
    tx = joptim.build_optimizer(jcfg.optim)

    def loss_grads(p):
        return jax.value_and_grad(lambda q: jsteps.compute_loss(
            jm, q, jfeats(tf), jnp.asarray(tlab)))(p)

    def apply(p, grads):
        upd, _ = tx.update(grads, tx.init(p), p)
        return optax.apply_updates(p, upd)

    def update(p):
        loss, grads = loss_grads(p)
        return loss, grads, apply(p, grads)

    if op_by_op:
        # the model op by op; the TF-Adam update of its gradients (no
        # stamp in it) jitted; the train step's loss is its forward's,
        # compute_loss at these params (no dropout), not run twice
        with jax.disable_jit(), context():
            loss, grads = loss_grads(params)
        params1 = jax.jit(apply)(params, grads)
        loss1 = loss
    else:
        loss, grads, params1 = jax.jit(update)(params)
        state0 = jsteps.TrainState(jax.tree.map(jnp.asarray, params),
                                   tx.init(params), jnp.zeros((), jnp.int32))
        _, loss1 = jsteps.build_train_step(jm, donate=False)(
            state0, jfeats(tf), jnp.asarray(tlab), jax.random.key(0))
    return dict(ds=ds, jm=jm, jcfg=jcfg, kw=kw, name=name, params=params,
                clip_norm=clip_norm, op_by_op=op_by_op, context=context,
                eval=(ef, elab, ev), train=(tf, tlab), loss=float(loss),
                loss1=float(loss1),
                grads=flax_to_torch(jax.tree.map(np.asarray, grads)),
                params1=flax_to_torch(jax.tree.map(np.asarray, params1)))


def etl_pads(arrays):
    """A ``make_world`` data edit: month and day 0 at every padded
    position, as the ETL leaves them (the synthetic split writes 1)."""
    pad = arrays["seqs_i"] == 0
    assert pad.any()
    for key in ("seqs_month", "seqs_day"):
        arrays[key] = np.where(pad, 0, arrays[key]).astype(np.int32)


def port(world, **overrides):
    cfg = preset(world["name"], **dict(world["kw"], **overrides))
    if world["clip_norm"] is not None:
        cfg = cfg.replace(optim=dataclasses.replace(
            cfg.optim, clip_norm=world["clip_norm"]))
    return build_model(cfg, device="cpu", params=world["params"])


def check_eval_logits(world):
    """Against the JAX model op by op (its jitted CPU program moves the
    logits by up to ~1e-4 against its own op-by-op run)."""
    ef = world["eval"][0]
    with jax.disable_jit(), _context(world):
        want, _ = world["jm"].apply(world["params"], jfeats(ef),
                                    is_training=False)
    with torch.no_grad():
        got, _ = port(world)(tfeats(ef))
    assert got.shape == (world["kw"]["batch_size"],
                         world["jm"].vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def check_eval_step_and_recommend(world):
    """The eval step's metric sums over the split, in batches of 3 (a
    ragged last batch), or op by op of the world's batch size (the shapes
    the JAX side has compiled already); ``recommend`` on one batch."""
    model = port(world)
    b = world["kw"]["batch_size"]
    eval_batch = b if world.get("op_by_op") else 3
    jstep = jbuild_eval_step(world["jm"])
    step = build_eval_step(model)
    jacc, acc = jmetrics.MetricAccumulator(), metrics.MetricAccumulator()
    for f, lab, valid in JBatchLoader(world["ds"],
                                      data_mode=world["jm"].data_mode,
                                      batch_size=eval_batch,
                                      is_training=False,
                                      use_native=False).epoch(0):
        with _jax_mode(world), _context(world):
            jacc.update(jstep(world["params"], jfeats(f), jnp.asarray(lab),
                              jnp.asarray(valid)))
        acc.update(step(model, f, lab, valid))
    assert jacc.count == acc.count == 2 * b
    want, got = jacc.result(), acc.result()
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)

    arrays = {k: v[:b] for k, v in world["ds"].arrays.items()}
    with jax.disable_jit(), _context(world):
        want_ids, want_scores = JRecommender(
            world["jcfg"], world["params"]).recommend(arrays, k=7)
    rec = Recommender(model.cfg, world["params"], device="cpu")
    ids, scores = rec.recommend(arrays, k=7)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(scores, want_scores, **TOL)
    seen = rec.protocol(arrays, False, None)[0]["seqs_i"]
    for r in range(b):
        assert not set(ids[r]) & set(seen[r].tolist())


def check_step(world, model):
    """One ``build_train_step`` step: loss 1e-5 relative; every gradient
    leaf within 1e-6 + 1e-4 of its largest entry (an attention key bias,
    whose gradient is 0 in exact arithmetic, of its key weight's largest
    entry); parameters after the
    update. The step clips the gradients to global norm ``clip`` where the
    optimizer has one (scale s = min(1, clip / |g|), else 1); TF-Adam's first step is then
    u(g') = -lr g' / (|g'| + e'), e' = eps / sqrt(1 - b2), so a clipped
    gradient known to within d' = s (d + 1e-4 |g|) (the norm's error
    included) moves it by up to lr e' d' / (|g'| - d')^2 where |g'| > 2d' —
    held to that plus 1e-7 + 1e-5 |p| — and by up to 2 lr where
    |g'| <= 2d'. That update hardly moves with s, so the clip is held on
    the first moment the step leaves, (1 - b1) g', to (1 - b1) d'."""
    tf, tlab = world["train"]
    names, leaves = zip(*model.named_parameters())
    loss = compute_loss(model, tfeats(tf), torch.as_tensor(tlab))
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    np.testing.assert_allclose(float(loss.detach()), world["loss"],
                               rtol=1e-5)
    jg = world["grads"]
    assert set(jg) == set(grads)
    scale = {name: float((jg[name[:-4] + "weight"]
                          if name.endswith("_attn.k.bias") else g
                          ).abs().max()) for name, g in jg.items()}
    for name, want in jg.items():
        np.testing.assert_allclose(
            grads[name].numpy(), want.numpy(), rtol=0, err_msg=name,
            atol=1e-6 + 1e-4 * scale[name])
    state, loss1 = build_train_step(model)(init_state(model), tf, tlab,
                                           torch.Generator())
    np.testing.assert_allclose(float(loss1), world["loss1"], rtol=1e-5)
    opt = world["jcfg"].optim
    mine = model.cfg.optim
    assert (mine.learning_rate, mine.beta2, mine.eps, mine.clip_norm) == (
        opt.learning_rate, opt.beta2, opt.eps, opt.clip_norm)
    lr, eps_t1 = opt.learning_rate, opt.eps / np.sqrt(1 - opt.beta2)
    norm = float(torch.sqrt(sum(g.square().sum() for g in jg.values())))
    s = min(1.0, opt.clip_norm / norm) if opt.clip_norm > 0 else 1.0
    for name, want in world["params1"].items():
        g = jg[name].abs()
        d = s * (1e-6 + 1e-4 * scale[name] + 1e-4 * g)
        g = s * g
        bound = torch.where(
            g > 2 * d,
            1e-7 + 1e-5 * want.abs()
            + lr * eps_t1 * d / (g - d).clamp_min(d) ** 2,
            torch.tensor(2 * lr))
        err = (state.params[name].detach() - want).abs()
        assert bool((err <= bound).all()), name
        mu_err = (state.opt_state.mu[name] - (1 - opt.beta1) * s
                  * jg[name]).abs()
        assert bool((mu_err <= (1 - opt.beta1) * d).all()), name
    return s


def check_bridges(world):
    """The weight bridge's round trip, flax -> port -> flax, is exact and
    keeps every leaf's shape (GREC's 3-D convolution weights, TimelyREC's
    0-d ``te_weight``); so is the TF-Adam state's after one port step,
    whose moments come back in the flax tree's layout."""
    params = world["params"]
    back = torch_to_flax(flax_to_torch(params))
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    model = port(world)
    tf, tlab = world["train"]
    state, _ = build_train_step(model)(init_state(model), tf, tlab,
                                       torch.Generator())
    count, mu, nu = tf_adam_state_to_flax(state.opt_state)
    assert count == 1
    for tree in (mu, nu):
        assert (jax.tree_util.tree_structure(tree)
                == jax.tree_util.tree_structure(params))
    again = tf_adam_state_to_torch(count, mu, nu)
    for name, moment in state.opt_state.mu.items():
        assert again.mu[name].shape == moment.shape
        assert torch.equal(again.mu[name], moment)
        assert torch.equal(again.nu[name], state.opt_state.nu[name])


def check_from_checkpoint(cfg, ckpt_dir):
    """``Recommender.from_checkpoint`` of a training run's checkpoint (the
    CLI's synthetic test split) serves what the checkpoint's weights,
    loaded by hand, serve: ranked top-k, never id 0."""
    from easydgl_tpu_torch.data.synthetic import synthetic_split as split
    from easydgl_tpu_torch.train.checkpoint import Checkpointer
    head = {k: v[:4] for k, v in split(
        num_rows=8, num_items=cfg.num_items, seqslen=cfg.seqslen, seed=3,
        with_datetime=True).arrays.items()}
    rec = Recommender.from_checkpoint(cfg, ckpt_dir, head, device="cpu")
    ckpt = Checkpointer(ckpt_dir)
    by_hand = build_model(cfg, device="cpu")
    by_hand.load_state_dict(torch.load(ckpt.path(ckpt.latest_step()),
                                       weights_only=True)["params"])
    ids, scores = rec.recommend(head, k=10)
    want_ids, want_scores = Recommender(cfg, by_hand).recommend(head, k=10)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(scores, want_scores)
    assert (ids > 0).all() and (scores[:, :-1] >= scores[:, 1:]).all()


def check_random_tree(world):
    cfg = preset(world["name"], **world["kw"])
    rand = random_flax_params(cfg, 0)
    assert (jax.tree_util.tree_structure(rand)
            == jax.tree_util.tree_structure(world["params"]))
    for a, b in zip(jax.tree.leaves(rand), jax.tree.leaves(world["params"])):
        assert a.shape == b.shape and a.dtype == b.dtype
