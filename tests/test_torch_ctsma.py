"""PyTorch port: CTSMA and CTSMA-LC (serving and the train step) vs the JAX
package, on the CPU.

* ``MAU`` with split Q/K/V/T projections and distinct queries and keys
  (both 2C wide, as in CTSMA's first block), causal, against the JAX
  module with ``intensity_impl="xla"``, also with gathered query rows;
  ``MGAU``;
  left-padded key masks whose early rows see no key, and an interval of
  ~11,574 (a first real item's whole timestamp in days);
* CTSMA (C=16, H=2, 2 blocks, L=8, E=3, ct_reg 1e-3, time_scale 1000)
  eval logits, eval-step sums over the ``regressive_entire`` protocol's
  batches (the port's loader against the JAX loader) and
  ``Recommender.recommend`` top-k;
* one ``build_train_step`` step at dropout 0 (softmax-eps over every
  position, L2, the TPP term over every position with RAW spans, TF-Adam)
  against JAX's loss, gradients and update compiled as one program (the
  loss, every gradient leaf and the parameters after the update), and
  against JAX ``build_train_step``'s loss;
* a small CTSMA-LC (L=256, ``attention_impl="flash"``: the blocked plain
  version and ``_MauBlocked`` on the CPU, key blocks of 64) against the
  JAX ``"blocked"`` model: logits and one train step;
* the random param tree against JAX ``init``.

Histories are left-padded with the synthetic timestamps (start 1e9 s), so
the last padding row of a history sees no key under the causal mask, yet
its span is the first real item's whole timestamp and its label that
item: the blind-row rule decides part of the loss. Dropout is 0 where the
two sides are compared (their PRNG streams differ by design). Weights come
from JAX ``init`` with non-zero biases, scalings and output bias.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from easydgl_tpu.config import preset as jpreset
from easydgl_tpu.data.loader import BatchLoader as JBatchLoader
from easydgl_tpu.data.synthetic import synthetic_mark_table, synthetic_split
from easydgl_tpu.eval import metrics as jmetrics
from easydgl_tpu.eval.recommender import Recommender as JRecommender
from easydgl_tpu.models.base import mau_impl as jmau_impl
from easydgl_tpu.models.registry import build_model as jbuild
from easydgl_tpu.nn import temporal as jtemporal
from easydgl_tpu.train import optim as joptim
from easydgl_tpu.train import steps as jsteps
from easydgl_tpu.train.steps import build_eval_step as jbuild_eval_step
from easydgl_tpu_torch.config import preset
from easydgl_tpu_torch.data.loader import BatchLoader, PackedDataset
from easydgl_tpu_torch.eval import metrics
from easydgl_tpu_torch.eval.recommender import Recommender
from easydgl_tpu_torch.kernels import mau_blocked
from easydgl_tpu_torch.models.base import INTENSITIES, mau_impl
from easydgl_tpu_torch.models.registry import build_model
from easydgl_tpu_torch.nn.temporal import MAU, MGAU
from easydgl_tpu_torch.parity import flax_to_torch, random_flax_params
from easydgl_tpu_torch.train.steps import (build_eval_step, build_train_step,
                                           compute_loss, init_state)

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
V, L, B, E = 50, 8, 4, 3
SMALL = dict(num_items=V, seqslen=L, num_units=16, num_heads=2, num_blocks=2,
             num_events=E, batch_size=B, ct_reg=1e-3, time_scale=1000.0,
             hidden_dropout_rate=0.0, attention_probs_dropout_rate=0.0,
             l2_reg=1e-4)
LC = dict(SMALL, num_items=60, seqslen=256, num_blocks=1, batch_size=2,
          mau_block_k=64, compute_dtype="float32")
LR = 5e-4   # PRESETS["CTSMA"] and PRESETS["CTSMA-LC"]


def _jfeats(features):
    return {k: jnp.asarray(v) for k, v in features.items()}


def _tfeats(features):
    return {k: torch.as_tensor(v) for k, v in features.items()}


def _jloader(world, batch_size, train):
    return JBatchLoader(world["ds"], data_mode="regressive_entire",
                        batch_size=batch_size, is_training=train,
                        mark_table=world["table"], needs_marks=True,
                        use_native=False)


def _nonzero(params, rng):
    """Non-zero output bias, projection biases, intensity biases and
    scalings, so every parameter moves the result."""
    p = params["params"]
    p["out_bias"]["output_bias"] = rng.normal(
        0, 0.5, p["out_bias"]["output_bias"].shape).astype(np.float32)
    for name, blk in p.items():
        if not name.endswith("_mau"):
            continue
        for proj in ("q", "k", "v", "t"):
            blk[proj]["bias"] = rng.normal(
                0, 0.1, blk[proj]["bias"].shape).astype(np.float32)
        blk["intensity_dense_bias"] = rng.normal(
            0, 0.1, blk["intensity_dense_bias"].shape).astype(np.float32)
        blk["intensity_scaling"] = rng.normal(
            0, 0.3, blk["intensity_scaling"].shape).astype(np.float32)
    return params


def _world(name, kw, seed):
    """Eval and train batches of the regressive_entire protocol with marks,
    JAX-initialised weights (``_nonzero``), and in one jitted program the
    JAX loss, its gradients and the parameters after JAX's TF-Adam update
    on them: JAX ``build_train_step``'s computation. (The loss is ~2e5
    here, set by the TPP term's raw spans, and the program
    ``build_train_step`` itself compiles moves the gradients by more than
    1e-4 of a leaf's largest entry against this one; see
    ``test_train_step_matches_jax``.)"""
    b, v = kw["batch_size"], kw["num_items"]
    ds = synthetic_split(num_rows=2 * b, num_items=v, seqslen=kw["seqslen"],
                         seed=seed)
    table = synthetic_mark_table(v, E, seed=seed)
    world = dict(ds=ds, table=table, kw=kw, name=name)
    batch = lambda train: next(_jloader(world, b, train).epoch(0))  # noqa
    jcfg = jpreset(name).replace(use_pallas=False, **kw)
    jm = jbuild(jcfg)
    (ef, elab, ev), (tf, tlab, _) = batch(False), batch(True)
    params = jax.tree.map(np.asarray, jax.jit(lambda f: jm.init(
        {"params": jax.random.key(0)}, f, is_training=False))(_jfeats(ef)))
    params = _nonzero(params, np.random.default_rng(5))
    tx = joptim.build_optimizer(jcfg.optim)

    def update(p):
        loss, grads = jax.value_and_grad(lambda q: jsteps.compute_loss(
            jm, q, _jfeats(tf), jnp.asarray(tlab)))(p)
        upd, _ = tx.update(grads, tx.init(p), p)
        return loss, grads, optax.apply_updates(p, upd)

    loss, grads, params1 = jax.jit(update)(params)
    world.update(jm=jm, jcfg=jcfg, params=params, eval=(ef, elab, ev),
                 train=(tf, tlab), loss=float(loss),
                 grads=flax_to_torch(jax.tree.map(np.asarray, grads)),
                 params1=flax_to_torch(jax.tree.map(np.asarray, params1)))
    return world


@pytest.fixture(scope="module")
def small():
    return _world("CTSMA", SMALL, 7)


@pytest.fixture(scope="module")
def lc():
    return _world("CTSMA-LC", LC, 8)


def _port(world):
    return build_model(preset(world["name"], **world["kw"]), device="cpu",
                       params=world["params"])


def _module_inputs(seed, c, t=11, b=3):
    """Queries and keys (B, T, 2C) ~ N(0, 1); left-padded key
    mask (row 0 without a key, row 1 with 3 real keys, row 2 full);
    intervals ~Exp(1) with one of 11,574.07; 20%-dense marks."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    queries = rng.normal(size=(b, t, 2 * c)).astype(f32)
    keys = rng.normal(size=(b, t, 2 * c)).astype(f32)
    km = np.ones((b, t), f32)
    km[0] = 0.0
    km[1, :t - 3] = 0.0
    iv = rng.exponential(1.0, (b, t)).astype(f32)
    iv[1, t - 4] = 1e9 / 86400.0        # the last padding row's span
    oh = (rng.random((b, t, E)) < 0.2).astype(f32)
    return rng, queries, keys, km, iv, oh


@pytest.mark.parametrize("variant", ["mau", "mau_gathered", "mgau"])
def test_mau_and_mgau_modules_match_jax_xla_engine(variant):
    """Split projections with distinct queries and keys (``MAU``, causal),
    also on gathered query rows, and the fused ``MGAU``, against the JAX
    modules' ``"xla"`` engine to 1e-5; the residual is queries[..., :C]."""
    c, h = 16, 2
    rng, queries, keys, km, iv, oh = _module_inputs(11, c)
    if variant == "mgau":
        keys = queries
        jm = jtemporal.MGAU(c, h, E, 0.0, intensity_impl="xla")
        tm = MGAU(2 * c, c, h, E)
    else:
        jm = jtemporal.MAU(c, h, E, 0.0, intensity_impl="xla")
        tm = MAU(2 * c, c, h, E)
    jq, jk = jnp.asarray(queries), jnp.asarray(keys)
    args = tuple(jnp.asarray(x) for x in (km, iv, oh))
    params = jax.tree.map(np.asarray, jax.jit(lambda q, k, *a: jm.init(
        {"params": jax.random.key(0)}, q, k, *a, deterministic=True))(
            jq, jk, *args))
    p = params["params"]
    for proj in ("q", "k", "v", "t", "qkvt"):
        if proj in p:
            p[proj]["bias"] = rng.normal(0, 0.1, p[proj]["bias"].shape
                                         ).astype(np.float32)
    p["intensity_dense_bias"] = rng.normal(
        0, 0.1, p["intensity_dense_bias"].shape).astype(np.float32)
    p["intensity_scaling"] = rng.normal(0, 0.3, E).astype(np.float32)
    qpos = (np.array([[10, 2], [0, 7], [5, 6]], np.int32)
            if variant == "mau_gathered" else None)
    want_o, want_l = jm.apply(
        params, jq, jk, *args, deterministic=True,
        query_positions=None if qpos is None else jnp.asarray(qpos))
    tm.load_state_dict(flax_to_torch(params))
    tq = torch.tensor(queries)
    tk = tq if variant == "mgau" else torch.tensor(keys)
    with torch.no_grad():
        got_o, got_l = tm(tq, tk, *(torch.tensor(x) for x in (km, iv, oh)),
                          query_positions=None if qpos is None
                          else torch.tensor(qpos))
    assert got_o.shape == ((3, 2, c) if qpos is not None else (3, 11, c))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=1e-5,
                               rtol=1e-5)
    if variant == "mau":   # the causal mask: a later key moves no earlier row
        keys2 = keys.copy()
        keys2[:, -1] += 1.0
        with torch.no_grad():
            o2, _ = tm(tq, torch.tensor(keys2),
                       *(torch.tensor(x) for x in (km, iv, oh)))
        assert torch.equal(o2[2, :-1], got_o[2, :-1])
        assert not torch.equal(o2[2, -1], got_o[2, -1])


def test_fused_projection_refuses_gathered_cross_attention():
    """As in JAX: gathered query rows with the fused projection need
    self-attention (``queries is keys``)."""
    c = 16
    _, queries, _, km, iv, oh = _module_inputs(3, c)
    tm = MGAU(2 * c, c, 2, E)
    tm.load_state_dict(flax_to_torch(jax.tree.map(np.asarray, jtemporal.MGAU(
        c, 2, E).init({"params": jax.random.key(0)}, queries, queries, km,
                      iv, oh, deterministic=True))))
    tq = torch.tensor(queries)
    qpos = torch.tensor([[1], [2], [3]])
    rest = tuple(torch.tensor(x) for x in (km, iv, oh))
    with pytest.raises(ValueError, match="self-attention"):
        tm(tq, tq.clone(), *rest, query_positions=qpos)
    with torch.no_grad():
        out, _ = tm(tq, tq, *rest, query_positions=qpos)
    assert out.shape == (3, 1, c)


def test_eval_logits_match_jax(small):
    """Op by op on the JAX side (its jitted CPU program moves these logits
    by ~1e-4 against its own op-by-op run), as the JAX Recommender runs in
    ``test_eval_step_and_recommend_match_jax``, which then finds its
    primitives compiled; the intensities of both blocks too."""
    ef = small["eval"][0]
    assert ef["seqs_i"].shape == (B, L) and ef["seqs_t"].shape == (B, L + 1)
    assert (ef["seqs_i"][:, 0] == 0).any()    # left padding
    with jax.disable_jit():
        want, jaux = small["jm"].apply(small["params"], _jfeats(ef),
                                       is_training=False)
    model = _port(small)
    with torch.no_grad():
        got, aux = model(_tfeats(ef))
    assert got.shape == (B, V)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert len(aux[INTENSITIES]) == 2
    for a, b in zip(aux[INTENSITIES], jaux["intensities"]):
        assert a.shape == (B, 2, L, E)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_loader_matches_jax(small):
    """The port's loader makes the JAX loader's regressive_entire batches:
    ids tokens[:, :-1], every timestamp, seqs_marks of the inputs and, in
    training, next_marks of the labels."""
    ds = PackedDataset(dict(small["ds"].arrays), small["ds"].num_items)
    for train in (False, True):
        mine = BatchLoader(ds, data_mode="regressive_entire", batch_size=3,
                           is_training=train, mark_table=small["table"],
                           needs_marks=True)
        theirs = _jloader(small, 3, train)
        keys = {"seqs_i", "seqs_t", "seqs_marks"} | (
            {"next_marks"} if train else set())
        for (f, lab, valid), (jf, jlab, jvalid) in zip(mine.epoch(0),
                                                       theirs.epoch(0)):
            assert set(f) == set(jf) == keys
            for key in f:
                np.testing.assert_array_equal(f[key], jf[key])
            np.testing.assert_array_equal(lab, jlab)
            np.testing.assert_array_equal(valid, jvalid)
            assert f["seqs_marks"].shape == (3, L, E)
            assert lab.shape == ((3, L) if train else (3, L + 1))


def test_eval_step_and_recommend_match_jax(small):
    model = _port(small)
    cfg = model.cfg
    jstep = jbuild_eval_step(small["jm"], mark_table=small["table"])
    step = build_eval_step(model, mark_table=small["table"])
    jacc, acc = jmetrics.MetricAccumulator(), metrics.MetricAccumulator()
    loader = JBatchLoader(small["ds"], data_mode="regressive_entire",
                          batch_size=3, is_training=False, use_native=False)
    for f, lab, valid in loader.epoch(0):
        jacc.update(jstep(small["params"], _jfeats(f), jnp.asarray(lab),
                          jnp.asarray(valid)))
        acc.update(step(model, f, lab, valid))   # marks on the device
    assert jacc.count == acc.count == 2 * B
    want, got = jacc.result(), acc.result()
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)

    arrays = {k: v[:B] for k, v in small["ds"].arrays.items()}
    with jax.disable_jit():
        want_ids, want_scores = JRecommender(
            small["jcfg"], small["params"], small["table"]).recommend(
                arrays, k=7)
    rec = Recommender(cfg, small["params"], small["table"], device="cpu")
    ids, scores = rec.recommend(arrays, k=7)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(scores, want_scores, **TOL)
    seen = rec.protocol(arrays, False, None)[0]["seqs_i"]
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
    assert model.loss_mode == "softmax_eps" and model.uses_tpp
    names, leaves = zip(*model.named_parameters())
    loss = compute_loss(model, _tfeats(tf), torch.as_tensor(tlab))
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    loss = loss.detach()
    np.testing.assert_allclose(float(loss), world["loss"], rtol=1e-5)
    jg = world["grads"]
    assert set(jg) == set(grads)
    for name, want in jg.items():
        np.testing.assert_allclose(
            grads[name].numpy(), want.numpy(), rtol=0, err_msg=name,
            atol=1e-6 + 1e-4 * float(want.abs().max()))
    # the TPP term reaches the intensity head through the intensities
    assert float(jg["block0_mau.intensity_scaling"].abs().max()) > 1e-4
    state, loss1 = build_train_step(model)(init_state(model), tf, tlab,
                                           torch.Generator())
    np.testing.assert_allclose(float(loss1), world["loss"], rtol=1e-5)
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
    return float(loss), grads


def test_train_step_matches_jax(small):
    """Also against JAX ``build_train_step`` itself: its loss to 1e-5
    relative. Its gradients (mu / (1 - b1) of its Adam state after the
    step) are not held here: at this loss (~2e5, set by the TPP term's raw
    spans) its compiled program moves them by more than 1e-4 of a leaf's
    largest entry against JAX's own value_and_grad, which the port's are
    held to in ``_check_step``."""
    loss, _ = _check_step(small, _port(small))
    jm, (tf, tlab) = small["jm"], small["train"]
    tx = joptim.build_optimizer(small["jcfg"].optim)
    params = jax.tree.map(jnp.asarray, small["params"])
    _, jloss = jsteps.build_train_step(jm, donate=False)(
        jsteps.TrainState(params, tx.init(params), jnp.zeros((), jnp.int32)),
        _jfeats(tf), jnp.asarray(tlab), jax.random.key(0))
    np.testing.assert_allclose(float(jloss), loss, rtol=1e-5)


def test_tpp_term_weights_the_blind_rows_by_raw_spans(small):
    """The last padding row of a history sees no key under the causal mask,
    yet its span is the first real item's raw timestamp (~1e9 s) and its
    label that item: the TPP term counts it with the RAW span, so that
    these rows set most of the term."""
    tf, tlab = small["train"]
    ids, ts = tf["seqs_i"], tf["seqs_t"]
    rows = np.nonzero((ids[:, 0] == 0) & (ids[:, -1] != 0))[0]
    assert len(rows) >= 2
    blind = [(r, int((ids[r] == 0).sum()) - 1) for r in rows]
    for r, i in blind:   # position i sees no real key; i + 1 is real
        assert ids[r, i] == 0 and ids[r, i + 1] != 0
        assert tlab[r, i] == ids[r, i + 1] and ts[r, i] == 0.0
        assert ts[r, i + 1] >= 1e9 - 1 and tf["next_marks"][r, i].any()
    model = _port(small)
    feats, labels = _tfeats(tf), torch.as_tensor(tlab)
    marks = torch.as_tensor(tf["next_marks"])
    without = marks.clone()
    for r, i in blind:
        without[r, i] = 0.0    # the blind rows without their next event
    with torch.no_grad():
        _, aux = model(feats, is_training=True)
        reg = model.tpp_regularizer(aux, feats, labels, marks)
        reg0 = model.tpp_regularizer(aux, feats, labels, without)
    assert float(reg) > 10 * abs(float(reg0))


def test_lc_eval_logits_match_jax_blocked_engine(lc):
    """The streamed engine's plain version (key blocks of 64) at L=256
    against the JAX blocked model, jitted (here its jitted program and its
    op-by-op run agree to ~1e-6; at L=8 they do not, so the short model is
    held to the op-by-op run)."""
    assert jmau_impl(lc["jcfg"]) == "blocked"
    ef = lc["eval"][0]
    want = jax.jit(lambda p, f: lc["jm"].apply(p, f, is_training=False)[0])(
        lc["params"], _jfeats(ef))
    model = _port(lc)
    assert mau_impl(model.cfg) == "streamed"
    with torch.no_grad():
        got, aux = model(_tfeats(ef))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert aux[INTENSITIES][0].shape == (2, 2, 256, E)


def test_lc_train_step_matches_jax_through_the_custom_backward(lc):
    """Through ``_MauBlocked``, causal, once per block in the gradient pass
    and once in the step."""
    calls = []
    apply = mau_blocked._MauBlocked.apply

    def spy(*args):
        calls.append((tuple(args[0].shape), args[12][0]))
        return apply(*args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mau_blocked._MauBlocked, "apply", spy)
        _check_step(lc, _port(lc))
    assert calls == [((2, 256, 16), True)] * 2


def test_long_context_engine_is_the_function_the_model_calls(lc):
    """``CTSMA.long_context_engine`` names the streamed MAU call of its
    blocks: a stand-in put there sees the block's causal call with distinct
    queries and keys, and the plain version it names gives the model's
    logits."""
    model = _port(lc)
    module, name, plain = type(model).long_context_engine
    saved, calls = getattr(module, name), []

    def spy(*args, **kw):
        calls.append((args[11], args[0].data_ptr() != args[1].data_ptr()))
        return plain(*args, **kw)

    ef = _tfeats(lc["eval"][0])
    with torch.no_grad():
        want, _ = model(ef)
        setattr(module, name, spy)
        try:
            got, _ = model(ef)
        finally:
            setattr(module, name, saved)
    assert calls == [(True, True)] * model.cfg.num_blocks
    assert torch.equal(got, want)


def test_random_tree_matches_jax_init(small, lc):
    for world in (small, lc):
        cfg = preset(world["name"], **world["kw"])
        rand = random_flax_params(cfg, 0)
        assert (jax.tree_util.tree_structure(rand)
                == jax.tree_util.tree_structure(world["params"]))
        for a, b in zip(jax.tree.leaves(rand),
                        jax.tree.leaves(world["params"])):
            assert a.shape == b.shape and a.dtype == b.dtype
    blk = random_flax_params(preset("CTSMA", **SMALL), 0)["params"][
        "block0_mau"]
    assert blk["q"]["kernel"].shape == (32, 16)      # the 2C-wide block 0
    assert blk["t"]["kernel"].shape == (32, 16)


@pytest.mark.parametrize("name", ["CTSMA", "CTSMA-LC"])
def test_presets_build_on_the_cpu(name):
    """Full width, each preset's own engine (fused or streamed), 64 marks,
    random weights from the seed; an eval forward on two short rows."""
    cfg = preset(name, num_events=64, num_items=300, seqslen=12)
    model = build_model(cfg, device="cpu")
    assert type(model).__name__ == "CTSMA"
    assert model.block0_mau.q.weight.shape == (512, 1024)
    assert model.block0_mau.intensity_impl == (
        "streamed" if name == "CTSMA-LC" else "fused")
    ds = synthetic_split(num_rows=2, num_items=300, seqslen=12, seed=1)
    f, _, _ = next(BatchLoader(ds, data_mode=model.data_mode, batch_size=2,
                               is_training=False,
                               mark_table=synthetic_mark_table(300, 64),
                               needs_marks=True).epoch(0))
    with torch.no_grad():
        logits, _ = model(_tfeats(f))
    assert logits.shape == (2, 300) and bool(torch.isfinite(logits).all())


def test_training_forward_needs_a_generator_for_dropout(small):
    cfg = preset("CTSMA", **dict(small["kw"], hidden_dropout_rate=0.1,
                                 attention_probs_dropout_rate=0.2))
    model = build_model(cfg, device="cpu", params=small["params"])
    feats = _tfeats(small["train"][0])
    with pytest.raises(ValueError, match="Generator"):
        model(feats, is_training=True)
    none, aux = model(feats, is_training=True,
                      generator=torch.Generator().manual_seed(0))
    assert none is None
    hidden, table, bias = aux["scoring"]
    assert hidden.shape == (B * L, 16)
    assert table.shape == (V, 16) and bias.shape == (V,)
    assert bool(torch.isfinite(hidden).all())
