"""PyTorch port: the EasyDGL model and serving slice vs the JAX package, on
the CPU.

Whole-model logits (eval, gathered eval, and the training forward at
dropout 0) with weights carried by the bridge, held to atol = rtol = 1e-4;
the metric functions fed the SAME logits (exact ties, duplicate seen ids);
the eval-step sums and ``Recommender.recommend`` end to end; the bridge's
round trip and its random tree. The same for a small EasyDGL-LC
configuration (L+1 = 256, ``attention_impl="flash"``): the port's blocked
engine against the JAX blocked engine, run op by op (its jitted CPU program
moves the logits by up to ~1e-3 against its own op-by-op run)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easydgl_tpu.config import preset as jpreset
from easydgl_tpu.data.loader import BatchLoader as JBatchLoader
from easydgl_tpu.data.synthetic import synthetic_mark_table, synthetic_split
from easydgl_tpu.eval import metrics as jmetrics
from easydgl_tpu.eval.recommender import Recommender as JRecommender
from easydgl_tpu.models.registry import build_model as jbuild
from easydgl_tpu.train.steps import build_eval_step as jbuild_eval_step
from easydgl_tpu_torch.config import preset
from easydgl_tpu_torch.data.loader import BatchLoader
from easydgl_tpu_torch.eval import metrics
from easydgl_tpu_torch.eval.recommender import Recommender
from easydgl_tpu_torch.models.base import SCORING, mau_impl, tied_logits
from easydgl_tpu_torch.models.registry import MODELS, build_model
from easydgl_tpu_torch.parity import (flax_to_torch, random_flax_params,
                                      torch_to_flax)
from easydgl_tpu_torch.train.steps import build_eval_step

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
V, L, B, E = 40, 10, 4, 4
KW = dict(num_items=V, seqslen=L, num_units=16, num_heads=2, num_events=E,
          batch_size=B)


@pytest.fixture(scope="module")
def world():
    """Data, a mark table, and JAX-initialised weights (with a non-zero
    output bias, so the bias path is exercised)."""
    ds = synthetic_split(num_rows=2 * B, num_items=V, seqslen=L, seed=1)
    table = synthetic_mark_table(V, E, seed=0)
    loader = JBatchLoader(ds, data_mode="mau", batch_size=B, is_training=False,
                          mark_table=table, needs_marks=True, use_native=False)
    features, labels, valid = next(loader.epoch(0))
    jm = jbuild(jpreset("EasyDGL").replace(**KW))
    params = jm.init({"params": jax.random.key(0)},
                     {k: jnp.asarray(v) for k, v in features.items()},
                     is_training=False)
    params = jax.tree.map(np.asarray, params)
    params["params"]["out_bias"]["output_bias"] = np.random.default_rng(
        5).normal(0, 0.5, V).astype(np.float32)
    return dict(ds=ds, table=table, features=features, labels=labels,
                valid=valid, params=params)


def _torch_feats(features):
    return {k: torch.as_tensor(v) for k, v in features.items()}


def _training_logits(model, features, **kw):
    """The training forward returns no logits (the loss streams the
    catalog); they are scored here from its ``aux[SCORING]``."""
    none, aux = model(_torch_feats(features), is_training=True, **kw)
    assert none is None
    return tied_logits(*aux[SCORING], model.compute_dtype)


@pytest.mark.parametrize("gather_queries", [False, True])
def test_eval_logits_match_jax(world, gather_queries):
    cfg_kw = dict(KW, gather_queries=gather_queries)
    jm = jbuild(jpreset("EasyDGL").replace(**cfg_kw))
    want, _ = jm.apply(world["params"], {k: jnp.asarray(v) for k, v in
                                         world["features"].items()},
                       is_training=False)
    model = build_model(preset("EasyDGL", **cfg_kw), device="cpu",
                        params=world["params"])
    with torch.no_grad():
        got, aux = model(_torch_feats(world["features"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert aux["intensities"][0].shape[2] == (1 if gather_queries else L + 1)


@pytest.mark.parametrize("gather_queries", [False, True])
def test_training_forward_at_dropout_zero_matches_jax(world, gather_queries):
    cfg_kw = dict(KW, gather_queries=gather_queries, hidden_dropout_rate=0.0,
                  attention_probs_dropout_rate=0.0)
    loader = JBatchLoader(world["ds"], data_mode="mau", batch_size=B,
                          masklen=3, is_training=True,
                          mark_table=world["table"], needs_marks=True,
                          use_native=False)
    features, _, _ = next(loader.epoch(0))
    features = {k: v for k, v in features.items() if k != "next_marks"}
    jm = jbuild(jpreset("EasyDGL").replace(**cfg_kw))
    want, _ = jm.apply(world["params"],
                       {k: jnp.asarray(v) for k, v in features.items()},
                       is_training=True)
    model = build_model(preset("EasyDGL", **cfg_kw), device="cpu",
                        params=world["params"])
    with torch.no_grad():
        got = _training_logits(model, features)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # with the preset's dropout: a generator is required, and its draws
    # move the logits
    drop = build_model(preset("EasyDGL", **KW), device="cpu",
                       params=world["params"])
    with pytest.raises(ValueError, match="Generator"):
        drop(_torch_feats(features), is_training=True)
    with torch.no_grad():
        dropped = _training_logits(drop, features,
                                   generator=torch.Generator().manual_seed(0))
    assert dropped.shape == got.shape and not torch.equal(dropped, got)


def test_metric_functions_on_the_same_logits():
    rng = np.random.default_rng(4)
    # quantised logits: many exact ties; rows 0-1 tie the label itself
    logits = np.round(rng.normal(size=(6, 120)) * 4) / 4
    logits = logits.astype(np.float32)
    labels = rng.integers(1, 120, 6)
    logits[0, :] = logits[0, labels[0]]
    logits[1, ::2] = logits[1, labels[1]]
    seen = rng.integers(0, 120, (6, 9))
    seen[:, 3] = seen[:, 4] = labels  # duplicate seen ids add twice
    seen[2, :] = 0
    valid = np.array([True, True, True, True, False, True])

    want_m = np.asarray(jmetrics.mask_seen_logits(jnp.asarray(logits),
                                                  jnp.asarray(seen)))
    got_m = metrics.mask_seen_logits(torch.tensor(logits), torch.tensor(seen))
    np.testing.assert_array_equal(got_m.numpy(), want_m)
    for lg in (logits, want_m):
        np.testing.assert_array_equal(
            metrics.label_rank(torch.tensor(lg), torch.tensor(labels)).numpy(),
            np.asarray(jmetrics.label_rank(jnp.asarray(lg),
                                           jnp.asarray(labels))))
        want = jmetrics.metric_sums(jnp.asarray(lg), jnp.asarray(labels),
                                    jnp.asarray(valid))
        got = metrics.metric_sums(torch.tensor(lg), torch.tensor(labels),
                                  torch.tensor(valid))
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=1e-6)


def test_eval_step_sums_match_jax_and_both_mark_paths_agree(world):
    cfg = preset("EasyDGL", **KW)
    jm = jbuild(jpreset("EasyDGL").replace(**KW))
    jstep = jbuild_eval_step(jm, mark_table=world["table"])
    model = build_model(cfg, device="cpu", params=world["params"])
    step = build_eval_step(model, mark_table=world["table"])
    jl = JBatchLoader(world["ds"], data_mode="mau", batch_size=3,
                      is_training=False, use_native=False)
    tl = BatchLoader(world["ds"], data_mode="mau", batch_size=3,
                     is_training=False, mark_table=world["table"],
                     needs_marks=True)
    jacc, tacc, tacc_host = (jmetrics.MetricAccumulator(),
                             metrics.MetricAccumulator(),
                             metrics.MetricAccumulator())
    for (jf, jlab, jv), (tf, tlab, tv) in zip(jl.epoch(0), tl.epoch(0)):
        jacc.update(jstep(world["params"],
                          {k: jnp.asarray(v) for k, v in jf.items()},
                          jnp.asarray(jlab), jnp.asarray(jv)))
        # marks looked up on the device (from the step's table) ...
        no_marks = {k: v for k, v in tf.items() if k != "seqs_marks"}
        tacc.update(step(model, no_marks, tlab, tv))
        # ... and marks from the loader, through a flax param tree
        tacc_host.update(step(world["params"], tf, tlab, tv))
    assert jacc.count == tacc.count == 2 * B
    want = jacc.result()
    for acc in (tacc, tacc_host):
        got = acc.result()
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6)


def test_recommend_matches_jax(world):
    cfg = preset("EasyDGL", **KW)
    arrays = {k: v[:B] for k, v in world["ds"].arrays.items()}
    jrec = JRecommender(jpreset("EasyDGL").replace(**KW), world["params"],
                        world["table"])
    want_ids, _ = jrec.recommend(arrays, k=7)
    # XLA's fused CPU program moves these scores by up to ~1e-3 against
    # its own op-by-op run (the same model, the same weights); the port is
    # held to the op-by-op run
    with jax.disable_jit():
        eager_ids, want_scores = jrec.recommend(arrays, k=7)
    np.testing.assert_array_equal(eager_ids, want_ids)
    rec = Recommender(cfg, world["params"], world["table"], device="cpu")
    ids, scores = rec.recommend(arrays, k=7)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(scores, want_scores, **TOL)
    assert (ids != 0).all() and (scores[:, :-1] >= scores[:, 1:]).all()
    seen = rec.protocol(arrays, False, None)[0]["seqs_i"]
    for r in range(B):
        assert not set(ids[r]) & set(seen[r].tolist())


def test_bridge_round_trip_and_random_tree(world):
    cfg = preset("EasyDGL", **KW)
    sd = flax_to_torch(world["params"])
    back = torch_to_flax(sd)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(world["params"]))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(world["params"])):
        np.testing.assert_array_equal(a, b)
    model = build_model(cfg, device="cpu", params=back)
    for name, tensor in model.state_dict().items():
        assert torch.equal(tensor, sd[name])
    rand = random_flax_params(cfg, 0)
    assert (jax.tree_util.tree_structure(rand)
            == jax.tree_util.tree_structure(world["params"]))
    for a, b in zip(jax.tree.leaves(rand), jax.tree.leaves(world["params"])):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_other_models_raise_not_implemented():
    """Every model of the JAX zoo is ported; a name outside the registry
    raises the JAX factory's error."""
    from easydgl_tpu.models.registry import MODELS as JMODELS
    assert set(MODELS) == set(JMODELS)
    with pytest.raises(NotImplementedError, match="NoSuchModel"):
        build_model(preset("EasyDGL").replace(model="NoSuchModel"),
                    device="cpu")


LC_KW = dict(num_items=60, seqslen=255, masklen=16, num_units=16, num_heads=2,
             num_events=E, batch_size=B, mau_block_k=64,
             compute_dtype="float32")


@pytest.fixture(scope="module")
def lc_world():
    """A small EasyDGL-LC world: random weights with non-zero biases and
    scalings, and one eval batch with marks."""
    ds = synthetic_split(num_rows=2 * B, num_items=60, seqslen=255, seed=3)
    table = synthetic_mark_table(60, E, seed=2)
    params = random_flax_params(preset("EasyDGL-LC", **LC_KW), 1)
    rng = np.random.default_rng(6)
    p = params["params"]
    p["out_bias"]["output_bias"] = rng.normal(0, 0.5, 60).astype(np.float32)
    blk = p["block0_bimau"]
    blk["intensity_dense_bias"] = rng.normal(
        0, 0.1, blk["intensity_dense_bias"].shape).astype(np.float32)
    blk["intensity_scaling"] = rng.normal(0, 0.3, E).astype(np.float32)
    blk["qkvt"]["bias"] = rng.normal(0, 0.1, 64).astype(np.float32)
    loader = JBatchLoader(ds, data_mode="mau", batch_size=B,
                          is_training=False, mark_table=table,
                          needs_marks=True, use_native=False)
    features, labels, valid = next(loader.epoch(0))
    return dict(ds=ds, table=table, params=params, features=features)


def test_lc_eval_logits_match_jax_blocked_engine(lc_world):
    jcfg = jpreset("EasyDGL-LC").replace(**LC_KW)
    from easydgl_tpu.models.base import mau_impl as jmau_impl
    assert jmau_impl(jcfg) == "blocked"
    jm = jbuild(jcfg)
    with jax.disable_jit():
        want, _ = jm.apply(lc_world["params"],
                           {k: jnp.asarray(v) for k, v in
                            lc_world["features"].items()}, is_training=False)
    cfg = preset("EasyDGL-LC", **LC_KW)
    assert mau_impl(cfg) == "streamed"
    model = build_model(cfg, device="cpu", params=lc_world["params"])
    with torch.no_grad():
        got, aux = model(_torch_feats(lc_world["features"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert aux["intensities"][0].shape == (B, 2, 256, E)


def test_long_context_engine_is_the_function_the_model_calls(lc_world):
    """``EasyDGL.long_context_engine`` names the streamed MAU call of its
    BiMAU blocks: a stand-in put there sees the block's call, and the plain
    version it names (``mau_blocked``) gives the model's logits."""
    cfg = preset("EasyDGL-LC", **LC_KW)
    model = build_model(cfg, device="cpu", params=lc_world["params"])
    module, name, plain = type(model).long_context_engine
    saved, calls = getattr(module, name), []

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return plain(*args, **kw)

    feats = _torch_feats(lc_world["features"])
    with torch.no_grad():
        want, _ = model(feats)
        setattr(module, name, spy)
        try:
            got, _ = model(feats)
        finally:
            setattr(module, name, saved)
    assert len(calls) == cfg.num_blocks
    assert torch.equal(got, want)


def test_lc_eval_step_and_recommend_match_jax(lc_world):
    jcfg = jpreset("EasyDGL-LC").replace(**LC_KW)
    cfg = preset("EasyDGL-LC", **LC_KW)
    model = build_model(cfg, device="cpu", params=lc_world["params"])
    jl = JBatchLoader(lc_world["ds"], data_mode="mau", batch_size=B,
                      is_training=False, use_native=False)
    tl = BatchLoader(lc_world["ds"], data_mode="mau", batch_size=B,
                     is_training=False)
    jstep = jbuild_eval_step(jbuild(jcfg), mark_table=lc_world["table"])
    step = build_eval_step(model, mark_table=lc_world["table"])
    jacc, tacc = jmetrics.MetricAccumulator(), metrics.MetricAccumulator()
    with jax.disable_jit():
        for (jf, jlab, jv), (tf, tlab, tv) in zip(jl.epoch(0), tl.epoch(0)):
            jacc.update(jstep(lc_world["params"],
                              {k: jnp.asarray(v) for k, v in jf.items()},
                              jnp.asarray(jlab), jnp.asarray(jv)))
            tacc.update(step(model, tf, tlab, tv))
    assert jacc.count == tacc.count == 2 * B
    want, got = jacc.result(), tacc.result()
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)

    arrays = {k: v[:B] for k, v in lc_world["ds"].arrays.items()}
    jrec = JRecommender(jcfg, lc_world["params"], lc_world["table"])
    with jax.disable_jit():
        want_ids, want_scores = jrec.recommend(arrays, k=7)
    rec = Recommender(cfg, model, lc_world["table"])
    ids, scores = rec.recommend(arrays, k=7)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(scores, want_scores, **TOL)


def test_lc_engine_choice_on_the_cpu(lc_world, monkeypatch):
    """On the CPU, attention_impl="flash" runs the blocked plain version and
    the default the fused plain version; the two give the same logits."""
    from easydgl_tpu_torch.kernels import mau_streamed as streamed_mod
    from easydgl_tpu_torch.nn import temporal as temporal_mod
    calls = []

    def spy(name, fn):
        def wrapped(*args, **kw):
            calls.append(name)
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(streamed_mod, "mau_blocked",
                        spy("blocked", streamed_mod.mau_blocked))
    monkeypatch.setattr(temporal_mod, "mau_attention",
                        spy("fused", temporal_mod.mau_attention))
    logits = {}
    for impl, engine in (("flash", "blocked"), ("xla", "fused")):
        calls.clear()
        cfg = preset("EasyDGL-LC", **dict(LC_KW, attention_impl=impl))
        model = build_model(cfg, device="cpu", params=lc_world["params"])
        with torch.no_grad():
            logits[impl] = model(_torch_feats(lc_world["features"]))[0]
        assert calls == [engine]
    np.testing.assert_allclose(logits["flash"].numpy(),
                               logits["xla"].numpy(), **TOL)
