"""PyTorch port: TiSASREC (serving and the train step), its interval coding
and its time-interval attention vs the JAX package, on the CPU.

* ``TimeIntervalCoding``: ``code`` (the edge bucket ``timelen`` and
  anything outside [0, timelen) give a zero row) and ``table_extended``
  (a zero last row) against the JAX module;
* ``TiMultiHeadAttention`` in both forms (dense interval codes; factored
  buckets and extended tables) against the JAX module, causal, on
  left-padded keys and buckets that hit the edge bucket: the output to
  1e-5 and ``jax.vjp`` of it (every weight, the queries, keys, position
  codes and interval codes or tables) to 1e-6 + 1e-4 of each leaf's scale
  (the floor holds the key bias, whose gradient is 0 in exact arithmetic);
  and the port's factored form against its dense form, output and
  gradients;
* ``interval_buckets`` on a batch whose spans fall on whole days and
  exceed ``timelen``: equal to the JAX model's buckets, where subtracting
  first, in fp32 or fp64, moves some spans across a day; the model's
  logits on it against the JAX model run op by op (its jitted CPU program
  takes another order: XLA turns the division by ``time_scale`` into a
  product with its fp32 reciprocal, which moves some of these spans too);
* TiSASREC (C = 16, H = 2, 2 blocks, L = 8, timelen 8, the preset's
  time_scale of a day) in both forms through ``torch_model_checks``: eval
  logits to 1e-4, eval-step sums and ``recommend``, one train step (loss,
  every gradient, the TF-Adam update), the random param tree; each form
  at full width (C = 512, timelen 256) on the CPU.

Dropout is 0 where the two sides are compared; weights come from JAX
``init`` with non-zero biases and output bias.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easydgl_tpu.nn.coding import TimeIntervalCoding as JTimeIntervalCoding
from easydgl_tpu.nn.temporal import TiMultiHeadAttention as JTiMHA
from easydgl_tpu_torch.config import preset
from easydgl_tpu_torch.data.loader import BatchLoader
from easydgl_tpu_torch.data.synthetic import (day_boundary_stamps,
                                              synthetic_split)
from easydgl_tpu_torch.models.registry import build_model
from easydgl_tpu_torch.models.tisasrec import (interval_buckets,
                                               interval_buckets_numpy)
from easydgl_tpu_torch.nn.coding import TimeIntervalCoding
from easydgl_tpu_torch.nn.temporal import TiMultiHeadAttention
from easydgl_tpu_torch.parity import flax_to_torch
from torch_model_checks import (TOL, check_eval_logits,
                                check_eval_step_and_recommend,
                                check_random_tree, check_step, jfeats,
                                make_world, port, tfeats)

torch.set_num_threads(2)
V, L, B, S = 50, 8, 4, 8            # S: timelen
DAY = 86400.0
SMALL = dict(num_items=V, seqslen=L, num_units=16, num_heads=2, num_blocks=2,
             batch_size=B, timelen=S, hidden_dropout_rate=0.0,
             attention_probs_dropout_rate=0.0, l2_reg=1e-4)
IMPLS = ("xla", "factored")
C, H, T = 16, 2, 7


def _coding_params(seed):
    tc = JTimeIntervalCoding(S, C)
    params = tc.init(jax.random.key(seed), jnp.zeros((1, 1), jnp.int32),
                     method=tc.code)
    return tc, jax.tree.map(np.asarray, params)


def test_time_interval_coding_matches_jax():
    tc, params = _coding_params(0)
    ids = np.array([[0, 3, S - 1, S, S + 2, -1]], np.int32)
    want = np.asarray(tc.apply(params, jnp.asarray(ids), method=tc.code))
    want_ext = np.asarray(tc.apply(params, method=tc.table_extended))
    mine = TimeIntervalCoding(S, C)
    mine.load_state_dict(flax_to_torch(params))
    with torch.no_grad():
        got = mine.code(torch.tensor(ids)).numpy()
        ext = mine.table_extended().numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ext, want_ext)
    table = params["params"]["pembs"]["lookup_table"]
    np.testing.assert_array_equal(got[0, :3], table[[0, 3, S - 1]])
    assert not got[0, 3:].any()          # timelen, beyond, negative: zero
    assert ext.shape == (S + 1, C) and not ext[S].any()


def _attention_inputs(seed):
    """Queries ~ N(0, 1); keys left-padded with zero rows (batch row 0 with
    none real, row 1 with 3 real); position codes; buckets in [0, S] with
    about one in four on the edge bucket S."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    queries = rng.normal(size=(3, T, C)).astype(f32)
    keys = rng.normal(size=(3, T, C)).astype(f32)
    keys[0] = 0.0
    keys[1, :T - 3] = 0.0
    k_pos, v_pos = (rng.normal(size=(3, T, C)).astype(f32)
                    for _ in range(2))
    buckets = rng.integers(0, S + 1, (3, T, T)).astype(np.int32)
    buckets[rng.random((3, T, T)) < 0.25] = S
    return rng, queries, keys, k_pos, v_pos, buckets


def _attention_setup(seed):
    """JAX module, its params (non-zero biases) and both interval codings'
    params; the inputs."""
    rng, q, k, kp, vp, bk = _attention_inputs(seed)
    jm = JTiMHA(C, H, 0.0)
    tck, pk = _coding_params(1)
    _, pv = _coding_params(2)
    code = lambda p: tck.apply(p, jnp.asarray(bk), method=tck.code)  # noqa
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.key(3), q, k, kp, vp, code(pk), code(pv),
        deterministic=True, causality=True))
    for proj in ("q", "k", "v"):
        params["params"][proj]["bias"] = rng.normal(
            0, 0.1, C).astype(np.float32)
    return dict(jm=jm, tc=tck, params=params, pk=pk, pv=pv,
                x=(q, k, kp, vp), buckets=bk)


def _jax_attention(setup, form):
    """Output and the VJP of the JAX module under cotangent ``go``, w.r.t.
    the weights, queries, keys, position codes, and the interval codes
    (dense) or the extended tables (factored)."""
    jm, tc, bk = setup["jm"], setup["tc"], jnp.asarray(setup["buckets"])
    x = tuple(jnp.asarray(a) for a in setup["x"])
    if form == "dense":
        ints = tuple(tc.apply(p, bk, method=tc.code)
                     for p in (setup["pk"], setup["pv"]))

        def fn(p, q, k, kp, vp, ki, vi):
            return jm.apply(p, q, k, kp, vp, ki, vi, deterministic=True,
                            causality=True)
    else:
        ints = tuple(tc.apply(p, method=tc.table_extended)
                     for p in (setup["pk"], setup["pv"]))

        def fn(p, q, k, kp, vp, tk, tv):
            return jm.apply(p, q, k, kp, vp, None, None, deterministic=True,
                            causality=True, interval_buckets=bk,
                            interval_tables=(tk, tv))
    out, vjp = jax.vjp(fn, setup["params"], *x, *ints)
    go = np.random.default_rng(9).normal(size=out.shape).astype(np.float32)
    return np.asarray(out), go, vjp(jnp.asarray(go)), ints


def _port_attention(setup, form, go, ints=None):
    """The port's output and gradients, in ``_jax_attention``'s order; the
    interval inputs are ``ints`` (numpy) or, without them, made by the
    port's codings from the JAX coding params (dense: ``code`` of the
    buckets; factored: ``table_extended``), differentiated w.r.t. the
    coding tables."""
    mine = TiMultiHeadAttention(C, H)
    mine.load_state_dict(flax_to_torch(setup["params"]))
    x = [torch.tensor(a, requires_grad=True) for a in setup["x"]]
    bk = torch.tensor(setup["buckets"])
    codings = []
    if ints is not None:
        leaves = [torch.tensor(np.asarray(a), requires_grad=True)
                  for a in ints]
        vals = leaves
    else:
        for p in (setup["pk"], setup["pv"]):
            tc = TimeIntervalCoding(S, C)
            tc.load_state_dict(flax_to_torch(p))
            codings.append(tc)
        leaves = [tc.pembs.lookup_table for tc in codings]
        vals = [tc.code(bk) if form == "dense" else tc.table_extended()
                for tc in codings]
    if form == "dense":
        out = mine(*x, *vals, causality=True)
    else:
        out = mine(*x, None, None, causality=True, interval_buckets=bk,
                   interval_tables=tuple(vals))
    names, weights = zip(*mine.named_parameters())
    grads = torch.autograd.grad((out * torch.tensor(go)).sum(),
                                weights + tuple(x) + tuple(leaves))
    return out.detach().numpy(), dict(zip(names, grads[:len(names)])), \
        grads[len(names):]


@pytest.mark.parametrize("form", ["dense", "factored"])
def test_ti_attention_matches_jax(form):
    setup = _attention_setup(4)
    want, go, (gp, *gx), ints = _jax_attention(setup, form)
    got, gw, gx_mine = _port_attention(setup, form, go, ints)
    assert got.shape == (3, T, C)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    want_w = flax_to_torch(jax.tree.map(np.asarray, gp))
    assert set(want_w) == set(gw)
    pairs = [(gw[n], want_w[n], n) for n in want_w] + [
        (a, torch.tensor(np.asarray(b)), f"input {i}")
        for i, (a, b) in enumerate(zip(gx_mine, gx))]
    for got_g, want_g, name in pairs:
        np.testing.assert_allclose(
            got_g.numpy(), want_g.numpy(), rtol=0, err_msg=name,
            atol=1e-6 + 1e-4 * float(want_g.abs().max()))


def test_ti_attention_masks_padded_queries_and_keys():
    """The post-softmax query mask ``sign(sum |queries|)``: an all-zero
    query row attends to nothing and returns its (zero) residual. The key
    mask ``sign(sum |keys|)``: a key row whose channels cancel in the sum
    is still a real key (MultiHeadAttention's ``sign(|sum keys|)`` would
    drop it)."""
    setup = _attention_setup(5)
    q, k, kp, vp = setup["x"]
    q = q.copy()
    q[2, 3] = 0.0
    k = k.copy()
    k[2, 1] = np.concatenate([np.ones(C // 2), -np.ones(C // 2)])
    mine = TiMultiHeadAttention(C, H)
    mine.load_state_dict(flax_to_torch(setup["params"]))
    tc = setup["tc"]
    bk = jnp.asarray(setup["buckets"])
    ints = [tc.apply(p, bk, method=tc.code) for p in (setup["pk"],
                                                     setup["pv"])]
    want = setup["jm"].apply(setup["params"], q, k, kp, vp, *ints,
                             deterministic=True, causality=True)
    with torch.no_grad():
        got = mine(*(torch.tensor(a) for a in (q, k, kp, vp)),
                   *(torch.tensor(np.asarray(a)) for a in ints),
                   causality=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert not got[2, 3].any()
    k_dropped = k.copy()
    k_dropped[2, 1] = 0.0
    with torch.no_grad():
        dropped = mine(*(torch.tensor(a) for a in (q, k_dropped, kp, vp)),
                       *(torch.tensor(np.asarray(a)) for a in ints),
                       causality=True)
    assert not torch.allclose(dropped[2, 1:], got[2, 1:])


def test_factored_equals_dense_in_the_port():
    """The same interval tables through ``code`` (dense) and
    ``table_extended`` (factored): outputs to 1e-5, and the gradients of
    every weight, input and interval table to 1e-6 + 1e-5 of each one's
    scale."""
    setup = _attention_setup(6)
    go = np.random.default_rng(1).normal(size=(3, T, C)).astype(np.float32)
    dense, gw_d, gx_d = _port_attention(setup, "dense", go)
    fact, gw_f, gx_f = _port_attention(setup, "factored", go)
    np.testing.assert_allclose(fact, dense, atol=1e-5, rtol=1e-5)
    pairs = [(gw_f[n], gw_d[n], n) for n in gw_d] + [
        (a, b, f"input {i}") for i, (a, b) in enumerate(zip(gx_f, gx_d))]
    assert len(pairs) == 6 + 6
    for got_g, want_g, name in pairs:
        np.testing.assert_allclose(
            got_g.numpy(), want_g.numpy(), rtol=0, err_msg=name,
            atol=1e-6 + 1e-5 * float(want_g.abs().max()))
    assert float(gx_f[-1].abs().max()) > 0    # the tables are reached


def _boundary_stamps(seed=0):
    """``day_boundary_stamps`` (B, L+1) up to 12 days > timelen apart, and
    ids with row 0 left-padded as its stamps are."""
    rng = np.random.default_rng(seed)
    stamps = day_boundary_stamps(rng, B, L + 1, max_days=12, day=DAY)
    ids = rng.integers(1, V, (B, L + 1)).astype(np.int32)
    ids[0, :3] = 0
    return ids, stamps


def test_interval_buckets_on_day_boundaries_match_jax():
    _, stamps = _boundary_stamps()

    def jax_buckets(seqs_t):            # easydgl_tpu/models/tisasrec.py
        ts = seqs_t / DAY
        spans = ts[:, 1:, None] - ts[:, None, :-1]
        return jnp.clip(spans, 0.0, float(S)).astype(jnp.int32)

    with jax.disable_jit():
        want = np.asarray(jax_buckets(jnp.asarray(stamps)))
    got = interval_buckets(torch.tensor(stamps), DAY, S)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the fp32 numpy buckets the card tests hold the port's to
    np.testing.assert_array_equal(
        interval_buckets_numpy(stamps, DAY, S), want)
    s64 = stamps.astype(np.float64)
    for diffs in ((s64[:, 1:, None] - s64[:, None, :-1]) / DAY,
                  (stamps[:, 1:, None] - stamps[:, None, :-1])
                  / np.float32(DAY)):
        assert (np.clip(diffs, 0, S).astype(np.int32) != want).sum() >= 10
    assert (want == S).sum() >= 10 and ((want > 0) & (want < S)).any()


@pytest.mark.parametrize("impl", IMPLS)
def test_model_on_day_boundaries_matches_jax(world_xla, impl):
    """Both forms on the boundary batch against the JAX model (the dense
    form, whose logits the factored form's equal) run op by op."""
    ids, stamps = _boundary_stamps()
    feats = {"seqs_i": ids[:, :-1], "seqs_t": stamps}
    with jax.disable_jit():
        want, _ = world_xla["jm"].apply(world_xla["params"], jfeats(feats),
                                        is_training=False)
    with torch.no_grad():
        got, _ = port(world_xla, attention_impl=impl)(tfeats(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def world_xla():
    return make_world("TiSASREC", dict(SMALL, attention_impl="xla"), 7)


@pytest.fixture(scope="module")
def world_factored():
    return make_world("TiSASREC", dict(SMALL, attention_impl="factored"), 7)


@pytest.fixture(params=IMPLS)
def world(request):
    return request.getfixturevalue(f"world_{request.param}")


def test_eval_logits_match_jax(world):
    check_eval_logits(world)


def test_eval_step_and_recommend_match_jax(world):
    check_eval_step_and_recommend(world)


def test_train_step_matches_jax(world):
    check_step(world, port(world))


def test_random_tree_matches_jax_init(world):
    check_random_tree(world)


def test_training_forward_needs_a_generator_for_dropout(world):
    model = port(world, hidden_dropout_rate=0.1,
                 attention_probs_dropout_rate=0.1)
    feats = tfeats(world["train"][0])
    with pytest.raises(ValueError, match="Generator"):
        model(feats, is_training=True)
    none, aux = model(feats, is_training=True,
                      generator=torch.Generator().manual_seed(0))
    assert none is None
    hidden = aux["scoring"][0]
    assert hidden.shape == (B * L, 16) and bool(torch.isfinite(hidden).all())


@pytest.mark.parametrize("impl", IMPLS)
def test_preset_builds_on_the_cpu(impl):
    """Full width (C = 512, H = 8, timelen 256), random weights from the
    seed; an eval forward on two short rows."""
    cfg = preset("TiSASREC", num_items=300, seqslen=12, attention_impl=impl)
    model = build_model(cfg, device="cpu")
    assert model.tcoding_k.pembs.lookup_table.shape == (256, 512)
    ds = synthetic_split(num_rows=2, num_items=300, seqslen=12, seed=1)
    f, _, _ = next(BatchLoader(ds, data_mode=model.data_mode, batch_size=2,
                               is_training=False).epoch(0))
    with torch.no_grad():
        logits, _ = model(tfeats(f))
    assert logits.shape == (2, 300) and bool(torch.isfinite(logits).all())
