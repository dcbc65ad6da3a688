"""PyTorch port: the distributed layer over gloo against the JAX package's
SPMD layer, on the CPU.

Each port side runs on a world of CPU ranks spawned by
``torch_dist_workers.run_world`` (one process a rank, a gloo process group,
the port's (data, model) ``DeviceMesh``); each JAX side runs in this
process on the conftest's virtual CPU devices, a (2, 2) mesh of four of
them, as ``tests/test_sharding.py`` runs it. A rank holds its data
coordinate's block of the batch's rows and its model coordinate's slice of
the catalog or of the heads.

* ``distributed_top_k`` (ids exact, also with the -1e30 ties of
  ``distributed_mask_seen``), ``distributed_label_nll`` and
  ``sharded_tied_logits`` against their JAX counterparts;
* ``catalog_nll_spmd`` (vocab-sharded, labels outside a slice at -1) and
  ``mau_attention_spmd`` (H = 4, heads over model) against JAX's with its
  Pallas kernels in interpret mode: values and gradients to 1e-5 of scale;
  ``flash_attention_spmd`` against the unsharded port; the plain catalog
  version's label -1 against JAX ``catalog_nll``;
* one train step on a (2, 2) world against JAX ``build_sharded_train_step``
  on a (2, 2) mesh and JAX's single-device step: EasyDGL at
  ``test_sharding.py:80-84``'s config (the row-sharded table, the
  head-sharded MAU), a small SASREC with ``attention_impl="flash"`` (V odd:
  the replicated-table route; its JAX reference the ``"xla"`` model, one
  function with it at dropout 0) and GRU4REC with its clip under the
  gradient's norm (the clip's global norm over the table's slices). Loss
  to 1e-5 relative, parameters at rtol 2e-4 / atol 2e-5
  (``test_sharding.py:113-119``'s bound);
* three EasyDGL steps with a term of each rank's own in its gradients
  before the reduction: the replicated parameters stay bit-identical on
  every rank; more than one process without --process_id or
  --coordinator_address raises;
* the loaders' data shards, the mesh shape rules (a seq axis resolved
  as JAX's ``make_mesh`` resolves it, the pipeline axis refused), and the
  gathered checkpoint state against the single-device layout.

Dropout is 0 where the two sides are compared (their PRNG streams differ
by design).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from easydgl_tpu.config import MeshConfig as JMeshConfig
from easydgl_tpu.config import preset as jpreset
from easydgl_tpu.core.mesh import make_mesh as jmake_mesh
from easydgl_tpu.data.loader import BatchLoader as JBatchLoader
from easydgl_tpu.data.synthetic import synthetic_mark_table, synthetic_split
from easydgl_tpu.dist.embedding import sharded_tied_logits as j_tied
from easydgl_tpu.dist.topk import (distributed_label_nll as j_nll,
                                   distributed_mask_seen as j_mask,
                                   distributed_top_k as j_topk)
from easydgl_tpu.kernels.scoring import catalog_nll as j_catalog_nll
from easydgl_tpu.kernels.spmd import catalog_nll_spmd as j_catalog_spmd
from easydgl_tpu.kernels.spmd import mau_attention_spmd as j_mau_spmd
from easydgl_tpu.models.registry import build_model as jbuild
from easydgl_tpu.train import optim as joptim
from easydgl_tpu.train import sharded as jsharded
from easydgl_tpu.train import steps as jsteps
from easydgl_tpu_torch.config import MeshConfig, preset
from easydgl_tpu_torch.core.mesh import resolve_shape
from easydgl_tpu_torch.core.runtime import init_distributed
from easydgl_tpu_torch.kernels.flash_attention import flash_attention
from easydgl_tpu_torch.kernels.scoring import (catalog_nll_bwd_reference,
                                               catalog_nll_reference)
from easydgl_tpu_torch.models.registry import model_class
from easydgl_tpu_torch.parity import flax_to_torch, random_flax_params
from easydgl_tpu_torch.train.sharded import is_table_path
from torch_dist_workers import run_world

torch.set_num_threads(2)
SCALE_TOL = 1e-5


def jmesh(dp=2, mp=2):
    return jmake_mesh(JMeshConfig(dp=dp, mp=mp),
                      devices=jax.devices()[:dp * mp])


def close_to_scale(got, want, what, tol=SCALE_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1.0), (what, err)


def by_data(results, key, dp=2, mp=2):
    """The data shards' results concatenated (model coordinate 0)."""
    return np.concatenate([np.asarray(results[d * mp][key])
                           for d in range(dp)])


def same_over_model(results, key, dp=2, mp=2):
    for d in range(dp):
        for m in range(1, mp):
            np.testing.assert_array_equal(
                np.asarray(results[d * mp][key]),
                np.asarray(results[d * mp + m][key]), err_msg=key)


# ---------------------------------------------------------------- top-k


def topk_payload():
    rng = np.random.default_rng(3)
    n, v, c = 8, 64, 8
    p = dict(logits=(rng.normal(size=(n, v)) * 3).astype(np.float32), k=7,
             k_all=v, seen=rng.integers(0, v, (n, 5)).astype(np.int64),
             labels=rng.integers(0, v, n).astype(np.int64),
             hidden=rng.normal(size=(n, c)).astype(np.float32),
             table=rng.normal(size=(v, c)).astype(np.float32),
             bias=rng.normal(size=v).astype(np.float32))
    p["seen"][:, 1] = p["seen"][:, 0]        # a duplicate adds again
    return p


def catalog_payload():
    rng = np.random.default_rng(5)
    n, c, v = 16, 8, 48
    return dict(hidden=rng.normal(size=(n, c)).astype(np.float32),
                table=rng.normal(size=(v, c)).astype(np.float32),
                bias=rng.normal(size=v).astype(np.float32),
                labels=rng.integers(0, v, n).astype(np.int64),
                weights=np.arange(1.0, n + 1, dtype=np.float32))


def mau_payload():
    rng = np.random.default_rng(6)
    b, h, t, dh, e = 2, 4, 7, 8, 5
    c = h * dh
    mk = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    km = (rng.random((b, t)) > 0.3).astype(np.float32)
    km[:, -2:] = 1.0
    return dict(q=mk(b, t, c), k=mk(b, t, c), v=mk(b, t, c), t=mk(b, t, c),
                km=km, iv=rng.random((b, t)).astype(np.float32),
                oh=(rng.random((b, t, e)) > 0.5).astype(np.float32),
                wd=mk(dh + 1, e * dh) * 0.1, bd=mk(e * dh) * 0.1,
                w=mk(e, dh) * 0.1, sc=mk(e) * 0.1, causal=False, diag=True,
                h=h)


def flash_payload():
    rng = np.random.default_rng(7)
    b, h, t, d = 4, 4, 9, 8
    mk = lambda: rng.normal(size=(b, h, t, d)).astype(np.float32)  # noqa: E731
    km = np.ones((b, t), np.float32)
    km[1, :4] = 0.0
    return dict(q=mk(), k=mk(), v=mk(), g=mk(), km=km)


def loader_payload():
    ds = synthetic_split(num_rows=40, num_items=30, seqslen=6, seed=8)
    ds.arrays["seqs_i"][:, 0] = np.arange(40) + 1000      # a row's id
    return dict(model="SASREC", cfg=dict(num_items=1100, seqslen=6,
                                         batch_size=8, num_units=8,
                                         num_heads=2, num_blocks=1),
                arrays=ds.arrays)


PIECES = {"topk": ("w_topk", topk_payload), "catalog": ("w_catalog",
                                                       catalog_payload),
          "mau": ("w_mau", mau_payload), "flash": ("w_flash", flash_payload),
          "loader": ("w_loader", loader_payload)}


@pytest.fixture(scope="module")
def pieces(tmp_path_factory):
    """Every piece's payload and every rank's results, from one world of
    four ranks."""
    jobs = {name: (fn, make()) for name, (fn, make) in PIECES.items()}
    res = run_world("w_many", jobs, 2, 2, tmp_path_factory.mktemp("pieces"))
    return {name: (jobs[name][1], [r[name] for r in res]) for name in jobs}


@pytest.fixture
def topk_world(pieces):
    return pieces["topk"]


def test_distributed_top_k_matches_jax(topk_world):
    p, res = topk_world
    vals, ids = j_topk(jnp.asarray(p["logits"]), p["k"], jmesh())
    np.testing.assert_array_equal(by_data(res, "ids"), np.asarray(ids))
    np.testing.assert_allclose(by_data(res, "vals"), np.asarray(vals),
                               rtol=1e-6)
    same_over_model(res, "ids")


def test_distributed_mask_seen_and_tied_top_k_match_jax(topk_world):
    """The masked logits column by column, and the top-k over the whole
    catalog, where the seen ids tie at -1e30 (-2e30 the duplicates): the
    ids in ascending order among equals, as lax.top_k."""
    p, res = topk_world
    masked = np.asarray(j_mask(jnp.asarray(p["logits"]),
                               jnp.asarray(p["seen"]), jmesh()))
    got = np.concatenate([np.concatenate([res[d * 2 + m]["masked"]
                                          for m in range(2)], axis=1)
                          for d in range(2)])
    np.testing.assert_array_equal(got, masked)
    _, ids = j_topk(jnp.asarray(masked), p["k_all"], jmesh())
    np.testing.assert_array_equal(by_data(res, "ids_m"), np.asarray(ids))
    assert (np.asarray(masked) <= -1e30).any(axis=1).all()


def test_distributed_label_nll_matches_jax(topk_world):
    p, res = topk_world
    want = j_nll(jnp.asarray(p["logits"]), jnp.asarray(p["labels"]),
                 jmesh())
    np.testing.assert_allclose(by_data(res, "nll"), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    same_over_model(res, "nll")


def test_sharded_tied_logits_match_jax(topk_world):
    """Each rank's column slice, from its slice of the table and from the
    whole table (an untied head)."""
    p, res = topk_world
    want = np.asarray(j_tied(*(jnp.asarray(p[k]) for k in
                               ("hidden", "table", "bias")), jmesh()))
    for key in ("tied", "tied_whole"):
        got = np.concatenate([np.concatenate([res[d * 2 + m][key]
                                              for m in range(2)], axis=1)
                              for d in range(2)])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=key)


# ---------------------------------------------------------------- kernels


def test_plain_catalog_takes_label_minus_one_as_jax():
    """A label of -1 (outside a rank's vocab slice): label logit 0 and no
    one-hot term, in the plain forward and backward, as JAX ``catalog_nll``
    (Pallas, as ``tests/test_kernels.py`` runs it) matches no column."""
    rng = np.random.default_rng(4)
    n, c, v = 8, 8, 48
    h, t = (rng.normal(size=s).astype(np.float32) for s in ((n, c), (v, c)))
    b = rng.normal(size=v).astype(np.float32)
    lab = rng.integers(0, v, n).astype(np.int32)
    lab[::3] = -1
    assert (lab >= 0).any()
    w = np.arange(1.0, n + 1, dtype=np.float32)

    def jloss(hh, tt, bb):
        lse, ll = j_catalog_nll(hh, tt, bb, jnp.asarray(lab), 8, 16)
        return jnp.sum((lse - 2.0 * ll) * w), (lse, ll)

    with pltpu.force_tpu_interpret_mode():
        (_, (jlse, jll)), jg = jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(h), jnp.asarray(t), jnp.asarray(b))
    th, tt, tb, tl = (torch.tensor(x) for x in (h, t, b, lab))
    lse, ll = catalog_nll_reference(th, tt, tb, tl)
    assert (ll[::3] == 0).all()
    close_to_scale(lse, jlse, "lse")
    close_to_scale(ll, jll, "ll")
    tw = torch.tensor(w)
    grads = catalog_nll_bwd_reference(th, tt, tb, tl, lse, tw, -2.0 * tw)
    for got, want, name in zip(grads, jg, ("dh", "dt", "db")):
        close_to_scale(got, want, name)


@pytest.fixture
def catalog_world(pieces):
    return pieces["catalog"]


def test_catalog_nll_spmd_matches_jax(catalog_world):
    """Vocab slices of 24 rows; JAX's kernel at block_v 16 pads each slice
    to 32 columns, so an out-of-slice label that were not -1 would pick a
    pad column."""
    p, res = catalog_world
    mesh = jmesh()
    lab = jnp.asarray(p["labels"].astype(np.int32))

    def jloss(h, t, b):
        lse, ll = j_catalog_spmd(h, t, b, lab, mesh, 8, 16)
        return jnp.sum((lse - ll) * p["weights"]), (lse, ll)

    with pltpu.force_tpu_interpret_mode():
        (loss, (lse, ll)), (dh, dt, db) = jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True)(
            *(jnp.asarray(p[k]) for k in ("hidden", "table", "bias")))
    close_to_scale(by_data(res, "lse"), lse, "lse")
    close_to_scale(by_data(res, "ll"), ll, "ll")
    close_to_scale(sum(float(res[d * 2]["loss"]) for d in range(2)), loss,
                   "loss")
    close_to_scale(by_data(res, "dh"), dh, "dhidden")
    got_dt = np.concatenate([sum(np.asarray(res[d * 2 + m]["dt"])
                                 for d in range(2)) for m in range(2)])
    close_to_scale(got_dt, dt, "dtable")
    close_to_scale(sum(np.asarray(res[d * 2]["db"]) for d in range(2)), db,
                   "dbias")
    for key in ("lse", "ll", "dh", "db"):
        same_over_model(res, key)


@pytest.fixture
def mau_world(pieces):
    return pieces["mau"]


def test_mau_attention_spmd_matches_jax(mau_world):
    """H = 4 on a (2, 2) mesh: two heads a model rank. out, lam and every
    gradient (the projections' blocks gathered, the intensity weights
    summed over model by the wrapper, over data here)."""
    p, res = mau_world
    mesh = jmesh()
    names = ("q", "k", "v", "t", "wd", "bd", "w", "sc")

    def jloss(a):
        o, lam = j_mau_spmd(a[0], a[1], a[2], a[3], jnp.asarray(p["km"]),
                            jnp.asarray(p["iv"]), jnp.asarray(p["oh"]),
                            a[4], a[5], a[6], a[7], 0, mesh, p["causal"],
                            p["diag"], 0.0, p["h"])
        return jnp.sum(jnp.sin(o)) + jnp.sum(jnp.cos(lam)), (o, lam)

    with pltpu.force_tpu_interpret_mode():
        (_, (o, lam)), g = jax.value_and_grad(jloss, has_aux=True)(
            tuple(jnp.asarray(p[k]) for k in names))
    close_to_scale(by_data(res, "out"), o, "out")
    close_to_scale(by_data(res, "lam"), lam, "lam")
    for i, name in enumerate(names):
        if i < 4:
            got = np.concatenate([np.asarray(res[d * 2]["grads"][i])
                                  for d in range(2)])
        else:
            got = sum(np.asarray(res[d * 2]["grads"][i]) for d in range(2))
        close_to_scale(got, g[i], "d" + name)
    same_over_model(res, "out")


def test_flash_attention_spmd_matches_the_unsharded_port(pieces):
    """Four heads over a (2, 2) world (two a model rank), causal, a
    partly masked key row: the output and dq, dk, dv equal the unsharded
    flash call's (its plain version) to 1e-5 of scale."""
    p, res = pieces["flash"]
    q, k, v = (torch.tensor(p[n]).requires_grad_() for n in "qkv")
    out = flash_attention(q, k, v, torch.tensor(p["km"]), causal=True)
    (out * torch.tensor(p["g"])).sum().backward()
    close_to_scale(by_data(res, "out"), out.detach(), "out")
    for i, x in enumerate((q, k, v)):
        got = np.concatenate([np.asarray(res[d * 2]["grads"][i])
                              for d in range(2)])
        close_to_scale(got, x.grad, "d" + "qkv"[i])


# ---------------------------------------------------------------- steps


def _batch_and_params(name, kw, rows, seed, *, mark=False):
    """A batch from the JAX loader and seeded weights (nonzero output
    bias): the payload of one ``w_train`` job."""
    cfg = preset(name, **kw)
    ds = synthetic_split(num_rows=rows, num_items=cfg.num_items,
                         seqslen=cfg.seqslen, seed=seed)
    table = synthetic_mark_table(cfg.num_items, cfg.num_events or 4,
                                 seed=2) if mark else None
    ld = JBatchLoader(ds, data_mode=model_class(cfg).data_mode,
                      batch_size=cfg.batch_size,
                      masklen=cfg.masklen, is_training=True,
                      mark_table=table, needs_marks=mark, use_native=False)
    features, labels, _ = next(ld.epoch(0))
    params = random_flax_params(cfg, seed=0)
    ob = params["params"]["out_bias"]
    ob["output_bias"] = np.random.default_rng(5).normal(
        0, 0.5, np.shape(ob["output_bias"])).astype(np.float32)
    return dict(model=name, cfg=kw, params=params,
                batches=[(features, labels)])


EASYDGL = dict(num_items=47, seqslen=8, num_units=16, num_heads=2,
               num_blocks=1, num_events=4, masklen=3, batch_size=8,
               hidden_dropout_rate=0.0, attention_probs_dropout_rate=0.0,
               ct_reg=1e-4)
SASREC_FLASH = dict(num_items=49, seqslen=8, num_units=16, num_heads=2,
                    num_blocks=1, batch_size=8, hidden_dropout_rate=0.0,
                    attention_probs_dropout_rate=0.0, l2_reg=1e-4,
                    attention_impl="flash")
GRU4REC = dict(num_items=50, seqslen=8, num_units=16, num_heads=1,
               num_blocks=1, batch_size=8, hidden_dropout_rate=0.0,
               attention_probs_dropout_rate=0.0, l2_reg=1e-4)
# name: (model, config, rows, seed, marks, the JAX model's overrides,
# TF-Adam's clip)
STEPS = {"easydgl": ("EasyDGL", EASYDGL, 16, 5, True, {}, None),
         "sasrec_flash": ("SASREC", SASREC_FLASH, 16, 6, False,
                          dict(attention_impl="xla"), None),
         "gru4rec_clip": ("GRU4REC", GRU4REC, 16, 7, False, {}, 0.01)}


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """Each model's payload and every rank's step results, from one
    world of four ranks."""
    jobs = {}
    for key, (name, kw, rows, seed, mark, _, clip) in STEPS.items():
        p = _batch_and_params(name, kw, rows, seed, mark=mark)
        if clip is not None:
            p["clip"] = clip
        jobs[key] = ("w_train", p)
    p = dict(jobs["easydgl"][1])
    p["batches"] = p["batches"] * 3
    jobs["replicas"] = ("w_replicas", p)
    res = run_world("w_many", jobs, 2, 2, tmp_path_factory.mktemp("steps"))
    return {key: (jobs[key][1], [r[key] for r in res]) for key in jobs}


def _jax_steps(key, payload):
    """(state, loss) of JAX's single-device step and of its
    build_sharded_train_step on a (2, 2) mesh, from the payload's
    weights and batch."""
    name, kw, _, _, _, jax_kw, clip = STEPS[key]
    jcfg = jpreset(name).replace(use_pallas=False, **{**kw, **jax_kw})
    if clip is not None:
        jcfg = jcfg.replace(optim=dataclasses.replace(jcfg.optim,
                                                      clip_norm=clip))
    jm = jbuild(jcfg)
    features, labels = payload["batches"][0]
    params = payload["params"]
    tx = joptim.build_optimizer(jcfg.optim)
    jf = {k: jnp.asarray(v) for k, v in features.items()}
    jl = jnp.asarray(labels)
    state = jsteps.TrainState(params, tx.init(params),
                              jnp.zeros((), jnp.int32))
    single = jsteps.build_train_step(jm, donate=False)(
        state, jf, jl, jax.random.key(7))
    mesh = jmesh()
    sh = jsharded.batch_shardings((jf, jl), mesh)
    sharded = jsharded.build_sharded_train_step(jm, mesh, (jf, jl))(
        jsharded.shard_state(state, mesh),
        jax.tree.map(jax.device_put, jf, sh[0]),
        jax.device_put(jl, sh[1]), jax.random.key(7))
    return dict(single=single, sharded=sharded)


def _check_train(key, steps, table_rows):
    payload, res = steps[key]
    jax_steps = _jax_steps(key, payload)
    r0 = res[0]
    for which, (jstate, jloss) in jax_steps.items():
        np.testing.assert_allclose(r0["losses"][0], float(jloss), rtol=1e-5,
                                   err_msg=which)
        want = flax_to_torch(jax.tree.map(np.asarray, jstate.params))
        assert set(want) == set(r0["params"])
        for name, w in want.items():
            np.testing.assert_allclose(
                r0["params"][name].numpy(), w.numpy(), rtol=2e-4,
                atol=2e-5, err_msg=f"{which} {name}")
    for r in res[1:]:
        assert r["losses"] == r0["losses"]
    shapes = r0["shapes"]
    tables = [n for n in shapes if is_table_path(n)]
    assert tables and all(shapes[n][0] == table_rows for n in tables)


def test_easydgl_sharded_step_matches_jax(steps):
    """The row-sharded table (48 rows, 24 a model rank) and the
    head-sharded MAU (one head a rank) on a (2, 2) world."""
    _check_train("easydgl", steps, table_rows=24)


def test_sharded_state_moments_follow_the_table(steps):
    """gather_state: the whole table and its TF-Adam moments in the
    single-device layout (the checkpoint's), the moment of a row-sharded
    leaf nonzero in every slice; every rank gathers the same state."""
    _, res = steps["easydgl"]
    mu = res[0]["mu"]
    assert tuple(mu["item_embs.lookup_table"].shape) == (48, 16)
    for m in range(2):
        assert mu["item_embs.lookup_table"][m * 24:(m + 1) * 24].abs().sum() > 0
    for r in res[1:]:
        for name, t in r["params"].items():
            torch.testing.assert_close(t, res[0]["params"][name], rtol=0,
                                       atol=0)


def test_replicated_parameters_stay_bit_identical_over_ranks(steps):
    """Three EasyDGL steps on a (2, 2) world in which each rank's
    gradients carry a term of their own before the reduction, as a
    nondeterministic op leaves them on the card: every replicated
    parameter stays equal bit for bit on all four ranks, and each table
    slice on the two ranks of its model coordinate."""
    _, res = steps["replicas"]
    r0 = res[0]["params"]
    assert any(is_table_path(n) for n in r0)
    for r in res[1:]:
        same_slice = r["coords"][2] == res[0]["coords"][2]
        for name, t in r["params"].items():
            if same_slice or not is_table_path(name):
                torch.testing.assert_close(t, r0[name], rtol=0, atol=0,
                                           msg=name)
    slices = [r["params"][n] for r in res for n in r0 if is_table_path(n)]
    assert not torch.equal(slices[0], slices[1])


def test_multi_process_flags_without_their_partners_raise():
    """More than one process needs both --coordinator_address and
    --process_id: without either, every rank would wait for the others."""
    with pytest.raises(ValueError, match="--process_id"):
        init_distributed("127.0.0.1:1", 2, None, "cpu")
    with pytest.raises(ValueError, match="--coordinator_address"):
        init_distributed(None, 2, 0, "cpu")


def test_sasrec_flash_sharded_step_matches_jax(steps):
    """SASREC with the flash core (two heads, one a model rank) and V = 49
    (odd: the table stays whole on every rank, the replicated-table
    route); the JAX reference its ``"xla"`` model."""
    _check_train("sasrec_flash", steps, table_rows=49)


def test_gru4rec_clipped_sharded_step_matches_jax(steps):
    """GRU4REC (V = 50 rows over mp = 2) with its clip at 0.01, under the
    gradient's global norm: the norm sums the table's slices' squares over
    model once and the replicated leaves' once."""
    _check_train("gru4rec_clip", steps, table_rows=25)


# ---------------------------------------------------------------- loaders


def test_loader_shards_disjoint_over_data_equal_within_model(pieces):
    """make_loaders by data coordinate: the two data shards' validation
    rows are disjoint and cover every row; the two model-axis ranks of a
    data group read the same batches; the batch is B / dp."""
    _, res = pieces["loader"]
    seen = []
    for d in range(2):
        a, b = res[d * 2], res[d * 2 + 1]
        assert a["shard"] == (d, 2)
        for x, y in zip(a["train"] + [v[0] for v in a["valid"]],
                        b["train"] + [v[0] for v in b["valid"]]):
            np.testing.assert_array_equal(x, y)
        assert all(x.shape[0] == 4 for x in a["train"])
        rows = {int(r) for x, (_, valid) in zip(
            [v[0] for v in a["valid"]], a["valid"]) for r in
            x[valid][:, 0] if r}
        seen.append(rows)
    assert not seen[0] & seen[1]
    assert seen[0] | seen[1] == set(range(1000, 1040))


@pytest.mark.parametrize("world,cfg,want", [
    (4, MeshConfig(dp=2, mp=2), (2, 2)),
    (4, MeshConfig(dp=-1, mp=2), (2, 2)),
    (4, MeshConfig(dp=-1, mp=-1), (4, 1)),
    (4, MeshConfig(dp=1, mp=-1), (1, 4)),
    (1, MeshConfig(dp=1, mp=1), (1, 1))])
def test_mesh_shape_resolves_as_jax(world, cfg, want):
    assert resolve_shape(cfg, world) == want


@pytest.mark.parametrize("cfg", [MeshConfig(dp=2, mp=2, cp=2),
                                 MeshConfig(dp=1, mp=1, pp=2),
                                 MeshConfig(dp=-1, mp=1, cp=4),
                                 MeshConfig(dp=-1, mp=2, cp=2),
                                 MeshConfig(dp=1, mp=-1, cp=2),
                                 MeshConfig(dp=-1, mp=-1, cp=8)])
def test_context_and_pipeline_axes_raise(cfg):
    """The pipeline axis still raises (ROADMAP A.3b); a seq axis resolves
    to JAX ``make_mesh``'s shape on eight devices, appended only where
    cp > 1."""
    if cfg.pp > 1:
        with pytest.raises(NotImplementedError, match="ROADMAP A.3"):
            resolve_shape(cfg, 8)
        return
    want = jmake_mesh(JMeshConfig(dp=cfg.dp, mp=cfg.mp, cp=cfg.cp),
                      devices=jax.devices()[:8])
    assert resolve_shape(cfg, 8) == tuple(want.devices.shape)
    assert want.axis_names == ("data", "model", "seq")[:len(
        want.devices.shape)]


def test_indivisible_context_axis_raises_as_jax():
    with pytest.raises(ValueError, match="not divisible by cp=3"):
        resolve_shape(MeshConfig(dp=-1, cp=3), 8)
    with pytest.raises(AssertionError):
        jmake_mesh(JMeshConfig(dp=-1, cp=3), devices=jax.devices()[:8])
