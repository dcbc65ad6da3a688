"""PyTorch port: context parallelism (``dist/context.py``) against the JAX
package's, on the CPU.

Two gloo worlds of four ranks (``torch_dist_workers.run_world``): a
seq-only mesh (cp = 4) for the attention pieces and the models' logits,
and a (dp = 2, mp = 1, cp = 2) mesh for the train steps, the eval and
``cli.train --dp 2 --cp 2``. The JAX side runs in this process on the
conftest's virtual CPU devices, as ``tests/test_context.py`` and
``tests/test_long_context.py:295-434`` run it.

* ``ring_attention``, ``ulysses_attention`` (causal or not, left-padded
  keys: rows that see no key) and ``mau_ring_attention`` (BiMAU and a
  causal MAU) against JAX's ``*_spmd`` functions on a (data 2, seq 4) mesh
  and against the dense path (``attention_probs``; the MAU's plain
  chain): values to 2e-5, gradients to 5e-5 (``test_context.py``'s
  bounds); the in-process ``LocalExchange`` (which ``chip_smoke.py`` runs
  on the card) equals the world bit for bit (the MAU to 1e-6 of scale:
  its intensity head's products run at another batch shape, and its
  replicated weights' gradients are summed in another order);
* dropout at rate 0.4 on uniform probs with one-hot values, which read
  the keep mask back: keep fraction, the 1 / (1 - rate) rescale, one mask
  for the forward and the backward, a seed's replay and another seed;
* BERT4REC (T = L + 1 = 8) and TGAT (factored) logits under cp = 4 against
  JAX's single-device logits (BERT4REC also against JAX's cp = 4 mesh;
  JAX's TGAT ring raises a shape error: ROADMAP §C) at 2e-4;
* SASREC (ring and Ulysses) and EasyDGL train steps on the (2, 1, 2)
  world: the loss to 1e-5 relative and the gradients to 1e-4 of each
  leaf's scale against JAX's single-device gradients (EasyDGL: JAX's
  op-by-op ones, its jitted ones at 2e-4, see its test; 5e-5 against the
  port's single-device ones), the parameters
  after the step at rtol 2e-4 / atol 2e-5 against JAX's single-device and
  (2, 1, 2) mesh steps; three EasyDGL steps with a rank's own term in its
  gradients leave every replicated parameter bit-identical on all four
  ranks; the eval logits under cp to 1e-5; ``cli.train --dp 2 --cp 2``
  trains on all four ranks to one summary, and one-process
  ``cli.analytics`` on its checkpoint reports that summary's metrics.

Dropout is 0 wherever the two packages are compared (their PRNG streams
differ by design, C3).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from easydgl_tpu.config import MeshConfig as JMeshConfig
from easydgl_tpu.config import preset as jpreset
from easydgl_tpu.core.mesh import make_mesh as jmake_mesh
from easydgl_tpu.core.mesh import use_spmd_mesh as juse_mesh
from easydgl_tpu.data.loader import BatchLoader as JBatchLoader
from easydgl_tpu.data.synthetic import synthetic_mark_table, synthetic_split
from easydgl_tpu.dist import context as jctx
from easydgl_tpu.models.registry import build_model as jbuild
from easydgl_tpu.train import optim as joptim
from easydgl_tpu.train import sharded as jsharded
from easydgl_tpu.train import steps as jsteps
from easydgl_tpu_torch.cli import analytics as analytics_cli
from easydgl_tpu_torch.config import preset
from easydgl_tpu_torch.dist.context import (LocalExchange, ring_attention,
                                            ulysses_attention)
from easydgl_tpu_torch.kernels import mau_attention as mau_kernels
from easydgl_tpu_torch.kernels.mau_attention import mau_attention
from easydgl_tpu_torch.models.registry import build_model, model_class
from easydgl_tpu_torch.nn.attention import attention_probs
from easydgl_tpu_torch.nn.layers import merge_heads
from easydgl_tpu_torch.parity import flax_to_torch, random_flax_params
from easydgl_tpu_torch.train.steps import loss_and_grads
from torch_dist_workers import context_case, run_world

torch.set_num_threads(2)
B, H, T, D, E = 4, 4, 32, 8, 5


# ---------------------------------------------------------------- pieces


def _attention_case(kind, causal, seed):
    """``tests/test_context.py::_data``: left padding (rows 0-5 see no key
    when causal), the last two keys real."""
    rng = np.random.RandomState(seed)
    mk = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    km = (rng.rand(B, T) > 0.25).astype(np.float32)
    km[:, :6] = 0.0
    km[:, -2:] = 1.0
    return dict(kind=kind, causal=causal, q=mk(B, H, T, D), k=mk(B, H, T, D),
                v=mk(B, H, T, D), km=km, co=mk(B, H, T, D))


def _mau_case(causal, diag, seed):
    rng = np.random.RandomState(seed)
    mk = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    km = (rng.rand(B, T) > 0.3).astype(np.float32)
    km[:, :5] = 0.0
    km[:, -2:] = 1.0
    return dict(kind="mau", causal=causal, diag=diag, q=mk(B, H, T, D),
                k=mk(B, H, T, D), v=mk(B, H, T, D), t=mk(B, H, T, D), km=km,
                iv=rng.rand(B, T).astype(np.float32),
                oh=(rng.rand(B, T, E) > 0.5).astype(np.float32),
                wd=mk(D + 1, E * D) * 0.3, bd=mk(E * D) * 0.1,
                w=mk(E, D) * 0.3, sc=mk(E) * 0.1, co=mk(B, H, T, D))


CASES = {"ring": _attention_case("ring", False, 1),
         "ring_causal": _attention_case("ring", True, 2),
         "ulysses": _attention_case("ulysses", False, 3),
         "ulysses_causal": _attention_case("ulysses", True, 4),
         "mau_bimau": _mau_case(False, True, 5),
         "mau_causal": _mau_case(True, False, 6)}
CASES["ring_dropout"] = dict(CASES["ring"], rate=0.4, seed=11)


def _model_payload(name, kw, rows, seed, *, training, mark=False,
                   mode=None):
    """A batch from the JAX loader and seeded weights (a nonzero output
    bias)."""
    cfg = preset(name, **kw)
    ds = synthetic_split(num_rows=rows, num_items=cfg.num_items,
                         seqslen=cfg.seqslen, seed=seed)
    table = synthetic_mark_table(cfg.num_items, cfg.num_events or 4,
                                 seed=2) if mark else None
    ld = JBatchLoader(ds, data_mode=mode or model_class(cfg).data_mode,
                      batch_size=cfg.batch_size, masklen=cfg.masklen,
                      is_training=training, mark_table=table,
                      needs_marks=mark, use_native=False)
    features, labels, _ = next(ld.epoch(0))
    params = random_flax_params(cfg, seed=0)
    ob = params["params"]["out_bias"]
    ob["output_bias"] = np.random.default_rng(5).normal(
        0, 0.5, np.shape(ob["output_bias"])).astype(np.float32)
    return dict(model=name, cfg=kw, params=params, features=features,
                batches=[(features, labels)])


ZERO = dict(hidden_dropout_rate=0.0, attention_probs_dropout_rate=0.0)
BERT4REC = dict(num_items=50, seqslen=7, num_units=16, num_heads=2,
                num_blocks=2, masklen=3, batch_size=8, **ZERO)
TGAT = dict(num_items=50, seqslen=8, num_units=16, num_heads=2,
            num_blocks=2, batch_size=8, attention_impl="factored", **ZERO)
SASREC = dict(num_items=50, seqslen=8, num_units=16, num_heads=2,
              num_blocks=2, batch_size=8, l2_reg=1e-4, **ZERO)
EASYDGL = dict(num_items=50, seqslen=7, num_units=16, num_heads=2,
               num_blocks=1, num_events=4, masklen=3, batch_size=8,
               ct_reg=1e-4, **ZERO)
LOGITS = {"bert4rec": ("BERT4REC", BERT4REC, 4, "masked"),
          "tgat": ("TGAT", TGAT, 5, None)}
STEPS = {"sasrec": ("SASREC", SASREC, 7, False),
         "sasrec_ulysses": ("SASREC", dict(SASREC, cp_impl="ulysses"), 7,
                            False),
         "easydgl": ("EasyDGL", EASYDGL, 5, True)}
CLI = ["--model", "SASREC", "--synthetic", "--synthetic_rows", "32",
       "--num_items", "60", "--seqslen", "8", "--num_units", "16",
       "--num_heads", "2", "--num_blocks", "1", "--batch_size", "8",
       "--num_epochs", "1", "--device", "cpu", "--dp", "2", "--cp", "2",
       "--ckpt_dir", "ckpt"]


@pytest.fixture(scope="module")
def seq_world(tmp_path_factory):
    """The pieces and the logits on a seq-only world of four ranks."""
    jobs = {"pieces": ("w_context", CASES)}
    for key, (name, kw, seed, mode) in LOGITS.items():
        jobs[key] = ("w_logits", _model_payload(name, kw, 16, seed,
                                                training=False, mode=mode))
    res = run_world("w_many", jobs, 1, 1, tmp_path_factory.mktemp("seq"),
                    cp=4)
    return jobs, res


@pytest.fixture(scope="module")
def step_world(tmp_path_factory):
    """The train steps, the eval and the CLI on a (2, 1, 2) world."""
    jobs = {}
    for key, (name, kw, seed, mark) in STEPS.items():
        p = _model_payload(name, kw, 16, seed, training=True, mark=mark)
        jobs[key] = ("w_train", p)
        jobs[key + "_grads"] = ("w_grads", p)
    p = dict(jobs["easydgl"][1])
    p["batches"] = p["batches"] * 3
    jobs["replicas"] = ("w_replicas", p)
    jobs["eval"] = ("w_logits", _model_payload("SASREC", SASREC, 16, 11,
                                               training=False))
    cwd = tmp_path_factory.mktemp("cli")
    jobs["cli"] = ("w_cli_in_world", dict(cwd=str(cwd), argv=CLI))
    res = run_world("w_many", jobs, 2, 1, tmp_path_factory.mktemp("steps"),
                    cp=2)
    return jobs, res


def _j(x):
    return jnp.asarray(np.asarray(x))


@functools.lru_cache(maxsize=None)
def _jax_spmd(name):
    """JAX's ``*_spmd`` on a (data 2, seq 4) mesh, jitted: the output
    [, lam] and the gradients of the case's loss."""
    case = CASES[name]
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4),
                ("data", "seq"))
    kw = dict(seq_axis="seq", data_axis="data", causal=case["causal"])
    if case["kind"] == "mau":
        names = ("q", "k", "v", "t", "wd", "bd", "w", "sc")

        def loss(*xs):
            x = dict(zip(names, xs))
            out, lam = jctx.mau_ring_attention_spmd(
                x["q"], x["k"], x["v"], x["t"], _j(case["km"]),
                _j(case["iv"]), _j(case["oh"]), x["wd"], x["bd"], x["w"],
                x["sc"], 0, mesh, diag_reset=case["diag"], **kw)
            return (jnp.sum(out * _j(case["co"])) + jnp.sum(jnp.cos(lam)),
                    (out, lam))
    else:
        names = ("q", "k", "v")
        fn = (jctx.ring_attention_spmd if case["kind"] == "ring"
              else jctx.ulysses_attention_spmd)

        def loss(*xs):
            out = fn(*xs, _j(case["km"]), mesh, **kw)
            return jnp.sum(out * _j(case["co"])), (out,)
    (_, outs), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(names))), has_aux=True))(
        *(_j(case[n]) for n in names))
    return [np.asarray(o) for o in outs], dict(zip(names, map(np.asarray,
                                                              grads)))


def _dense(case, keep=None):
    """The port's dense path: ``attention_probs`` @ v, or the MAU's plain
    chain (``kernels/mau_attention.py`` on the CPU); ``keep``: (B, H, T, T)
    dropout factors applied to the (modulated) probs."""
    names = (("q", "k", "v", "t", "wd", "bd", "w", "sc")
             if case["kind"] == "mau" else ("q", "k", "v"))
    x = {n: torch.tensor(case[n]).requires_grad_() for n in names}
    km = torch.tensor(case["km"])
    if case["kind"] == "mau":
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mau_kernels, "dropout_factor",
                       lambda *a, **k: keep)
            out, lam = mau_attention(
                *(merge_heads(x[n]) for n in "qkvt"), km,
                torch.tensor(case["iv"]), torch.tensor(case["oh"]),
                x["wd"], x["bd"], x["w"], x["sc"], case["causal"],
                case["diag"], 0.0 if keep is None else case["rate"],
                num_heads=H, dropout_seed=0)
        out = out.unflatten(-1, (H, D)).transpose(1, 2)
        loss = (out * torch.tensor(case["co"])).sum() + torch.cos(lam).sum()
        outs = [out, lam]
    else:
        probs = attention_probs(x["q"], x["k"], key_mask=km,
                                causal=case["causal"])
        if keep is not None:
            probs = probs * keep
        out = probs @ x["v"]
        loss = (out * torch.tensor(case["co"])).sum()
        outs = [out]
    loss.backward()
    return ([o.detach().numpy() for o in outs],
            {n: x[n].grad.numpy() for n in names})


PIECES = ["ring", "ring_causal", "ulysses", "ulysses_causal", "mau_bimau",
          "mau_causal"]


@pytest.mark.parametrize("name", PIECES)
def test_values_match_jax_spmd_and_dense(seq_world, name):
    _, res = seq_world
    case = CASES[name]
    got = res[0]["pieces"][name]
    outs = [got["out"]] + ([got["lam"]] if "lam" in got else [])
    for ref in (_jax_spmd(name)[0], _dense(case)[0]):
        for a, b in zip(outs, ref):
            np.testing.assert_allclose(np.asarray(a), b, rtol=2e-5,
                                       atol=2e-5, err_msg=name)


@pytest.mark.parametrize("name", PIECES)
def test_gradients_match_jax_spmd_and_dense(seq_world, name):
    _, res = seq_world
    case = CASES[name]
    got = res[0]["pieces"][name]["grads"]
    for ref in (_jax_spmd(name)[1], _dense(case)[1]):
        assert set(ref) == set(got)
        for n, want in ref.items():
            np.testing.assert_allclose(np.asarray(got[n]), want, rtol=5e-5,
                                       atol=5e-5, err_msg=f"{name} d{n}")


@pytest.mark.parametrize("name", list(CASES))
def test_local_exchange_equals_the_world(seq_world, name):
    """Every rank returns the same whole tensors, and one process holding
    the four ranks' blocks computes them too."""
    _, res = seq_world
    local = context_case(LocalExchange(4), CASES[name])
    tol = 1e-6 if name.startswith("mau") else 0.0
    for r in res:
        got = r["pieces"][name]
        for key in ("out", "lam"):
            if key in local:
                scale = float(local[key].abs().max())
                torch.testing.assert_close(got[key], local[key], rtol=0,
                                           atol=tol * scale, msg=key)
        for n, g in local["grads"].items():
            scale = float(g.abs().max())
            torch.testing.assert_close(got["grads"][n], g, rtol=0,
                                       atol=tol * scale, msg=n)


def _replayed_keep(case, cp):
    """The (B, H, T, T) keep factors the cp bodies draw from a generator
    seeded as ``context_case`` seeds it: each ring step (the MAU's second
    sweep) draws every rank's block at once, rank r's the queries of block
    r against the keys of block (r - step) mod cp; Ulysses draws every
    rank's block of H/cp heads over the whole sequence."""
    rate = case["rate"]
    gen = torch.Generator().manual_seed(case["seed"])
    b, h, t = case["q"].shape[:3]
    if case["kind"] == "ulysses":
        u = torch.rand((cp, b, h // cp, t, t), generator=gen)
        u = u.transpose(0, 1).reshape(b, h, t, t)
    else:
        tl = t // cp
        u = torch.empty(b, h, t, t)
        for step in range(cp):
            blocks = torch.rand((cp, b, h, tl, tl), generator=gen)
            for r in range(cp):
                kr = (r - step) % cp
                u[:, :, r * tl:(r + 1) * tl, kr * tl:(kr + 1) * tl] = \
                    blocks[r]
    return torch.where(u < 1.0 - rate, torch.tensor(1.0 / (1.0 - rate)),
                       torch.tensor(0.0))


@pytest.mark.parametrize("name", ["ring", "ring_causal", "ulysses",
                                  "mau_bimau", "mau_causal"])
def test_dropout_masks_are_the_documented_draws(name):
    """At rate 0.4 the bodies equal the dense path with the mask replayed
    from the generator (``_replayed_keep``): values to 2e-5, gradients to
    5e-5, as at rate 0."""
    case = dict(CASES[name], rate=0.4, seed=11)
    got = context_case(LocalExchange(4), case)
    outs, grads = _dense(case, _replayed_keep(case, 4))
    for key, want in zip(("out", "lam"), outs):
        np.testing.assert_allclose(got[key].numpy(), want, rtol=2e-5,
                                   atol=2e-5, err_msg=key)
    for n, want in grads.items():
        np.testing.assert_allclose(got["grads"][n].numpy(), want, rtol=5e-5,
                                   atol=5e-5, err_msg=f"d{n}")


def test_ring_seq_only_mesh_of_eight():
    """cp = 8 ranks in one process (``test_context.py``'s seq-only mesh):
    B = 2, T = 64, causal."""
    rng = np.random.RandomState(7)
    q, k, v = (torch.tensor(rng.randn(2, H, 64, D).astype(np.float32))
               for _ in range(3))
    km = (rng.rand(2, 64) > 0.25).astype(np.float32)
    km[:, :6] = 0.0
    km = torch.tensor(km)
    out = ring_attention(q, k, v, km, LocalExchange(8), causal=True)
    ref = attention_probs(q, k, key_mask=km, causal=True) @ v
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)


def test_indivisible_sequence_and_heads_raise():
    x = torch.zeros(1, 4, 12, 8)
    km = torch.ones(1, 12)
    with pytest.raises(ValueError, match="not divisible"):
        ring_attention(x, x, x, km, LocalExchange(5), causal=False)
    with pytest.raises(AssertionError, match="divisible by sp"):
        ulysses_attention(x, x, x, km, LocalExchange(3), causal=False)


# ---------------------------------------------------------------- dropout


def _probe(kind, rate, seed, cp=4):
    """Uniform probs (q = k = 0, every key real) and one-hot values
    (D = T): the output row i holds keep_ij * w_ij / (1 - rate) for key
    j, w_ij the undropped weight (1/T, times the intensity for the MAU).
    Returns (keep read back, the output, dv)."""
    b, h, t, e = 2, 4, 32, 3
    z = np.zeros((b, h, t, t), np.float32)
    eye = np.broadcast_to(np.eye(t, dtype=np.float32), (b, h, t, t)).copy()
    case = dict(kind=kind, causal=False, q=z, k=z, v=eye,
                km=np.ones((b, t), np.float32), co=np.ones_like(z),
                rate=rate, seed=seed)
    if kind == "mau":
        rng = np.random.RandomState(0)
        case.update(t=rng.randn(b, h, t, t).astype(np.float32), diag=True,
                    iv=np.ones((b, t), np.float32),
                    oh=np.ones((b, t, e), np.float32),
                    wd=rng.randn(t + 1, e * t).astype(np.float32) * 0.1,
                    bd=np.zeros(e * t, np.float32),
                    w=rng.randn(e, t).astype(np.float32) * 0.1,
                    sc=np.zeros(e, np.float32))
    res = context_case(LocalExchange(cp), case)
    out = res["out"].numpy()
    w = np.full(out.shape, 1.0 / t, np.float32)
    if kind == "mau":
        iqk = res["lam"].numpy().sum(-1)[..., None] * np.ones_like(out)
        iqk[..., np.arange(t), np.arange(t)] = 1.0
        w = w * iqk
    return out * (1.0 - rate) / w, out, res["grads"]["v"].numpy()


@pytest.mark.parametrize("kind", ["ring", "ulysses", "mau"])
def test_dropout_statistics(kind):
    rate = 0.4
    keep, out, dv = _probe(kind, rate, seed=5)
    kept = np.isclose(keep, 1.0, atol=1e-4)
    assert (kept | np.isclose(keep, 0.0, atol=1e-4)).all()  # 0 or rescaled
    assert abs(kept.mean() - (1.0 - rate)) < 0.03
    # the backward drops what the forward dropped: dv_j = sum_i out_ij
    np.testing.assert_allclose(dv, np.broadcast_to(
        out.sum(-2)[..., None], dv.shape), rtol=1e-5, atol=1e-6)
    again, _, _ = _probe(kind, rate, seed=5)
    np.testing.assert_array_equal(keep, again)
    other, _, _ = _probe(kind, rate, seed=6)
    assert (np.isclose(other, 1.0, atol=1e-4) != kept).mean() > 0.2
    # each rank (and ring step) draws its own mask
    q0, q1 = kept[..., :8, :], kept[..., 8:16, :]
    assert (q0 != q1).any()


# ---------------------------------------------------------------- models


def _jcfg(name, kw):
    return jpreset(name).replace(use_pallas=False, **kw)


def test_bert4rec_cp_logits_match_jax(seq_world):
    jobs, res = seq_world
    p = jobs["bert4rec"][1]
    jm = jbuild(_jcfg("BERT4REC", BERT4REC))
    feats = {k: jnp.asarray(v) for k, v in p["features"].items()}
    ref, _ = jm.apply(p["params"], feats, is_training=False)
    mesh = jmake_mesh(JMeshConfig(dp=2, mp=1, cp=4))

    @jax.jit
    def mesh_logits(params, f):
        with juse_mesh(mesh):
            return jm.apply(params, f, is_training=False)[0]

    jcp = mesh_logits(p["params"], feats)
    for r in res:
        for want in (ref, jcp):
            np.testing.assert_allclose(r["bert4rec"].numpy(),
                                       np.asarray(want), rtol=2e-4,
                                       atol=2e-4)


def test_tgat_ring_logits_match_jax_single_device(seq_world):
    """TGAT's factored attention through the ring, the augmented width
    4 dh for q and k and dh for v; JAX's own TGAT ring sizes its
    accumulator by q's width and raises, so the reference is JAX's
    single-device factored model, and the port's."""
    jobs, res = seq_world
    p = jobs["tgat"][1]
    jm = jbuild(_jcfg("TGAT", TGAT))
    feats = {k: jnp.asarray(v) for k, v in p["features"].items()}
    ref, _ = jm.apply(p["params"], feats, is_training=False)
    model = build_model(preset("TGAT", **TGAT), device="cpu",
                        params=p["params"])
    with torch.no_grad():
        single, _ = model({k: torch.as_tensor(v) for k, v in
                           p["features"].items()}, is_training=False)
    for r in res:
        for want in (np.asarray(ref), single.numpy()):
            np.testing.assert_allclose(r["tgat"].numpy(), want, rtol=2e-4,
                                       atol=2e-4)


def _jax_single(name, kw, payload):
    """JAX's single-device (loss, gradients, state after one step)."""
    jm = jbuild(_jcfg(name, kw))
    features, labels = payload["batches"][0]
    jf = {k: jnp.asarray(v) for k, v in features.items()}
    jl = jnp.asarray(labels)
    params = payload["params"]
    loss, grads = jax.jit(jax.value_and_grad(
        lambda prm: jsteps.compute_loss(
            jm, prm, jf, jl, rngs={"dropout": jax.random.key(7)})))(params)
    tx = joptim.build_optimizer(jm.cfg.optim)
    state = jsteps.TrainState(params, tx.init(params),
                              jnp.zeros((), jnp.int32))
    new, _ = jsteps.build_train_step(jm, donate=False)(
        state, jf, jl, jax.random.key(7))
    return float(loss), grads, new


def _jax_eager_grads(name, kw, payload):
    """JAX's single-device gradients run op by op (no ``jax.jit``), as
    flattened torch names -> arrays."""
    jm = jbuild(_jcfg(name, kw))
    features, labels = payload["batches"][0]
    jf = {k: jnp.asarray(v) for k, v in features.items()}
    grads = jax.grad(lambda prm: jsteps.compute_loss(
        jm, prm, jf, jnp.asarray(labels),
        rngs={"dropout": jax.random.key(7)}))(payload["params"])
    return {n: t.numpy() for n, t in flax_to_torch(
        jax.tree.map(np.asarray, grads)).items()}


def _jax_cp_step(name, kw, payload):
    """JAX's build_sharded_train_step on a (2, 1, 2) mesh."""
    jm = jbuild(_jcfg(name, kw))
    features, labels = payload["batches"][0]
    jf = {k: jnp.asarray(v) for k, v in features.items()}
    jl = jnp.asarray(labels)
    params = payload["params"]
    tx = joptim.build_optimizer(jm.cfg.optim)
    state = jsteps.TrainState(params, tx.init(params),
                              jnp.zeros((), jnp.int32))
    mesh = jmake_mesh(JMeshConfig(dp=2, mp=1, cp=2),
                      devices=jax.devices()[:4])
    sh = jsharded.batch_shardings((jf, jl), mesh)
    return jsharded.build_sharded_train_step(jm, mesh, (jf, jl))(
        jsharded.shard_state(state, mesh),
        jax.tree.map(jax.device_put, jf, sh[0]), jax.device_put(jl, sh[1]),
        jax.random.key(7))


def grads_close(got, want, tol=1e-4):
    """Each leaf to ``tol`` of its scale: its largest |gradient|, at least
    1e-3 of the model's largest (a leaf whose gradient is zero in exact
    arithmetic, as a key projection's bias under the softmax, holds
    rounding noise)."""
    top = max(float(np.abs(w).max()) for w in want.values())
    for n, w in want.items():
        w = np.asarray(w, np.float64)
        scale = max(float(np.abs(w).max()), 1e-3 * top)
        err = float(np.abs(np.asarray(got[n], np.float64) - w).max())
        assert err <= tol * scale, (n, err, scale)


def _port_single(name, kw, payload):
    """The port's single-device (loss, gradients) of the payload's batch."""
    model = build_model(preset(name, **kw), device="cpu",
                        params=payload["params"])
    features, labels = payload["batches"][0]
    loss, grads = loss_and_grads(
        model, {k: torch.as_tensor(v) for k, v in features.items()},
        torch.as_tensor(labels))
    return float(loss), {n: g.numpy() for n, g in grads.items()}


def _check_step(key, step_world, jax_cp=True, jax_tol=1e-4, eager=False):
    jobs, res = step_world
    name, kw, _, _ = STEPS[key]
    payload = jobs[key][1]
    jloss, jgrads, jnew = _jax_single(name, kw, payload)
    want_grads = {n: t.numpy() for n, t in flax_to_torch(
        jax.tree.map(np.asarray, jgrads)).items()}
    ploss, pgrads = _port_single(name, kw, payload)
    if eager:
        eager = _jax_eager_grads(name, kw, payload)
    for r in res:
        g = r[key + "_grads"]
        got = {n: t.numpy() for n, t in g["grads"].items()}
        np.testing.assert_allclose(g["loss"], jloss, rtol=1e-5)
        np.testing.assert_allclose(g["loss"], ploss, rtol=1e-5)
        assert set(got) == set(want_grads)
        grads_close(got, pgrads, tol=5e-5)
        grads_close(got, want_grads, tol=jax_tol)
        if eager:
            grads_close(got, eager, tol=1e-4)
    states = [("single", jnew)]
    if jax_cp:
        states.append(("cp", _jax_cp_step(name, kw, payload)[0]))
    r0 = res[0][key]
    for which, st in states:
        want = flax_to_torch(jax.tree.map(np.asarray, st.params))
        for n, w in want.items():
            np.testing.assert_allclose(r0["params"][n].numpy(), w.numpy(),
                                       rtol=2e-4, atol=2e-5,
                                       err_msg=f"{which} {n}")
    for r in res[1:]:
        assert r[key]["losses"] == r0["losses"]


def test_sasrec_cp_train_step_matches_jax(step_world):
    _check_step("sasrec", step_world)


def test_sasrec_ulysses_train_step_matches_jax(step_world):
    _check_step("sasrec_ulysses", step_world, jax_cp=False)


def test_easydgl_cp_train_step_matches_jax(step_world):
    """The ring MAU: the intensity head's replicated weights get each seq
    rank's rows' gradient once. The gradients equal the port's
    single-device ones to 5e-5 of each leaf's scale and JAX's op-by-op
    single-device ones to 1e-4. JAX's jitted gradients are held at 2e-4:
    compiled, its fp32 time coding (sin / cos of arguments near 1.2e4 rad)
    is up to 2.4e-4 off the op-by-op values, and its ``intensity_scaling``
    gradient lies 1.08e-4 of scale from its own float64 gradient, where the
    port's and JAX's op-by-op ones lie within 1e-6 of it (ROADMAP C15)."""
    _check_step("easydgl", step_world, jax_tol=2e-4, eager=True)


def test_replicated_parameters_stay_bit_identical_over_cp_ranks(
        step_world):
    """Three EasyDGL steps in which each rank's gradients carry a term of
    their own before the reduction: every parameter (the table too, whole
    on every rank: V = 50 at mp = 1) equal bit for bit on all four
    ranks."""
    _, res = step_world
    r0 = res[0]["replicas"]["params"]
    for r in res[1:]:
        for n, t in r["replicas"]["params"].items():
            torch.testing.assert_close(t, r0[n], rtol=0, atol=0, msg=n)
    assert {r["replicas"]["coords"][:2] for r in res} == {(0, 2), (1, 2)}


def test_cp_eval_logits_match_jax(step_world):
    jobs, res = step_world
    p = jobs["eval"][1]
    jm = jbuild(_jcfg("SASREC", SASREC))
    feats = {k: jnp.asarray(v) for k, v in p["features"].items()}
    ref, _ = jm.apply(p["params"], feats, is_training=False)
    ref = np.asarray(ref)
    n = ref.shape[0] // 2
    for r, coords in zip(res, [(0, 0), (0, 1), (1, 0), (1, 1)]):
        d = coords[0]
        np.testing.assert_allclose(r["eval"].numpy(),
                                   ref[d * n:(d + 1) * n], rtol=1e-5,
                                   atol=1e-5)


def test_cli_trains_with_dp_and_cp_on_four_ranks(step_world):
    _, res = step_world
    s0 = res[0]["cli"]
    assert all(np.isfinite(v) for v in s0.values())
    for r in res[1:]:
        assert r["cli"] == s0


def test_cp_checkpoint_restores_on_one_device(step_world, monkeypatch):
    """``tests/test_multihost.py:357``'s check: one-process
    ``cli.analytics`` on the checkpoint the (2, 1, 2) run wrote reports its
    summary's test metrics (the distributed eval's, the attention's
    sequence split over two ranks) to 1e-5."""
    jobs, res = step_world
    root = jobs["cli"][1]["cwd"]
    monkeypatch.chdir(root)
    synthetic_split(num_rows=32 // 8, seed=3, num_items=60, seqslen=8,
                    with_datetime=True).save("test.npz")
    got = analytics_cli.main([
        "--ckpt", "ckpt", "--model", "SASREC", "--data_dir", ".", "--out",
        "res", "--device", "cpu", "--num_items", "60", "--seqslen", "8",
        "--num_units", "16", "--num_heads", "2", "--num_blocks", "1",
        "--batch_size", "8"])
    for k, v in res[0]["cli"].items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
