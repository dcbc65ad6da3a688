"""PyTorch port: the training harness (loop, checkpoints, early stopping,
profiler helpers, the multi and analytics steps) vs the JAX package, on the
CPU.

Tiny config: EasyDGL, V = 40, L = 10, C = 16, H = 2, 1 block, E = 4,
B = 16, 64 train rows (4 steps an epoch), 16 validation and 16 test rows.

* ``train_model`` against JAX ``train_model`` at dropout 0, both started
  from one step-0 state (JAX ``init_state``, written by each side's
  ``Checkpointer`` at step 0 and resumed from): after two epochs the
  parameters within 1e-4 of each leaf's scale (max |leaf| of JAX's), the
  step counts equal, the summaries' metrics to 1e-6 relative. JAX's train
  step is compiled without XLA's algebraic simplifier: its rewrites move
  the biases of the MAU projections and of the intensity head by up to
  7e-4 of their scale here, where the port is held to the program as
  written (ROADMAP C). Op by op (``jax.disable_jit``) JAX agrees with the
  port to 7e-5 of a leaf's scale too, at three times this test's time;
* at dropout 0.1, two epochs straight equal one epoch plus a resumed
  epoch, exactly (the ``(seed, step)`` dropout generator);
* the checkpoint round trip restores into the live model, in place;
* ``EarlyStopping`` against JAX's on a scripted sequence, NaN included;
* ``build_multi_step`` against K single steps, exactly, at dropout 0.1;
* ``NanGuard``, ``grad_norms`` (against JAX's, 1e-6 relative),
  ``StepTimer`` and ``trace``;
* ``build_analytics_step`` against JAX's (compiled as written, as above):
  logits 1e-4, sums 1e-6 relative.
"""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easydgl_tpu.config import preset as jpreset
from easydgl_tpu.data import native as jnative
from easydgl_tpu.data.loader import BatchLoader as JBatchLoader
from easydgl_tpu.data.synthetic import synthetic_mark_table, synthetic_split
from easydgl_tpu.models.registry import build_model as jbuild
from easydgl_tpu.train import checkpoint as jcheckpoint
from easydgl_tpu.train import early_stopping as jearly
from easydgl_tpu.train import loop as jloop
from easydgl_tpu.train import profiler as jprofiler
from easydgl_tpu.train import steps as jsteps
from easydgl_tpu_torch.config import preset
from easydgl_tpu_torch.data.loader import BatchLoader, PackedDataset
from easydgl_tpu_torch.models.registry import build_model
from easydgl_tpu_torch.parity import (flax_to_torch, random_flax_params,
                                      tf_adam_state_to_torch)
from easydgl_tpu_torch.train import loop, profiler
from easydgl_tpu_torch.train.checkpoint import Checkpointer
from easydgl_tpu_torch.train.early_stopping import EarlyStopping
from easydgl_tpu_torch.train.steps import (build_analytics_step,
                                           build_multi_step,
                                           build_train_step,
                                           dropout_generator, init_state,
                                           stack_batches)

torch.set_num_threads(2)
V, L, B, E = 40, 10, 16, 4
KW = dict(num_items=V, seqslen=L, num_units=16, num_heads=2, num_blocks=1,
          num_events=E, batch_size=B, hidden_dropout_rate=0.0,
          attention_probs_dropout_rate=0.0)
DROP = dict(KW, hidden_dropout_rate=0.1, attention_probs_dropout_rate=0.1)
# XLA without its algebraic simplifier: JAX's program as written
AS_WRITTEN = {"xla_disable_hlo_passes": "algsimp"}


@pytest.fixture(scope="module")
def splits():
    """The JAX package's splits and the port's, from the same arrays."""
    jax_splits = tuple(synthetic_split(num_rows=n, num_items=V, seqslen=L,
                                       seed=s)
                       for n, s in ((64, 1), (16, 2), (16, 3)))
    port = tuple(PackedDataset(dict(ds.arrays), V) for ds in jax_splits)
    return jax_splits, port, synthetic_mark_table(V, E, seed=4)


def _jax_train_step_as_written(model, donate=True, mark_table=None):
    """JAX's train step, compiled on its first call without the algebraic
    simplifier (``xla_disable_hlo_passes``)."""
    jitted = jsteps.build_train_step(model, donate=False,
                                     mark_table=mark_table)
    compiled = []

    def step(*args):
        if not compiled:
            compiled.append(jitted.lower(*args).compile(
                compiler_options=AS_WRITTEN))
        return compiled[0](*args)

    return step


def test_train_model_matches_jax_from_one_step0_state(splits, tmp_path,
                                                      monkeypatch):
    (jtr, jvl, jte), (tr, vl, te), table = splits
    # the JAX loaders' batches are the NumPy protocol's, as the port's
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(jloop, "build_train_step", _jax_train_step_as_written)
    jcfg = jpreset("EasyDGL", **KW)
    jm = jbuild(jcfg)
    trl, _, _ = jloop.make_loaders(jcfg, jm, jtr, jvl, jte, table,
                                   marks_on_device=True)
    features, labels, _ = next(trl.epoch(0))
    sample = jsteps.device_marks(
        {k: jnp.asarray(v) for k, v in features.items()},
        jnp.asarray(labels), jnp.asarray(table, jnp.float32),
        is_training=True)
    state0 = jax.tree.map(np.asarray, jax.jit(
        lambda s: jsteps.init_state(jm, s, jcfg.seed))(sample))
    jcheckpoint.Checkpointer(str(tmp_path / "jax")).save(state0)

    cfg = preset("EasyDGL", **KW)
    model = build_model(cfg, device="cpu", params=state0.params)
    adam = state0.opt_state[0]
    Checkpointer(str(tmp_path / "port")).save(init_state(model)._replace(
        opt_state=tf_adam_state_to_torch(adam.count, adam.mu, adam.nu)))

    jstate, jsummary = jloop.train_model(
        jcfg, jtr, jvl, jte, mark_table=table,
        ckpt_dir=str(tmp_path / "jax"), num_epochs=2, resume=True)
    state, summary = loop.train_model(
        cfg, tr, vl, te, mark_table=table, ckpt_dir=str(tmp_path / "port"),
        num_epochs=2, resume=True, device="cpu", use_native=False)

    assert state.step == int(jstate.step) == 8
    want = flax_to_torch(jax.tree.map(np.asarray, jstate.params))
    assert set(want) == set(state.params)
    for name, w in want.items():
        err = float((state.params[name].detach() - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), (name, err)
    assert set(summary) == set(jsummary) and summary
    for key, w in jsummary.items():
        np.testing.assert_allclose(summary[key], w, rtol=1e-6, err_msg=key)


def _params(state):
    return {k: v.detach().clone() for k, v in state.params.items()}


def test_resumed_run_equals_the_uninterrupted_run(splits, tmp_path):
    _, (tr, vl, te), table = splits
    cfg = preset("EasyDGL", **DROP)
    straight, _ = loop.train_model(cfg, tr, vl, te, mark_table=table,
                                   ckpt_dir=str(tmp_path / "a"),
                                   num_epochs=2, device="cpu")
    first, _ = loop.train_model(cfg, tr, vl, te, mark_table=table,
                                ckpt_dir=str(tmp_path / "b"), num_epochs=1,
                                device="cpu")
    assert Checkpointer(str(tmp_path / "b")).latest_step() == first.step == 4
    resumed, _ = loop.train_model(cfg, tr, vl, te, mark_table=table,
                                  ckpt_dir=str(tmp_path / "b"), num_epochs=2,
                                  resume=True, device="cpu")
    assert resumed.step == straight.step == 8
    for name, want in _params(straight).items():
        assert torch.equal(resumed.params[name], want), name
    for field in ("mu", "nu"):
        for name, want in getattr(straight.opt_state, field).items():
            got = getattr(resumed.opt_state, field)[name]
            assert torch.equal(got, want), (field, name)
    assert resumed.opt_state.count == straight.opt_state.count == 8
    # the run's dropout is live: at rate 0 the first epoch trains others
    plain, _ = loop.train_model(preset("EasyDGL", **KW), tr, vl, te,
                                mark_table=table, num_epochs=1,
                                device="cpu")
    assert not torch.equal(plain.params["item_embs.lookup_table"],
                           first.params["item_embs.lookup_table"])


def _train_batches(cfg, model, ds, table, n):
    trl = BatchLoader(ds, data_mode=model.data_mode, batch_size=B,
                      masklen=cfg.masklen, is_training=True,
                      mark_table=table, needs_marks=True)
    return [(f, lab) for f, lab, _ in trl.epoch(0)][:n]


def test_checkpoint_round_trip_restores_into_the_live_model(splits,
                                                            tmp_path):
    _, (tr, _, _), table = splits
    cfg = preset("EasyDGL", **DROP)
    model = build_model(cfg, device="cpu")
    step = build_train_step(model)
    state = init_state(model)
    for f, lab in _train_batches(cfg, model, tr, table, 2):
        state, _ = step(state, f, lab, dropout_generator(0, state.step,
                                                         "cpu"))
    ckpt = Checkpointer(str(tmp_path), max_to_keep=2)
    saved = {k: v.detach().clone() for k, v in model.named_parameters()}
    ckpt.save(state._replace(step=1))
    ckpt.save(state)
    ckpt.save(state, step=7)
    assert ckpt.steps() == [2, 7] and ckpt.latest_step() == 7
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]

    fresh = build_model(cfg.replace(seed=cfg.seed + 1), device="cpu")
    template = init_state(fresh)
    ptrs = {k: p.data_ptr() for k, p in fresh.named_parameters()}
    restored = ckpt.restore(template, step=2)
    assert restored.step == 2 and restored.opt_state.count == 2
    live = dict(fresh.named_parameters())
    for name, want in saved.items():
        assert torch.equal(live[name], want), name
        assert live[name].data_ptr() == ptrs[name], name
        assert restored.params[name] is live[name]
    for name, want in state.opt_state.nu.items():
        assert torch.equal(restored.opt_state.nu[name], want)
    assert ckpt.restore(init_state(fresh)).step == 2   # the latest file

    small = build_model(cfg.replace(num_units=8, num_heads=1), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(init_state(small))


def test_early_stopping_matches_jax_on_a_scripted_run():
    losses = [5.0, 4.0, 4.5, 3.0, 3.5, 3.6, 3.7, float("nan")]
    accs = [0.2, 0.3, 0.25, 0.3, 0.1, 0.1, 0.35, 0.4]
    runs = []
    for cls in (jearly.EarlyStopping, EarlyStopping):
        saves, trail = [], []
        stopper = cls("EasyDGL", patience=3,
                      save_fn=lambda: saves.append(len(trail)))
        metrics = np.random.default_rng(0)
        for loss, acc in zip(losses, accs):
            valid = {"H100": acc, "N10": float(metrics.random())}
            test = {"H100": float(metrics.random()),
                    "N10": float(metrics.random())}
            trail.append((stopper.step(loss, acc, valid, test),
                          stopper.counter, stopper.best_acc,
                          stopper.best_loss))
        runs.append((trail, saves, stopper.summary(), stopper.best_valid))
    assert runs[0] == runs[1]
    trail, saves = runs[1][0], runs[1][1]
    assert [t[0] for t in trail] == [False] * 7 + [True]
    assert saves == [0, 1, 3, 6]


def test_multi_step_equals_single_steps_at_dropout(splits):
    _, (tr, _, _), table = splits
    cfg = preset("EasyDGL", **DROP)
    model = build_model(cfg, device="cpu")
    batches = _train_batches(cfg, model, tr, table, 3)
    w0 = {k: v.detach().clone() for k, v in model.named_parameters()}

    step = build_train_step(model)
    state = init_state(model)
    losses = []
    for f, lab in batches:
        state, loss = step(state, f, lab,
                           dropout_generator(cfg.seed, state.step, "cpu"))
        losses.append(loss)
    single = _params(state)

    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(w0[name])
    multi = build_multi_step(model)
    feats, labels = stack_batches(batches)
    assert feats["seqs_i"].shape == (3, B, L + 1)
    state2, losses2 = multi(init_state(model), feats, labels, cfg.seed)
    assert state2.step == 3 and losses2.shape == (3,)
    assert torch.equal(losses2, torch.stack(losses))
    for name, want in single.items():
        assert torch.equal(state2.params[name], want), name
    # tensors stack as tensors
    tf, tl = stack_batches([({k: torch.as_tensor(v) for k, v in f.items()},
                             torch.as_tensor(lab)) for f, lab in batches])
    assert torch.equal(tf["seqs_i"], torch.as_tensor(feats["seqs_i"]))
    assert torch.equal(tl, torch.as_tensor(labels))


def test_nan_guard_step_timer_and_trace(tmp_path):
    guard = profiler.NanGuard(every=2)
    guard.check(torch.tensor(float("nan")))   # step 1: not checked
    guard.check(torch.tensor(1.0))
    guard.check(torch.tensor(2.0))
    with pytest.raises(FloatingPointError, match="step 4"):
        guard.check(torch.tensor(float("inf")))

    timer = profiler.StepTimer(batch_size=8)
    timer.start()
    timer.tick(3)
    assert timer.examples_per_sec(blocker=torch.ones(2)) > 0
    assert timer.steps == 3

    with profiler.trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any("mm" in e.key for e in prof.key_averages())
    assert any(n.endswith(".json") for n in os.listdir(tmp_path))


def test_grad_norms_match_jax_on_the_same_gradients():
    cfg = preset("EasyDGL", **KW)
    tree = random_flax_params(cfg, seed=3)
    want = jprofiler.grad_norms(jax.tree.map(jnp.asarray, tree))
    got = profiler.grad_norms(flax_to_torch(tree))
    assert set(got) == set(want) == {"params"}
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)


def test_analytics_step_matches_jax(splits):
    """mask_seen ranks only: the logits come back unmasked."""
    (_, _, jte), (_, _, te), table = splits
    cfg = preset("EasyDGL", **KW)
    params = random_flax_params(cfg, seed=1)
    params["params"]["out_bias"]["output_bias"] = np.random.default_rng(
        5).normal(0, 0.5, V).astype(np.float32)
    jm = jbuild(jpreset("EasyDGL", **KW))
    jl = JBatchLoader(jte, data_mode="mau", batch_size=B, is_training=False,
                      mark_table=table, needs_marks=True, use_native=False)
    jf, jlab, jv = next(jl.epoch(0))
    args = (params, {k: jnp.asarray(v) for k, v in jf.items()},
            jnp.asarray(jlab), jnp.asarray(jv))
    jlogits, jsums = jsteps.build_analytics_step(jm).lower(*args).compile(
        compiler_options=AS_WRITTEN)(*args)
    model = build_model(cfg, device="cpu", params=params)
    tl = BatchLoader(te, data_mode="mau", batch_size=B, is_training=False,
                     mark_table=table, needs_marks=True,
                     marks_on_device=True)
    f, lab, v = next(tl.epoch(0))
    assert "seqs_marks" not in f
    logits, sums = build_analytics_step(model, table)(model, f, lab, v)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)
    assert float(logits.min()) > -1e29   # no mask_seen in the logits
    assert set(sums) == set(jsums)
    for key, want in jsums.items():
        np.testing.assert_allclose(float(sums[key]), float(want), rtol=1e-6,
                                   err_msg=key)
    assert math.isclose(float(sums["count"]), B)
