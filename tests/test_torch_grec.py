"""PyTorch port: GREC (serving and the train step) vs the JAX package, on
the CPU.

GREC (C = 16, L = 12, 2 dilations (1, 2), filter width 3, B = 4, masklen
6) through ``torch_model_checks``: eval logits to 1e-4 (the id-0 and last
columns at -1000), eval-step sums and ``recommend`` (never id 0 nor the
last id), one train step of the ``grec`` loss (the row-masked mean CE plus
0.001 times the mean over parameter tensors of 0.5 sum(w^2); loss 1e-5
relative, every gradient to 1e-4 of its leaf's scale, the TF-Adam
update), the random param tree, the weight and TF-Adam bridges' round
trip (its 3-D convolution weights); the divisor of that mean, the leaf count
of the JAX param tree, at the preset's four dilations (72); a
``cli.train --synthetic`` plus ``cli.analytics`` round trip and
``Recommender.from_checkpoint`` on its checkpoint. The JAX side
runs jitted (GREC reads no timestamps). Weights come from JAX ``init``
with non-zero biases; the modules are held in ``test_torch_cnn_mate.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easydgl_tpu.config import preset as jpreset
from easydgl_tpu.models.registry import build_model as jbuild
from easydgl_tpu_torch.cli import analytics as analytics_cli
from easydgl_tpu_torch.cli import train as train_cli
from easydgl_tpu_torch.config import preset
from easydgl_tpu_torch.data.synthetic import synthetic_split
from easydgl_tpu_torch.models.registry import build_model
from easydgl_tpu_torch.parity import random_flax_params
from easydgl_tpu_torch.train.steps import l2_mean_all
from torch_model_checks import (check_bridges, check_eval_logits,
                                check_eval_step_and_recommend,
                                check_from_checkpoint,
                                check_random_tree, check_step, make_world,
                                port, tfeats)

torch.set_num_threads(2)
SMALL = dict(num_items=50, seqslen=12, num_units=16, batch_size=4,
             dilations=(1, 2), filter_width=3)


@pytest.fixture(scope="module")
def world():
    return make_world("GREC", SMALL, 7)


def test_grec_eval_logits_match_jax(world):
    check_eval_logits(world)
    with torch.no_grad():
        got, _ = port(world)(tfeats(world["eval"][0]))
    assert got.shape[1] == SMALL["num_items"] + 2
    assert (got[:, 0] == -1000.0).all() and (got[:, -1] == -1000.0).all()


def test_grec_eval_step_and_recommend_match_jax(world):
    check_eval_step_and_recommend(world)
    from easydgl_tpu_torch.eval.recommender import Recommender
    model = port(world)
    arrays = {k: v[:4] for k, v in world["ds"].arrays.items()}
    ids, _ = Recommender(model.cfg, model).recommend(arrays, k=20)
    assert not ((ids == 0) | (ids == SMALL["num_items"] + 1)).any()


def test_grec_train_step_matches_jax(world):
    check_step(world, port(world))


def test_grec_random_tree_matches_jax_layout(world):
    check_random_tree(world)


def test_grec_bridges_round_trip(world):
    check_bridges(world)


def test_grec_l2_mean_counts_the_jax_leaves():
    """At the preset's four dilations (1, 4, 1, 4): 2 tables, 8 leaves in
    each of the 8 MaskedCNNs, 4 of the projector, 2 of the head = 72, the
    divisor of JAX's ``l2_mean_all``; the port's parameters are as many,
    and its mean equals JAX's on the same weights."""
    kw = dict(num_items=50, seqslen=12, num_units=16)
    cfg = preset("GREC", **kw)
    assert cfg.dilations == (1, 4, 1, 4)
    jm = jbuild(jpreset("GREC").replace(use_pallas=False, **kw))
    ids = jnp.ones((2, 12), jnp.int32)
    params = jax.tree.map(np.asarray, jm.init(
        {"params": jax.random.key(0)}, {"seqs_i": ids, "seqs_m": ids},
        is_training=False))
    assert len(jax.tree_util.tree_leaves(params)) == 72
    model = build_model(cfg, device="cpu", params=params)
    named = dict(model.named_parameters())
    assert len(named) == 72
    from easydgl_tpu.train.steps import l2_mean_all as jl2_mean_all
    np.testing.assert_allclose(float(l2_mean_all(named).detach()),
                               float(jl2_mean_all(params)), rtol=1e-6)
    assert len(jax.tree_util.tree_leaves(random_flax_params(cfg, 0))) == 72


def test_grec_cli_train_then_analytics_roundtrip(tmp_path, monkeypatch):
    """``cli.train --synthetic`` for one epoch (the preset's four
    dilations), then ``cli.analytics`` on its checkpoint: the restored
    model's test H100 equals the summary's."""
    monkeypatch.chdir(tmp_path)
    tiny = ["--num_items", "201", "--seqslen", "10", "--num_units", "16",
            "--batch_size", "16", "--model", "GREC", "--device", "cpu"]
    summary = train_cli.main(["--synthetic", "--synthetic_rows", "64",
                              "--num_epochs", "1", "--ckpt_dir", "ckpt",
                              *tiny])
    assert 0 < summary["H100"] < 1
    synthetic_split(num_rows=64 // 8, seed=3, num_items=201, seqslen=10,
                    with_datetime=True).save(str(tmp_path / "test.npz"))
    res = analytics_cli.main(["--ckpt", "ckpt", "--data_dir", ".", "--out",
                              "res", *tiny])
    assert res["H100"] == pytest.approx(summary["H100"], rel=1e-6)
    check_from_checkpoint(preset("GREC", num_items=201, seqslen=10,
                                 num_units=16, batch_size=16), "ckpt")
