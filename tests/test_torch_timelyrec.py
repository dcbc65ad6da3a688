"""PyTorch port: TimelyREC (serving and the train step) vs the JAX package,
on the CPU, with its user tower's ``attention_impl`` ``"xla"`` (the
preset's); the ``"flash"`` form is held in ``test_torch_timelyrec_flash.py``
(one file each, so that each stays near 30 s: most of their time is JAX
running the model op by op).

TimelyREC (C = 16, H = 2, L = 12, B = 4, the preset's window ratio 0.2
and time_scale of a day) through ``torch_model_checks``: eval logits to
1e-4, eval-step sums and ``recommend``, one train step (loss 1e-5
relative, every gradient to 1e-4 of its leaf's scale, the 0-d
``te_weight`` among them, the TF-Adam update), the random param tree,
the weight and TF-Adam bridges' round trip (the 0-d leaf kept 0-d). The
split is ETL-style: a padded position's month and day are 0, so the month
and day lookups get -1, which both sides clamp to row 0. The JAX side runs
op by op (its jitted CPU program divides the stamps by time_scale as a
product with the fp32 reciprocal). JAX adds the per-row sinusoid bias to
its materialised training logits; the port's catalog NLL skips that
shift, which leaves the NLL unchanged. Plus a ``cli.train --synthetic``
and ``cli.analytics`` round trip, ``Recommender.from_checkpoint`` on its
checkpoint; the modules are held in
``test_torch_cnn_mate.py``.
"""
import pytest
import torch

from easydgl_tpu_torch.cli import analytics as analytics_cli
from easydgl_tpu_torch.cli import train as train_cli
from easydgl_tpu_torch.config import preset
from easydgl_tpu_torch.data.synthetic import synthetic_split
from torch_model_checks import (check_bridges, check_eval_logits,
                                check_eval_step_and_recommend,
                                check_from_checkpoint,
                                check_random_tree, check_step, etl_pads,
                                make_world, port)

torch.set_num_threads(2)
SMALL = dict(num_items=50, seqslen=12, num_units=16, num_heads=2,
             batch_size=4, hidden_dropout_rate=0.0,
             attention_probs_dropout_rate=0.0, l2_reg=1e-4)


@pytest.fixture(scope="module")
def world():
    return make_world("TimelyREC", dict(SMALL, attention_impl="xla"), 7,
                      op_by_op=True, data=etl_pads)


def test_timelyrec_eval_logits_match_jax(world):
    check_eval_logits(world)


def test_timelyrec_eval_step_and_recommend_match_jax(world):
    check_eval_step_and_recommend(world)


def test_timelyrec_train_step_matches_jax(world):
    check_step(world, port(world))
    assert world["grads"]["te_weight"].shape == ()


def test_timelyrec_random_tree_matches_jax_layout(world):
    check_random_tree(world)


def test_timelyrec_bridges_round_trip(world):
    check_bridges(world)


def test_timelyrec_cli_train_then_analytics_roundtrip(tmp_path, monkeypatch):
    """``cli.train --synthetic`` (the datetime fields) for one epoch, then
    ``cli.analytics`` on its checkpoint, whose 0-d ``te_weight`` it
    restores: the test H100 equals the summary's."""
    monkeypatch.chdir(tmp_path)
    tiny = ["--num_items", "201", "--seqslen", "10", "--num_units", "16",
            "--num_heads", "2", "--batch_size", "16", "--model",
            "TimelyREC", "--device", "cpu"]
    summary = train_cli.main(["--synthetic", "--synthetic_rows", "64",
                              "--num_epochs", "1", "--ckpt_dir", "ckpt",
                              *tiny])
    assert 0 < summary["H100"] < 1
    synthetic_split(num_rows=64 // 8, seed=3, num_items=201, seqslen=10,
                    with_datetime=True).save(str(tmp_path / "test.npz"))
    res = analytics_cli.main(["--ckpt", "ckpt", "--data_dir", ".", "--out",
                              "res", *tiny])
    assert res["H100"] == pytest.approx(summary["H100"], rel=1e-6)
    check_from_checkpoint(preset("TimelyREC", num_items=201, seqslen=10,
                                 num_units=16, batch_size=16, num_heads=2),
                          "ckpt")
