"""PyTorch port: the train and analytics CLIs and
``Recommender.from_checkpoint``, on the CPU (``--device cpu``).

* ``cli.train --synthetic`` then ``cli.analytics`` on its checkpoint, as
  ``tests/test_cli.py`` holds the JAX CLIs: the restored model's test H100
  equals the training summary's to 1e-6 relative (the checkpoint is the
  best validation epoch's, and so is the summary's tracked metric; the
  others follow the reference's first-epoch rule), and every valid test
  row's logits are in the pickle;
* ``Recommender.from_checkpoint`` of a ``train_model`` run, as
  ``tests/test_recommender.py`` holds the JAX one, with EasyDGL: the
  restored model reproduces the summary's test H100 to 1e-6 relative,
  serves what the checkpoint's weights loaded by hand serve, and ranked,
  mask_seen top-k lists;
* the same train and analytics round trip for GRU4REC, S2PNM and
  TiSASREC (one epoch);
* the pipeline-parallel flags and a model missing from the registry
  raise, the context-parallel ones are accepted (``--dp``, ``--mp``,
  ``--cp`` and the multi-process flags run:
  ``tests/test_torch_dist_cli.py``, ``tests/test_torch_context.py``); so
  does ``cli.train`` without ``--device`` raise on a machine without a
  card.

Tiny config: EasyDGL, L = 10, C = 16, H = 2, 1 block, E = 4, B = 16, 64
train rows; V = 201, as in ``tests/test_cli.py``, so that HR@100 is not 1
by construction.
"""
import os
import pickle

import numpy as np
import pytest
import torch

from easydgl_tpu_torch.cli import analytics as analytics_cli
from easydgl_tpu_torch.cli import train as train_cli
from easydgl_tpu_torch.config import preset
from easydgl_tpu_torch.data.loader import BatchLoader
from easydgl_tpu_torch.data.synthetic import (synthetic_mark_table,
                                              synthetic_split)
from easydgl_tpu_torch.eval.recommender import Recommender
from easydgl_tpu_torch.models.registry import build_model
from easydgl_tpu_torch.train.checkpoint import Checkpointer
from easydgl_tpu_torch.train.loop import evaluate, train_model
from easydgl_tpu_torch.train.steps import build_eval_step

torch.set_num_threads(2)
V, L, B, E = 201, 10, 16, 4
TINY = ["--num_items", str(V), "--seqslen", str(L), "--num_units", "16",
        "--num_heads", "2", "--num_blocks", "1", "--batch_size", str(B),
        "--num_events", str(E)]


def test_train_then_analytics_roundtrip(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    summary = train_cli.main([
        "--model", "EasyDGL", "--synthetic", "--synthetic_rows", "64",
        "--num_epochs", "2", "--ckpt_dir", "ckpt", "--device", "cpu",
        *TINY])
    assert np.isfinite(summary["H100"])
    assert os.listdir("ckpt")

    # the CLI's synthetic test split (seed 3) and mark table (seed 4),
    # saved as the JAX package's cli.prep writes them
    synthetic_split(num_rows=64 // 8, seed=3, num_items=V, seqslen=L,
                    with_datetime=True).save(str(tmp_path / "test.npz"))
    np.save(tmp_path / "mark.npy", synthetic_mark_table(V, E, seed=4))
    res = analytics_cli.main([
        "--ckpt", "ckpt", "--model", "EasyDGL", "--data_dir", ".",
        "--mark", "mark.npy", "--out", "res", "--device", "cpu", *TINY])
    assert set(res) == set(summary)
    assert 0 < summary["H100"] < 1
    assert res["H100"] == pytest.approx(summary["H100"], rel=1e-6)

    with open("res", "rb") as f:
        batches = pickle.load(f)
    assert sum(b.shape[0] for b in batches) == 8
    assert all(b.shape[1] == V + 1 and np.isfinite(b).all()
               for b in batches)


@pytest.mark.parametrize("model", ["GRU4REC", "S2PNM", "TiSASREC"])
def test_train_then_analytics_roundtrip_of_more_models(tmp_path, monkeypatch,
                                                       model):
    """The same round trip for the models that read no marks: the CLI
    hands them the synthetic mark table all the same, and they ignore
    it."""
    monkeypatch.chdir(tmp_path)
    summary = train_cli.main([
        "--model", model, "--synthetic", "--synthetic_rows", "64",
        "--num_epochs", "1", "--ckpt_dir", "ckpt", "--device", "cpu",
        *TINY])
    assert 0 < summary["H100"] < 1
    synthetic_split(num_rows=64 // 8, seed=3, num_items=V, seqslen=L,
                    with_datetime=True).save(str(tmp_path / "test.npz"))
    res = analytics_cli.main([
        "--ckpt", "ckpt", "--model", model, "--data_dir", ".", "--out",
        "res", "--device", "cpu", *TINY])
    assert res["H100"] == pytest.approx(summary["H100"], rel=1e-6)


def test_recommend_from_trained_checkpoint(tmp_path):
    cfg = preset("EasyDGL", num_items=V, seqslen=L, num_units=16,
                 num_heads=2, num_blocks=1, num_events=E, batch_size=B,
                 patience=100, mask_seen=True)
    table = synthetic_mark_table(V, E, seed=0)
    tr = synthetic_split(num_rows=64, num_items=V, seqslen=L, seed=1)
    vl = synthetic_split(num_rows=16, num_items=V, seqslen=L, seed=2)
    te = synthetic_split(num_rows=16, num_items=V, seqslen=L, seed=3)
    _, summary = train_model(cfg, tr, vl, te, mark_table=table,
                             ckpt_dir=str(tmp_path), num_epochs=2,
                             device="cpu")
    head = {k: v[:4] for k, v in te.arrays.items()}
    rec = Recommender.from_checkpoint(cfg, str(tmp_path), head, table,
                                      device="cpu")
    loader = BatchLoader(te, data_mode=rec.model.data_mode, batch_size=B,
                         is_training=False, mark_table=table,
                         needs_marks=True)
    got = evaluate(build_eval_step(rec.model), rec.model, loader, "cpu")
    assert 0 < summary["H100"] < 1
    assert got["H100"] == pytest.approx(summary["H100"], rel=1e-6)

    ckpt = Checkpointer(str(tmp_path))
    saved = torch.load(ckpt.path(ckpt.latest_step()), weights_only=True)
    by_hand = build_model(cfg, device="cpu")
    by_hand.load_state_dict(saved["params"])
    ids, scores = rec.recommend(head, k=10)
    want_ids, want_scores = Recommender(cfg, by_hand, table).recommend(
        head, k=10)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(scores, want_scores)
    assert ids.shape == scores.shape == (4, 10)
    assert (ids > 0).all()   # padding item never recommended (bias -1000)
    assert (scores[:, :-1] >= scores[:, 1:]).all()
    features, _ = rec.protocol(head, False, None)
    for r in range(4):
        assert not set(ids[r]) & set(features["seqs_i"][r].tolist())


@pytest.mark.parametrize("flags", [
    ["--cp", "2"], ["--pp", "2"], ["--pp_microbatches", "4"],
    ["--cp_impl", "ulysses"]])
def test_multi_device_flags_raise(tmp_path, monkeypatch, flags):
    """The pipeline-parallel flags raise (ROADMAP A.3b). The
    context-parallel ones are accepted: ``--cp 2`` asks for a seq axis of
    two ranks and so stops at the mesh of this one-process world (its
    training runs in ``tests/test_torch_context.py`` over four ranks);
    ``--cp_impl ulysses`` without it trains on one device."""
    monkeypatch.chdir(tmp_path)
    argv = ["--model", "EasyDGL", "--synthetic", "--synthetic_rows", "16",
            "--num_epochs", "1", "--device", "cpu", *TINY, *flags]
    if flags[0].startswith("--pp"):
        with pytest.raises(NotImplementedError, match="ROADMAP A.3b"):
            train_cli.main(argv)
    elif flags[0] == "--cp":
        try:
            with pytest.raises(ValueError, match="not divisible by cp=2"):
                train_cli.main(argv)
        finally:
            import torch.distributed as dist
            if dist.is_initialized():
                dist.destroy_process_group()
    else:
        assert np.isfinite(train_cli.main(argv)["H100"])


def test_unported_model_raises(tmp_path, monkeypatch):
    """Every preset's model is ported, so the registry is made to lack
    one: the CLI then refuses it by name."""
    from easydgl_tpu_torch.models import registry
    monkeypatch.delitem(registry.MODELS, "GREC")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="GREC"):
        train_cli.main(["--model", "GREC", "--synthetic",
                        "--synthetic_rows", "16", "--num_epochs", "1",
                        "--device", "cpu", *TINY])


def test_train_cli_without_device_needs_a_card(tmp_path, monkeypatch):
    """The default device is cuda, and nothing falls back to the CPU."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train_cli.main(["--model", "EasyDGL", "--synthetic",
                        "--synthetic_rows", "16", "--num_epochs", "1",
                        *TINY])
