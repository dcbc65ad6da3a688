"""PyTorch port: ``cli.train --dp 2 --mp 2`` over four gloo ranks on the
CPU, and its checkpoint on one device.

Each of four processes (``torch_dist_workers.run_world``) runs
``cli.train --device cpu --dp 2 --mp 2`` with the explicit multi-process
flags: EasyDGL at ``tests/test_torch_cli.py``'s tiny config (V = 202 rows,
101 a model rank; H = 2, one head a rank; B = 16, 8 a data rank), 2
epochs with a checkpoint, then 1 more with ``--resume``, which restores the
whole state and shards it again. Then, in this process:

* every rank's summary is the same, and the resumed run's step count
  continues from the checkpoint's;
* the checkpoint holds the single-device layout (the whole table);
* one-process ``cli.analytics`` restores it and reports the summary's
  test H100 to 1e-6 relative (the summary's sums were added over the data
  axis first), and ``Recommender.from_checkpoint`` serves from it.
"""
import os

import numpy as np
import pytest
import torch

from easydgl_tpu_torch.cli import analytics as analytics_cli
from easydgl_tpu_torch.config import preset
from easydgl_tpu_torch.data.synthetic import (synthetic_mark_table,
                                              synthetic_split)
from easydgl_tpu_torch.eval.recommender import Recommender
from easydgl_tpu_torch.train.checkpoint import Checkpointer
from torch_dist_workers import run_world

torch.set_num_threads(2)
V, L, B, E = 201, 10, 16, 4
TINY = ["--num_items", str(V), "--seqslen", str(L), "--num_units", "16",
        "--num_heads", "2", "--num_blocks", "1", "--batch_size", str(B),
        "--num_events", str(E)]
TRAIN = ["--model", "EasyDGL", "--synthetic", "--synthetic_rows", "64",
         "--ckpt_dir", "ckpt", "--device", "cpu", "--dp", "2", "--mp", "2",
         *TINY]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_cli")
    first = run_world("w_cli", dict(cwd=str(root), argv=TRAIN + [
        "--num_epochs", "2"]), 2, 2, root / "first")
    steps = Checkpointer(str(root / "ckpt")).latest_step()
    resumed = run_world("w_cli", dict(cwd=str(root), argv=TRAIN + [
        "--num_epochs", "3", "--resume"]), 2, 2, root / "resumed")
    return root, first, resumed, steps


def test_dist_cli_trains_on_four_ranks_and_resumes(trained):
    root, first, resumed, steps = trained
    for res in (first, resumed):
        assert all(r == res[0] for r in res[1:])
        assert 0 < res[0]["H100"] < 1
    # 64 rows over 2 data shards at 8 rows a step: 4 steps an epoch
    assert steps in (4, 8)
    ckpt = Checkpointer(str(root / "ckpt"))
    assert steps < ckpt.latest_step() <= 12
    saved = torch.load(ckpt.path(ckpt.latest_step()), weights_only=True)
    assert tuple(saved["params"]["item_embs.lookup_table"].shape) == (V + 1,
                                                                      16)
    assert tuple(saved["opt_state"]["mu"]["item_embs.lookup_table"].shape) \
        == (V + 1, 16)


def test_dist_checkpoint_restores_on_one_device(trained, monkeypatch):
    root, _, resumed, _ = trained
    monkeypatch.chdir(root)
    synthetic_split(num_rows=64 // 8, seed=3, num_items=V, seqslen=L,
                    with_datetime=True).save(str(root / "test.npz"))
    np.save(root / "mark.npy", synthetic_mark_table(V, E, seed=4))
    res = analytics_cli.main([
        "--ckpt", "ckpt", "--model", "EasyDGL", "--data_dir", ".",
        "--mark", "mark.npy", "--out", "res", "--device", "cpu", *TINY])
    assert res["H100"] == pytest.approx(resumed[0]["H100"], rel=1e-6)
    cfg = preset("EasyDGL", num_items=V, seqslen=L, num_units=16,
                 num_heads=2, num_blocks=1, num_events=E, batch_size=B)
    head = synthetic_split(num_rows=4, seed=3, num_items=V, seqslen=L,
                           with_datetime=True).arrays
    rec = Recommender.from_checkpoint(cfg, str(root / "ckpt"), head,
                                      synthetic_mark_table(V, E, seed=4),
                                      device="cpu")
    ids, scores = rec.recommend(head, k=5)
    assert ids.shape == (4, 5) and (ids > 0).all()
    assert os.path.exists(root / "res")
