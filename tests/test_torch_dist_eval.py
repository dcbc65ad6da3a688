"""PyTorch port: the distributed full-catalog eval over gloo against the
JAX package's single-device eval, on the CPU.

EasyDGL (C = 16, H = 2, 1 block, E = 4, L = 8, ``mask_seen``) on a (2, 2)
world of CPU ranks (``torch_dist_workers.run_world``): each rank scores its
8 of the batch's 16 rows against its slice of the catalog, the top-100 is
the exact distributed merge and the sums are added over the data axis.

* V = 64 (32 ids a model rank): ``build_distributed_eval_step``;
* V = 63 (odd, so the catalog stays whole on every rank):
  ``build_sharded_eval_step``, each rank ranking its rows against the
  whole catalog.

Every rank's sums equal JAX ``build_eval_step``'s on the whole batch: the
count and the hit counts exactly, the NDCG sums to 1e-6 relative (the
gain 1/log2(rank + 2) is fp32 on both sides, the sum's order differs:
each data shard's rows are summed first), and so do the port's own
single-device eval step's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easydgl_tpu.config import preset as jpreset
from easydgl_tpu.data.loader import BatchLoader as JBatchLoader
from easydgl_tpu.data.synthetic import synthetic_mark_table, synthetic_split
from easydgl_tpu.models.registry import build_model as jbuild
from easydgl_tpu.train import steps as jsteps
from easydgl_tpu_torch.config import preset
from easydgl_tpu_torch.models.registry import build_model
from easydgl_tpu_torch.parity import random_flax_params
from easydgl_tpu_torch.train.steps import build_eval_step
from torch_dist_workers import run_world

torch.set_num_threads(2)


CASES = {63: True, 62: False}     # num_items: the distributed route


def _case(num_items):
    kw = dict(num_items=num_items, seqslen=8, num_units=16, num_heads=2,
              num_blocks=1, num_events=4, masklen=3, batch_size=16,
              mask_seen=True)
    cfg = preset("EasyDGL", **kw)
    params = random_flax_params(cfg, seed=0)
    params["params"]["out_bias"]["output_bias"] = np.random.default_rng(
        5).normal(0, 0.5, num_items).astype(np.float32)
    ds = synthetic_split(num_rows=16, num_items=num_items, seqslen=8,
                         seed=9)
    mark = synthetic_mark_table(num_items, 4, seed=2)
    ld = JBatchLoader(ds, data_mode="mau", batch_size=16, masklen=3,
                      is_training=False, mark_table=mark, needs_marks=True,
                      use_native=False)
    features, labels, valid = next(ld.epoch(0))
    valid = valid.copy()
    valid[-1] = False                     # a padded row counts nowhere
    return dict(model="EasyDGL", cfg=kw, params=params,
                batch=(features, labels, valid))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both cases' payloads and every rank's sums, from one world of four
    ranks."""
    jobs = {n: ("w_eval", _case(n)) for n in CASES}
    res = run_world("w_many", jobs, 2, 2, tmp_path_factory.mktemp("eval"))
    return {n: (jobs[n][1], [r[n] for r in res]) for n in CASES}


@pytest.mark.parametrize("num_items", list(CASES))
def test_eval_sums_match_jax_single_device(world, num_items):
    p, res = world[num_items]
    features, labels, valid = p["batch"]
    jm = jbuild(jpreset("EasyDGL").replace(use_pallas=False, **p["cfg"]))
    want = {k: float(v) for k, v in jsteps.build_eval_step(jm)(
        p["params"], {k: jnp.asarray(v) for k, v in features.items()},
        jnp.asarray(labels), jnp.asarray(valid)).items()}
    mine = build_model(preset("EasyDGL", **p["cfg"]), device="cpu",
                       params=p["params"])
    single = {k: float(v) for k, v in build_eval_step(mine)(
        mine, features, labels, valid).items()}
    assert want["count"] == 15.0
    assert 0.0 < want["H10"] < want["count"]
    for r in res:
        assert r["distributed"] is CASES[num_items]
        assert set(r["sums"]) == set(want)
        for k, w in want.items():
            got = r["sums"][k]
            if k.startswith("N"):
                assert got == pytest.approx(w, rel=1e-6), k
                assert got == pytest.approx(single[k], rel=1e-6), k
            else:
                assert got == w == single[k], k
