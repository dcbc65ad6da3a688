"""PyTorch port: the copied data modules give byte-identical arrays to the
JAX package's for the same seed."""
import numpy as np
import pytest
import torch

from easydgl_tpu.data import loader as jloader
from easydgl_tpu.data import masking as jmasking
from easydgl_tpu.data import synthetic as jsynthetic
from easydgl_tpu_torch.data import loader, masking, synthetic

torch.set_num_threads(2)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _same_dict(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        _same(a[k], b[k])


def test_synthetic_generators_identical():
    kw = dict(num_rows=9, num_items=50, seqslen=12, seed=3)
    _same_dict(synthetic.synthetic_split(**kw, with_datetime=True).arrays,
               jsynthetic.synthetic_split(**kw, with_datetime=True).arrays)
    _same_dict(synthetic.synthetic_split_vectorized(**kw).arrays,
               jsynthetic.synthetic_split_vectorized(**kw).arrays)
    _same(synthetic.synthetic_mark_table(50, 6, seed=2),
          jsynthetic.synthetic_mark_table(50, 6, seed=2))


@pytest.mark.parametrize("mode", ["masked", "mau", "grec", "regressive",
                                  "regressive_entire", "regressive_datetime"])
@pytest.mark.parametrize("is_training", [True, False])
def test_masking_protocols_identical(mode, is_training):
    arrays = jsynthetic.synthetic_split(num_rows=6, num_items=30, seqslen=10,
                                        seed=1, with_datetime=True).arrays
    mine = masking.make_protocol(mode, masklen=3, mask_id=30)
    theirs = jmasking.make_protocol(mode, masklen=3, mask_id=30)
    f1, l1 = mine(arrays, is_training, np.random.default_rng(8))
    f2, l2 = theirs(arrays, is_training, np.random.default_rng(8))
    _same_dict(f1, f2)
    _same(l1, l2)


@pytest.mark.parametrize("is_training", [True, False])
def test_batch_loader_identical_with_marks_and_host_shards(is_training):
    ds = jsynthetic.synthetic_split(num_rows=11, num_items=30, seqslen=8,
                                    seed=4)
    table = jsynthetic.synthetic_mark_table(30, 4, seed=1)
    for host in (0, 1):
        kw = dict(data_mode="mau", batch_size=4, masklen=3,
                  is_training=is_training, seed=5, host_id=host, num_hosts=2,
                  mark_table=table, needs_marks=True)
        mine = loader.BatchLoader(loader.PackedDataset(ds.arrays, 30),
                                  use_native=False, **kw)
        theirs = jloader.BatchLoader(ds, use_native=False, **kw)
        assert mine.num_batches() == theirs.num_batches()
        for epoch in (0, 1):
            got = list(mine.epoch(epoch))
            want = list(theirs.epoch(epoch))
            assert len(got) == len(want)
            for (f1, l1, v1), (f2, l2, v2) in zip(got, want):
                _same_dict(f1, f2)
                _same(l1, l2)
                _same(v1, v2)
