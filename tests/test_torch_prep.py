"""PyTorch port: the data-prep path (``data/etl.py``, ``cli/prep.py``) and
the native C++ batcher (``data/native.py`` over ``native/batcher.cpp``)
against the JAX package's, on the CPU.

* ``prepare`` (split CSVs, with and without the datetime fields),
  ``prepare_raw`` (raw triplets: filter, user holdout, dense renumbering)
  and ``mark_table_from_csv``: every packed array equal to JAX's on the
  same small CSVs; ``cli.prep --raw --mark_csv`` writes what JAX's CLI
  writes, and ``cli.train --data_dir`` trains on it;
* the batcher, built with g++ into a temporary directory: the contract of
  ``tests/test_data.py::test_native_loader_contract`` (distinct positions
  past the ignored head, the MASK id written, replays equal, epochs
  differ), and batches equal to JAX's ``data/native.py`` loaded from that
  same ``.so`` on the same seeds (JAX's ``_lib_path`` redirected inside the
  test); its gathers equal NumPy's; ``use_native=True`` raises where the
  library cannot be built, and the default uses it only where it is built.
"""
import os

import numpy as np
import pandas as pd
import pytest

from easydgl_tpu.cli import prep as jprep_cli
from easydgl_tpu.data import etl as jetl
from easydgl_tpu.data import native as jnative
from easydgl_tpu.data.loader import BatchLoader as JBatchLoader
from easydgl_tpu.data.loader import PackedDataset as JPackedDataset
from easydgl_tpu_torch.cli import prep as prep_cli
from easydgl_tpu_torch.cli import train as train_cli
from easydgl_tpu_torch.data import etl, native
from easydgl_tpu_torch.data.loader import BatchLoader, PackedDataset
from easydgl_tpu_torch.data.synthetic import (synthetic_mark_table,
                                              synthetic_split)

SPLITS = ("train", "validation", "test")


def triplets(seed, users=40, items=12):
    """Raw (uid, sid, time) rows: 6-14 events a user an hour apart."""
    rng = np.random.default_rng(seed)
    rows = []
    for uid in range(users):
        t0 = 1e9 + uid * 86400 * 7
        for j in range(int(rng.integers(6, 15))):
            rows.append((uid, int(rng.integers(0, items)), t0 + j * 3600))
    return pd.DataFrame(rows, columns=["uid", "sid", "time"])


def split_csvs(root, seed):
    """The reference's prepared split CSVs (use_ID, ite_ID, time)."""
    df = triplets(seed).rename(columns={"uid": "use_ID", "sid": "ite_ID"})
    df["ite_ID"] += 1
    users = df["use_ID"].unique()
    parts = {"train": users[:24], "validation_tr": users[24:28],
             "validation_te": users[28:32], "test_tr": users[32:36],
             "test_te": users[36:]}
    root.mkdir(parents=True, exist_ok=True)
    for name, us in parts.items():
        df[df["use_ID"].isin(us)].to_csv(root / f"{name}.csv", index=False)
    return root


def marks_csv(path, num_items, seed=3):
    rng = np.random.default_rng(seed)
    sid = rng.integers(0, num_items, 60)
    pd.DataFrame({"sid": sid, "event": rng.integers(0, 5, 60)}).to_csv(
        path, index=False)
    return path


def same_splits(a, b):
    for name in SPLITS:
        got = PackedDataset.load(os.path.join(a, f"{name}.npz"))
        want = JPackedDataset.load(os.path.join(b, f"{name}.npz"))
        assert got.num_items == want.num_items
        assert set(got.arrays) == set(want.arrays)
        for k, v in want.arrays.items():
            assert got.arrays[k].dtype == v.dtype, (name, k)
            np.testing.assert_array_equal(got.arrays[k], v, err_msg=k)


@pytest.mark.parametrize("with_datetime", [True, False])
def test_prepare_matches_jax(tmp_path, with_datetime):
    fin = split_csvs(tmp_path / "csv", seed=1)
    kw = dict(seqslen=8, with_datetime=with_datetime)
    n = etl.prepare(str(fin), str(tmp_path / "port"), **kw)
    assert n == jetl.prepare(str(fin), str(tmp_path / "jax"), **kw)
    same_splits(tmp_path / "port", tmp_path / "jax")


@pytest.mark.parametrize("seed", [0, 1])
def test_prepare_raw_matches_jax(tmp_path, seed):
    fin = tmp_path / "raw.csv"
    triplets(seed).to_csv(fin, index=False)
    kw = dict(seqslen=8, min_uc=3, min_sc=5, n_heldout_users=8)
    n = etl.prepare_raw(str(fin), str(tmp_path / "port"), **kw)
    assert n == jetl.prepare_raw(str(fin), str(tmp_path / "jax"), **kw)
    same_splits(tmp_path / "port", tmp_path / "jax")


def test_mark_table_matches_jax(tmp_path):
    path = marks_csv(tmp_path / "marks.csv", 13)
    got = etl.mark_table_from_csv(str(path), 13)
    want = jetl.mark_table_from_csv(str(path), 13)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert not got[0].any()


def test_cli_prep_round_trip(tmp_path, monkeypatch):
    """cli.prep --raw --mark_csv writes JAX's CLI's files; cli.train
    --data_dir --mark trains EasyDGL one epoch on them."""
    fin = tmp_path / "raw.csv"
    triplets(4).to_csv(fin, index=False)
    flags = ["--raw", "--fin", str(fin), "--seqslen", "8", "--min_uc", "3",
             "--min_sc", "5", "--n_heldout_users", "8"]
    first = jprep_cli.main(flags + ["--fout", str(tmp_path / "jax")])
    assert first is None   # JAX's main logs, returns nothing
    n = prep_cli.main(flags + ["--fout", str(tmp_path / "port")])
    marks = marks_csv(tmp_path / "marks.csv", n)
    for out, main in (("port", prep_cli.main), ("jax", jprep_cli.main)):
        main(flags + ["--fout", str(tmp_path / out), "--mark_csv",
                      str(marks)])
    same_splits(tmp_path / "port", tmp_path / "jax")
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "mark.npy"),
                                  np.load(tmp_path / "jax" / "mark.npy"))
    monkeypatch.chdir(tmp_path)
    summary = train_cli.main([
        "--model", "EasyDGL", "--data_dir", str(tmp_path / "port"),
        "--mark", str(tmp_path / "port" / "mark.npy"), "--num_items",
        str(n), "--seqslen", "8", "--num_units", "8", "--num_heads", "2",
        "--num_blocks", "1", "--batch_size", "8", "--num_epochs", "1",
        "--masklen", "2", "--device", "cpu", "--native", "off"])
    assert np.isfinite(summary["H10"])


# ---------------------------------------------------------------- native


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The batcher built with g++ into a temporary directory; the port's
    and JAX's bindings both pointed at it for the module's tests."""
    lib_dir = tmp_path_factory.mktemp("native")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "LIB_DIR", str(lib_dir))
        mp.setattr(native, "_LIB", None)
        native.load_library(build=True)
        mp.setattr(jnative, "_lib_path", native.library_path)
        mp.setattr(jnative, "_LIB", None)
        mp.setattr(jnative, "_TRIED", False)
        assert jnative.available()
        yield native.library_path()


MODES = (("masked", 0), ("mau", 1), ("grec", 1))


@pytest.mark.parametrize("mode,ignore", MODES)
def test_native_loader_contract(built, mode, ignore):
    ds = synthetic_split(num_rows=32, num_items=50, seqslen=10, seed=3)
    table = synthetic_mark_table(50, 6, seed=1)
    ld = BatchLoader(ds, data_mode=mode, batch_size=8, masklen=3,
                     is_training=True, mark_table=table,
                     needs_marks=(mode == "mau"), use_native=True)
    assert ld.native
    f, labels, _ = next(ld.epoch(0))
    if mode == "grec":
        pos, masked = f["masked_positions"] + 1, f["seqs_m"]
    else:
        pos, masked = f["masked_positions"], f["seqs_i"]
    for r in range(8):
        assert len(set(pos[r].tolist())) == 3
        assert (pos[r] >= ignore).all()
        assert (masked[r, pos[r]] == 50).all()
    f2, _, _ = next(ld.epoch(0))
    np.testing.assert_array_equal(f2["seqs_i"], f["seqs_i"])
    f3, _, _ = next(ld.epoch(1))
    assert (f3["seqs_i"] != f["seqs_i"]).any()


@pytest.mark.parametrize("mode,training", [
    ("masked", True), ("mau", True), ("grec", True), ("mau", False),
    ("regressive", True)])
def test_native_batches_equal_jax(built, mode, training):
    """Every batch of an epoch (the zero-padded tail included) equals
    JAX's native loader's on the same seeds, marks too."""
    ds = synthetic_split(num_rows=37, num_items=50, seqslen=10, seed=4)
    table = synthetic_mark_table(50, 6, seed=2)
    kw = dict(data_mode=mode, batch_size=8, masklen=3, is_training=training,
              mark_table=table, needs_marks=(mode == "mau"),
              host_id=1, num_hosts=2, use_native=True)
    got = list(BatchLoader(ds, **kw).epoch(2))
    want = list(JBatchLoader(JPackedDataset(ds.arrays, ds.num_items),
                             **kw).epoch(2))
    assert len(got) == len(want) == 3
    for (gf, gl, gv), (wf, wl, wv) in zip(got, want):
        assert set(gf) == set(wf)
        for k in wf:
            np.testing.assert_array_equal(gf[k], wf[k], err_msg=k)
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(gv, wv)


def test_native_gathers_equal_numpy(built):
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 20, 9)
    for src in (rng.integers(0, 99, (20, 7)).astype(np.int32),
                rng.normal(size=(20, 7)).astype(np.float32),
                rng.integers(0, 9, (20, 7)).astype(np.int64)):
        np.testing.assert_array_equal(native.gather_rows(src, idx), src[idx])
    table = synthetic_mark_table(30, 5, seed=0)
    ids = rng.integers(0, 40, (4, 6)).astype(np.int32)  # some past the table
    want = table[np.where(ids >= 30, 0, ids)].astype(np.float32)
    np.testing.assert_array_equal(native.mark_gather(table, ids), want)


def test_default_takes_the_branch_jax_takes(built, monkeypatch, tmp_path):
    """use_native=None follows JAX's rule whatever the checkout holds: the
    port's own build (``built``) leaves the default on NumPy while JAX's
    probe finds nothing, and a library where both probe switches both to
    it; the masked train batches stay equal either way."""
    ds = synthetic_split(num_rows=16, num_items=50, seqslen=10, seed=3)
    kw = dict(data_mode="masked", batch_size=8, masklen=3, is_training=True)
    for path in (str(tmp_path / "none.so"), built):
        monkeypatch.setattr(native, "MAKE_PATH", path)
        monkeypatch.setattr(jnative, "_lib_path", lambda p=path: p)
        monkeypatch.setattr(jnative, "_LIB", None)
        monkeypatch.setattr(jnative, "_TRIED", False)
        mine = BatchLoader(ds, **kw)
        theirs = JBatchLoader(JPackedDataset(ds.arrays, ds.num_items), **kw)
        assert mine.native == theirs.native == (path == built)
        (f, lab, _), (jf, jlab, _) = next(mine.epoch(0)), next(
            theirs.epoch(0))
        for k in jf:
            np.testing.assert_array_equal(f[k], jf[k], err_msg=k)
        np.testing.assert_array_equal(lab, jlab)


def test_use_native_raises_where_the_library_cannot_build(tmp_path,
                                                          monkeypatch):
    """No quiet fallback: use_native=True with a compiler that does not
    exist raises; the default then takes the NumPy path."""
    monkeypatch.setattr(native, "LIB_DIR", str(tmp_path / "lib"))
    monkeypatch.setattr(native, "MAKE_PATH", str(tmp_path / "none.so"))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    ds = synthetic_split(num_rows=16, num_items=50, seqslen=10, seed=3)
    with pytest.raises(RuntimeError, match="native batcher"):
        BatchLoader(ds, data_mode="masked", batch_size=8, is_training=True,
                    use_native=True)
    assert not native.available()
    assert not BatchLoader(ds, data_mode="masked", batch_size=8,
                           is_training=True).native
    assert not os.listdir(tmp_path / "lib")     # no partial library left
