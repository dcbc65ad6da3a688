"""Offline ETL: triplet CSVs -> packed .npz splits (a copy of
``easydgl_tpu.data.etl``, writing the port's ``PackedDataset``; NumPy and
pandas, no device).

Replaces the reference's TFRecord writer (data/linkpred.py) with packed
arrays. Semantics preserved:
* filter users/items by min counts (linkpred.py:51-63);
* per-user sort by time, right-align, left-zero-pad to seqslen+1
  (linkpred.py:142-158);
* optional datetime features month/day/weekday/hour (linkpred.py:33-39) —
  derived from the unix timestamp when not present as CSV columns;
* same split-file layout as the reference's prepared CSVs
  (train.csv / validation_{tr,te}.csv / test_{tr,te}.csv, linkpred.py:255-274).
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from easydgl_tpu_torch.data.loader import PackedDataset


def filter_triplets(df, min_uc: int = 5, min_sc: int = 100):
    """Keep items with >= min_sc users and users with >= min_uc items
    (linkpred.py:51-63)."""
    if min_sc > 0:
        counts = df["sid"].value_counts()
        df = df[df["sid"].isin(counts.index[counts >= min_sc])]
    if min_uc > 0:
        counts = df["uid"].value_counts()
        df = df[df["uid"].isin(counts.index[counts >= min_uc])]
    return df


def _datetime_features(ts: np.ndarray) -> Dict[str, np.ndarray]:
    import pandas as pd
    dt = pd.to_datetime(ts.astype(np.int64), unit="s")
    return {"seqs_month": dt.month.values.astype(np.int32),
            "seqs_day": dt.day.values.astype(np.int32),
            "seqs_weekday": dt.weekday.values.astype(np.int32),
            "seqs_hour": dt.hour.values.astype(np.int32)}


def pack_split(df, *, seqslen: int, num_items: int,
               with_datetime: bool = True) -> PackedDataset:
    """df columns: uid, sid, time (sorted or not). Returns packed arrays of
    length seqslen+1 per user (right-aligned; linkpred.py:142-158)."""
    df = df.sort_values(["uid", "time"], kind="stable")
    total = seqslen + 1
    uids, starts = np.unique(df["uid"].values, return_index=True)
    ends = np.append(starts[1:], len(df))
    n = len(uids)

    sid = df["sid"].values.astype(np.int32)
    t = df["time"].values.astype(np.float64)
    extra = _datetime_features(t) if with_datetime else {}

    out = {"seqs_i": np.zeros((n, total), np.int32),
           "seqs_t": np.zeros((n, total), np.float32)}
    for k in extra:
        out[k] = np.zeros((n, total), np.int32)

    for r, (a, b) in enumerate(zip(starts, ends)):
        m = min(b - a, total)
        out["seqs_i"][r, total - m:] = sid[b - m:b]
        out["seqs_t"][r, total - m:] = t[b - m:b]
        for k, v in extra.items():
            out[k][r, total - m:] = v[b - m:b]
    return PackedDataset(out, num_items)


def prepare(fin: str, fout: str, *, seqslen: int = 30,
            num_items: Optional[int] = None, with_datetime: bool = True):
    """Read the reference's split CSVs from ``fin`` and write
    train.npz / validation.npz / test.npz to ``fout``
    (mirrors linkpred.py:main, :216-278)."""
    import pandas as pd

    def read(*names):
        frames = [pd.read_csv(os.path.join(fin, f"{n}.csv")) for n in names]
        df = pd.concat(frames) if len(frames) > 1 else frames[0]
        df = df.rename(columns={"use_ID": "uid", "ite_ID": "sid"})
        return df

    train = read("train")
    valid = read("validation_tr", "validation_te")
    test = read("test_tr", "test_te")
    if num_items is None:
        num_items = int(max(train["sid"].max(), valid["sid"].max(),
                            test["sid"].max())) + 1
    os.makedirs(fout, exist_ok=True)
    for name, df in (("train", train), ("validation", valid), ("test", test)):
        ds = pack_split(df, seqslen=seqslen, num_items=num_items,
                        with_datetime=with_datetime)
        ds.save(os.path.join(fout, f"{name}.npz"))
    return num_items


def prepare_raw(fin_csv: str, fout: str, *, seqslen: int = 30,
                min_uc: int = 5, min_sc: int = 100,
                n_heldout_users: int = 20000, seed: int = 9876,
                with_datetime: bool = True):
    """Full pipeline from a raw (uid, sid, time) triplet CSV: filter by
    min counts, hold out validation/test USERS, renumber ids densely
    (items from 1; 0 = padding), and write packed splits.

    Mirrors the reference's full flow (data/linkpred.py:216-246, the
    authors' preprocessing that produced the prepared CSVs): user-level
    holdout split, items restricted to those seen in training.
    """
    import pandas as pd
    df = pd.read_csv(fin_csv, usecols=["uid", "sid", "time"])
    df = filter_triplets(df, min_uc=min_uc, min_sc=min_sc)

    rng = np.random.default_rng(seed)
    users = df["uid"].value_counts().index.to_numpy()
    users = users[rng.permutation(users.size)]
    n = users.size
    tr_users = set(users[:n - 2 * n_heldout_users])
    vd_users = set(users[n - 2 * n_heldout_users:n - n_heldout_users])
    te_users = set(users[n - n_heldout_users:])

    train = df[df["uid"].isin(tr_users)]
    item_ids = pd.unique(train["sid"])
    show2id = {s: i + 1 for i, s in enumerate(item_ids)}  # 0 = padding
    num_items = len(show2id) + 1

    def numerize(part):
        part = part[part["sid"].isin(show2id)].copy()
        part["sid"] = part["sid"].map(show2id)
        return part.sort_values(["uid", "time"], kind="stable")

    os.makedirs(fout, exist_ok=True)
    for name, part_users in (("train", tr_users), ("validation", vd_users),
                             ("test", te_users)):
        part = numerize(df[df["uid"].isin(part_users)])
        ds = pack_split(part, seqslen=seqslen, num_items=num_items,
                        with_datetime=with_datetime)
        ds.save(os.path.join(fout, f"{name}.npz"))
    return num_items


def mark_table_from_csv(path: str, num_items: int) -> np.ndarray:
    """Build the [num_items, E] multi-hot mark table from (sid, event) CSV
    pairs — the dense replacement for the reference's pickled scipy CSR."""
    import pandas as pd
    df = pd.read_csv(path)
    num_events = int(df["event"].max()) + 1
    table = np.zeros((num_items, num_events), np.int8)
    table[df["sid"].values, df["event"].values] = 1
    table[0] = 0
    return table
