"""Synthetic benchmark data: Netflix-shaped sequences for tests and perf runs.

A copy of ``easydgl_tpu.data.synthetic`` (same generators, same streams);
``synthetic_split_vectorized`` also takes ``with_datetime``.

Generates right-aligned, left-padded (item, timestamp) sequences with a
Zipfian item popularity plus a structured next-item dependency so models can
actually learn (handy for golden-metric integration tests), mirroring the
packed layout the ETL produces from real CSVs (data/linkpred.py:142-158).
"""
from __future__ import annotations

import numpy as np

from easydgl_tpu_torch.data.loader import PackedDataset


def synthetic_split(*, num_rows: int, num_items: int, seqslen: int,
                    seed: int = 0, min_len: int = 5,
                    with_datetime: bool = False,
                    start_time: float = 1.0e9) -> PackedDataset:
    """seqslen is the MODEL length; stored sequences are seqslen+1 long."""
    rng = np.random.default_rng(seed)
    total = seqslen + 1
    # Zipf-ish popularity over items 1..num_items-1
    ranks = np.arange(1, num_items)
    probs = 1.0 / ranks ** 0.8
    probs /= probs.sum()

    seqs_i = np.zeros((num_rows, total), np.int32)
    seqs_t = np.zeros((num_rows, total), np.float32)
    lengths = rng.integers(min_len, total + 1, num_rows)
    for r in range(num_rows):
        n = int(lengths[r])
        # markov-ish walk: next item correlates with previous (learnable)
        items = np.empty(n, np.int64)
        items[0] = rng.choice(ranks, p=probs)
        for j in range(1, n):
            if rng.random() < 0.6:
                items[j] = (items[j - 1] % (num_items - 1)) + 1
            else:
                items[j] = rng.choice(ranks, p=probs)
        gaps = rng.exponential(86400.0, n - 1) if n > 1 else np.empty(0)
        times = start_time + np.concatenate([[0.0], np.cumsum(gaps)])
        seqs_i[r, total - n:] = items
        seqs_t[r, total - n:] = times
    arrays = {"seqs_i": seqs_i, "seqs_t": seqs_t}
    if with_datetime:
        arrays.update(datetime_fields(seqs_i, seqs_t))
    return PackedDataset(arrays, num_items)


def datetime_fields(seqs_i: np.ndarray, seqs_t: np.ndarray) -> dict:
    """TimelyREC's seqs_month (1-12), seqs_day (1-31), seqs_weekday and
    seqs_hour of the stamps, by whole days of 86,400 s; padded positions
    take month and day 1, weekday and hour 0."""
    secs = seqs_t.astype(np.int64)
    days = secs // 86400
    fields = {"seqs_month": ((days // 30) % 12 + 1).astype(np.int32),
              "seqs_day": ((days % 31) + 1).astype(np.int32),
              "seqs_weekday": (days % 7).astype(np.int32),
              "seqs_hour": ((secs // 3600) % 24).astype(np.int32)}
    pad = seqs_i == 0
    for k in ("seqs_month", "seqs_day"):
        fields[k] = np.where(pad, 1, fields[k])
    for k in ("seqs_weekday", "seqs_hour"):
        fields[k] = np.where(pad, 0, fields[k])
    return fields


def synthetic_mark_table(num_items: int, num_events: int,
                         seed: int = 0) -> np.ndarray:
    """Multi-hot [num_items, E] incidence; row 0 (padding) all-zero — the
    dense equivalent of the reference's mark.pkl CSR (CTSMA.py:24-25)."""
    rng = np.random.default_rng(seed)
    table = (rng.random((num_items, num_events)) < 0.15).astype(np.int8)
    none = table.sum(-1) == 0
    table[none, rng.integers(0, num_events, none.sum())] = 1
    table[0] = 0
    return table


def day_boundary_stamps(rng: np.random.Generator, num_rows: int,
                        length: int, *, max_days: int,
                        day: float = 86400.0, start_day: int = 18500,
                        padded: int = 3) -> np.ndarray:
    """(num_rows, length) fp32 timestamps in seconds, sorted draws of whole
    days from [start_day, start_day + max_days), each off midnight by 256 s
    or 384 s in turn, as dated stamps sit: many of their differences in
    days lie within an fp32 rounding of a whole number, where a bucket of
    truncated spans depends on the order of the fp32 operations. The first
    ``padded`` stamps of row 0 are 0 (a left-padded row). Not in the JAX
    package's module; the stamps of the interval-bucket checks."""
    days = np.sort(rng.integers(0, max_days, (num_rows, length)), axis=1)
    off = np.where(np.arange(length) % 2 == 0, 256.0, 384.0)
    exact = (start_day + days) * day + off
    stamps = exact.astype(np.float32)
    assert (stamps.astype(np.float64) == exact).all(), "not exact in fp32"
    stamps[0, :padded] = 0.0
    return stamps


def synthetic_split_vectorized(*, num_rows: int, num_items: int,
                               seqslen: int, seed: int = 0,
                               min_len: int = 5,
                               start_time: float = 1.0e9,
                               with_datetime: bool = False) -> PackedDataset:
    """Vectorized twin of ``synthetic_split`` for production-scale runs
    (hundreds of thousands of rows in seconds instead of minutes). Same
    distributional structure — Zipf popularity + 0.6-probability markov
    next-item dependency + exponential gaps — but a DIFFERENT RNG stream,
    kept separate so the per-row generator's golden fixtures stay stable.
    ``with_datetime`` adds ``synthetic_split``'s datetime fields
    (``datetime_fields``; no draw, so the stream is unchanged).
    """
    rng = np.random.default_rng(seed)
    total = seqslen + 1
    ranks = np.arange(1, num_items)
    probs = 1.0 / ranks ** 0.8
    probs /= probs.sum()

    fresh = rng.choice(ranks, size=(num_rows, total), p=probs)
    keep_prev = rng.random((num_rows, total)) < 0.6
    items = np.empty((num_rows, total), np.int64)
    items[:, 0] = fresh[:, 0]
    for j in range(1, total):        # 31-step scan over vectorized rows
        walked = (items[:, j - 1] % (num_items - 1)) + 1
        items[:, j] = np.where(keep_prev[:, j], walked, fresh[:, j])

    gaps = rng.exponential(86400.0, (num_rows, total - 1))
    times = start_time + np.concatenate(
        [np.zeros((num_rows, 1)), np.cumsum(gaps, axis=1)], axis=1)

    lengths = rng.integers(min_len, total + 1, num_rows)
    col = np.arange(total)[None, :]
    pad = col < (total - lengths[:, None])     # left-pad to right-align
    seqs_i = np.where(pad, 0, items).astype(np.int32)
    seqs_t = np.where(pad, 0.0, times).astype(np.float32)
    arrays = {"seqs_i": seqs_i, "seqs_t": seqs_t}
    if with_datetime:
        arrays.update(datetime_fields(seqs_i, seqs_t))
    return PackedDataset(arrays, num_items)
