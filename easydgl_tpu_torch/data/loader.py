"""Packed-sequence loader: a copy of ``easydgl_tpu.data.loader``.

Splits are fixed-shape int32/float32 arrays resident in host RAM, per-epoch
order comes from a seeded permutation, masking is a vectorized batch
transform (data/masking.py), and each host reads a disjoint row shard
(``host_id``/``num_hosts``: the data coordinate; a mesh's model and seq
ranks of one data coordinate read the same rows).

Eval batches are padded to the fixed batch size with a ``valid`` row mask so
metric accumulation stays exact. The C++ batcher (``data/native.py``, over
the repo's ``native/batcher.cpp``, the JAX package's source too) gathers the
rows and the marks and, in training, draws the masked-family protocols'
positions (JAX loader.py:68-125); its positions come from its own streams,
so a native train batch equals JAX's native one, not the NumPy one. The
eval path gives the NumPy protocol's batches either way.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from easydgl_tpu_torch.data.masking import make_protocol


@dataclasses.dataclass
class PackedDataset:
    """One split: right-aligned, left-zero-padded sequences of length L+1
    (reference data/linkpred.py:142-158 semantics)."""
    arrays: Dict[str, np.ndarray]      # seqs_i, seqs_t [, seqs_month, ...]
    num_items: int

    def __post_init__(self):
        n = self.arrays["seqs_i"].shape[0]
        for k, v in self.arrays.items():
            assert v.shape[0] == n, f"{k} row mismatch"

    @property
    def num_rows(self) -> int:
        return self.arrays["seqs_i"].shape[0]

    def save(self, path: str):
        np.savez_compressed(path, **self.arrays,
                            __num_items=np.int64(self.num_items))

    @classmethod
    def load(cls, path: str) -> "PackedDataset":
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files if not k.startswith("__")}
            return cls(arrays, int(z["__num_items"]))


class BatchLoader:
    """Deterministic per-host batch iterator with model-specific masking.

    mark_table: optional [num_items, E] multi-hot incidence. When given,
    batches carry ``seqs_marks`` (marks of input items, ids beyond the
    table — the MASK id included — mapped to row 0) and train batches carry
    ``next_marks`` (marks of the label items). With ``marks_on_device`` the
    step looks the marks up itself (train/steps.py::device_marks).
    """

    def __init__(self, dataset: PackedDataset, *, data_mode: str,
                 batch_size: int, masklen: int = 6,
                 mask_id: Optional[int] = None, is_training: bool,
                 seed: int = 9876, host_id: int = 0, num_hosts: int = 1,
                 mark_table: Optional[np.ndarray] = None,
                 needs_marks: bool = False,
                 marks_on_device: bool = False,
                 use_native: Optional[bool] = None):
        """``use_native``: None uses the C++ batcher where JAX's rule
        finds it (``native.available``: the library ``make -C native``
        writes), so both packages take the same branch; True builds the
        port's copy where it is not built and raises where it cannot be
        built or loaded (never a quiet NumPy fallback); False the NumPy
        path."""
        from easydgl_tpu_torch.data import native as _native
        self.data = dataset
        self.data_mode = data_mode
        self.batch_size = batch_size
        self.masklen = masklen
        self.is_training = is_training
        self.seed = seed
        self.mark_table = mark_table
        self.needs_marks = needs_marks
        self.marks_on_device = marks_on_device
        self.mask_id = dataset.num_items if mask_id is None else mask_id
        self.protocol = make_protocol(data_mode, masklen=masklen,
                                      mask_id=self.mask_id)
        if use_native:
            _native.load_library(build=True)
        self.native = (_native.available() if use_native is None
                       else use_native)
        self._native_mod = _native if self.native else None
        self.num_hosts = num_hosts
        self.rows = np.arange(host_id, dataset.num_rows, num_hosts)

    def num_batches(self) -> int:
        """Ceil over the largest host shard, so every host runs the same
        number of steps. Training includes the zero-padded tail batch."""
        n = self.data.num_rows
        max_host_rows = -(-n // self.num_hosts)
        return -(-max_host_rows // self.batch_size)

    def _marks_of(self, ids: np.ndarray) -> np.ndarray:
        if self.native:
            return self._native_mod.mark_gather(self.mark_table, ids)
        safe = np.where(ids >= self.mark_table.shape[0], 0, ids)
        return self.mark_table[safe].astype(np.float32)

    def _native_protocol(self, arrays, epoch: int, batch_idx: int):
        """The C++ masked-family train protocols (native/batcher.cpp), the
        contract of data/masking.py."""
        tokens = arrays["seqs_i"]
        ignore_head = 1 if self.data_mode in ("mau", "grec") else 0
        masked, positions, labels = self._native_mod.masked_batch(
            tokens, self.masklen, self.mask_id, ignore_head,
            self.seed, epoch, batch_idx)
        if self.data_mode == "grec":
            features = {"seqs_i": tokens, "seqs_m": masked,
                        "masked_positions": positions - 1}
        else:
            features = {"seqs_i": masked, "masked_positions": positions,
                        "seqs_t": arrays["seqs_t"]}
        return features, labels

    def epoch(self, epoch: int = 0
              ) -> Iterator[Tuple[Dict[str, np.ndarray], np.ndarray,
                                  np.ndarray]]:
        """Yields (features, labels, valid) with fixed shapes."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, len(self.rows)]))
        order = self.rows
        if self.is_training:
            order = rng.permutation(order)
        bs = self.batch_size
        nb = self.num_batches()
        for i in range(nb):
            rows = order[i * bs:(i + 1) * bs]
            valid = np.ones((bs,), bool)
            n_real = len(rows)
            if n_real < bs:  # tail: pad to the fixed batch shape
                valid[n_real:] = False
                # an empty host shard still reports >=1 batch; pad from
                # dataset row 0 in that case
                pad_row = order[0] if len(order) else 0
                rows = np.concatenate(
                    [rows, np.full(bs - n_real, pad_row)])
            if self.native:
                arrays = {k: self._native_mod.gather_rows(v, rows)
                          for k, v in self.data.arrays.items()}
            else:
                arrays = {k: v[rows] for k, v in self.data.arrays.items()}
            if self.is_training and n_real < bs:
                # train tail: zero rows carry zero label weight
                arrays = {k: v.copy() for k, v in arrays.items()}
                for v in arrays.values():
                    v[n_real:] = 0
            if (self.native and self.is_training and
                    self.data_mode in ("masked", "mau", "grec") and
                    # the native sampler's partial Fisher-Yates buffer has
                    # 512 slots; longer rows take the NumPy protocol
                    self.data.arrays["seqs_i"].shape[1] <= 512):
                features, labels = self._native_protocol(arrays, epoch, i)
            else:
                features, labels = self.protocol(arrays, self.is_training,
                                                 rng)
            if (self.needs_marks and self.mark_table is not None
                    and not self.marks_on_device):
                features["seqs_marks"] = self._marks_of(features["seqs_i"])
                if self.is_training:
                    features["next_marks"] = self._marks_of(labels)
            yield features, labels, valid
