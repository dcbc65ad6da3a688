"""Embedding and time-coding modules (port of ``easydgl_tpu.nn.coding``).

* ``Embedding``: lookup table; with ``zero_pad`` row 0 of the TENSOR is
  zeroed on every use (the parameter keeps its value, reference
  coding.py:56-57), and the same zeroed table feeds the tied logits;
  optional sqrt(d) scale; out-of-range ids clamp to the edge rows (JAX's
  ``take(mode="clip")``). A table whose rows are split over the model
  axis (the parameter then carries ``vocab_rows``) is read through
  ``dist/embedding.py::sharded_lookup``.
* ``PositionCoding.code``: learned absolute positions, ``iota(T)`` rows;
  calling the module concatenates them to its input (SASREC's 2C-wide
  first block, reference coding.py:67-79).
* ``TimeIntervalCoding``: an embedding over integer interval buckets
  (TiSASREC). The model clips buckets to [0, timelen] INCLUSIVE while the
  table has ``timelen`` rows, so the edge bucket is out of range; ``code``
  gives it a zero row (the TF GPU gather the reference's numbers come
  from), and ``table_extended`` appends that zero row for the factored
  interval attention. The index is clamped before the gather, as in
  ``Embedding``: on the card an out-of-range ``index_select`` is a
  device-side assert.
* ``TimeFunctionCoding``: learnable Bochner features ``cos(t w + phi)``
  (TGAT, TGREC), ``basis_freq`` w and ``phase`` phi; ``code`` of (B, T) or
  (B, Tq, Tk) times, ``factors`` the per-position cos/sin factors of the
  pairwise features (angle addition), times centred on the row's latest
  query time before the trig, as in JAX.
* ``TimeSinusoidCoding.code``: fixed interleaved sin/cos with
  ``10000^(2i/d)`` scaling. Its arguments reach ~1e4 rad at real
  timestamps, so it stays plain fp32 ``torch.sin``/``torch.cos`` (a
  fast-math path loses ~1e-3 there).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


class Embedding(nn.Module):
    def __init__(self, vocab_size: int, num_units: int, *,
                 zero_pad: bool = True, scale: bool = True, device=None):
        super().__init__()
        self.vocab_size = vocab_size
        self.num_units = num_units
        self.zero_pad = zero_pad
        self.scale = scale
        self.lookup_table = nn.Parameter(
            torch.empty(vocab_size, num_units, device=device))

    def table(self) -> torch.Tensor:
        """The table with row 0 zeroed (``zero_pad``); of a table whose rows
        are split over the model axis, this rank's rows."""
        t = self.lookup_table
        if self.zero_pad:
            start = self.rows()[0]
            row_mask = (torch.arange(start, start + t.shape[0],
                                     device=t.device) != 0)
            t = t * row_mask.to(t.dtype)[:, None]
        return t

    def rows(self):
        """[start, stop) of the rows this module holds: the whole table, or
        the slice ``train/sharded.py::shard_state`` left it."""
        return getattr(self.lookup_table, "vocab_rows",
                       (0, self.vocab_size))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        safe = ids.long().clamp(0, self.vocab_size - 1)
        if hasattr(self.lookup_table, "vocab_rows"):
            from easydgl_tpu_torch.core.mesh import spmd_mesh
            from easydgl_tpu_torch.dist.embedding import sharded_lookup
            out = sharded_lookup(self.table(), safe, self.rows()[0],
                                 spmd_mesh())
        else:
            # index_select, not advanced indexing: its backward is an
            # index_add (3.7 ms less per flagship train step on an H100
            # than the sorting backward of indexing;
            # scripts/torch_train_profile.py)
            out = torch.index_select(self.table(), 0,
                                     safe.reshape(-1)).reshape(
                *ids.shape, self.num_units)
        if self.scale:
            out = out * (self.num_units ** 0.5)
        return out


class PositionCoding(nn.Module):
    """Learned absolute position embeddings (reference coding.py:67-79)."""

    def __init__(self, vocab_size: int, num_units: int, *, device=None):
        super().__init__()
        self.num_units = num_units
        self.pembs = Embedding(vocab_size, num_units, zero_pad=False,
                               scale=False, device=device)

    def code(self, inputs: torch.Tensor) -> torch.Tensor:
        """inputs: (B, T, ...) — only B and T are used."""
        b, t = inputs.shape[0], inputs.shape[1]
        return self.pembs.table()[None, :t].expand(b, t, self.num_units)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        """[inputs | codes] on the last axis."""
        return torch.cat([inputs, self.code(inputs)], dim=-1)


class TimeIntervalCoding(nn.Module):
    """Embedding over integer interval buckets (reference coding.py:82-94);
    parameter ``pembs.lookup_table`` (vocab_size, C)."""

    def __init__(self, vocab_size: int, num_units: int, *, device=None):
        super().__init__()
        self.pembs = Embedding(vocab_size, num_units, zero_pad=False,
                               scale=False, device=device)

    def code(self, buckets: torch.Tensor) -> torch.Tensor:
        """buckets (...) int -> (..., C); a bucket outside [0, vocab_size)
        gives a zero row."""
        ok = (buckets >= 0) & (buckets < self.pembs.vocab_size)
        out = self.pembs(buckets)
        return out * ok[..., None].to(out.dtype)

    def table_extended(self) -> torch.Tensor:
        """(vocab_size + 1, C): the table with a zero LAST row, which the
        edge bucket ``vocab_size`` indexes."""
        t = self.pembs.table()
        return torch.cat([t, t.new_zeros((1, t.shape[1]))])


class TimeFunctionCoding(nn.Module):
    """Learnable Bochner time features ``cos(t w + phi)`` (reference
    coding.py:97-122; JAX ``nn/coding.py:124-172``). Parameters
    ``basis_freq`` (C,) and ``phase`` (C,); flax initialises them to
    ``linspace(0, 9, C)`` and 0 (``parity.FlaxInit.time_function``)."""

    def __init__(self, num_units: int, *, device=None):
        super().__init__()
        self.basis_freq = nn.Parameter(torch.empty(num_units, device=device))
        self.phase = nn.Parameter(torch.empty(num_units, device=device))

    def code(self, inputs: torch.Tensor) -> torch.Tensor:
        """inputs (B, T) or (B, Tq, Tk) -> (..., C) fp32; (B, T) is
        coded as (B, T, 1, C), the reference's reshape to (B, T, -1)."""
        x = inputs.float()
        if x.dim() == 2:
            x = x[:, :, None]
        return torch.cos(x[..., None] * self.basis_freq + self.phase)

    def factors(self, q_times: torch.Tensor, k_times: torch.Tensor):
        """(cq, sq, ck, sk), each (B, T, C): ``cos(w (tq - tk) + phi) =
        cq ck + sq sk`` with the phase on the query side. q_times, k_times
        (B, T) scaled stamps, centred on the row's latest query time t0
        first: the identity involves only tq - tk, and the centring keeps
        the cos arguments at w * span rather than w * t (~1e4 rad), where
        fp32 argument reduction loses ~1e-2."""
        qf, kf = q_times.float(), k_times.float()
        t0 = qf.amax(dim=-1, keepdim=True)
        aq = (qf - t0)[..., None] * self.basis_freq + self.phase
        ak = (kf - t0)[..., None] * self.basis_freq
        return torch.cos(aq), torch.sin(aq), torch.cos(ak), torch.sin(ak)


class TimeSinusoidCoding(nn.Module):
    """Fixed interleaved sin/cos coding (coding.py:125-149); no params."""

    def __init__(self, num_units: int):
        super().__init__()
        self.num_units = num_units

    def code(self, inputs: torch.Tensor) -> torch.Tensor:
        """inputs: (B, T) float -> (B, T, num_units)."""
        d = self.num_units
        scale = torch.from_numpy(
            np.power(10000.0, np.arange(0, d, 2) / d).astype(np.float32)
        ).to(inputs.device)
        x = inputs.float()[:, :, None] / scale                 # (B, T, d/2)
        code = torch.stack([torch.sin(x), torch.cos(x)], dim=-1)
        return code.reshape(inputs.shape[0], inputs.shape[1], d)
