"""Shared model protocol (port of ``easydgl_tpu.models.base``).

A model is an ``nn.Module`` whose ``forward(features, is_training)`` returns
``(logits, aux)``; ``aux`` carries the per-block TPP intensities and the
(hidden, table, bias) triple the catalog scorer consumes.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint
from torch import nn

from easydgl_tpu_torch.config import Config
from easydgl_tpu_torch.nn.layers import mm_fp32acc

# Aux dict keys
INTENSITIES = "intensities"   # tuple of (B, H, T, E) per block (LLE_PP)
SCORING = "scoring"           # (hidden, table, bias)


def mau_impl(cfg: Config) -> str:
    """MAU/BiMAU engine of the self-modulating models (JAX
    ``models/base.py:40-51``): ``attention_impl == "flash"``, the
    long-context switch, gives the streamed two-sweep schedule (its kernels
    on the card, the blocked plain version on the CPU); anything else the
    fused chain (``mau_attention``)."""
    return "streamed" if cfg.attention_impl == "flash" else "fused"


class OutputBias(nn.Module):
    """Learned per-item bias with a -1000 pad on item 0
    (reference Base.py:106-113); ``output_bias`` holds the learned part."""

    def __init__(self, vocab_size: int, *, device=None):
        super().__init__()
        self.output_bias = nn.Parameter(
            torch.empty(vocab_size - 1, device=device))

    def forward(self) -> torch.Tensor:
        b = self.output_bias
        return torch.cat([torch.full((1,), -1000.0, dtype=b.dtype,
                                     device=b.device), b])


def scaled_times(seqs_t: torch.Tensor, time_scale: float) -> torch.Tensor:
    """``seqs_t / time_scale`` in fp32 (the time models' ``ts``), divided by
    a tensor on the stamps' device: a Python float is a CPU scalar, which
    CUDA's division turns into a product with its fp32 reciprocal, and at
    stamps of ~1e9 s that moves ts by an ulp (~1e-3 days) against the
    JAX source's division run op by op."""
    return seqs_t.float() / torch.tensor(time_scale, dtype=torch.float32,
                                         device=seqs_t.device)


def prediction_rows(x: torch.Tensor, is_training: bool,
                    masked_positions: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Training: all positions, or the masked positions (BERT-style
    batch_gather); eval: the last position only. Returns (N, C)."""
    if not is_training:
        return x[:, -1, :]
    if masked_positions is not None:
        b = x.shape[0]
        rows = torch.take_along_dim(x, masked_positions[:, :, None].long(),
                                    dim=1)
        return rows.reshape(b * masked_positions.shape[1], x.shape[-1])
    return x.reshape(-1, x.shape[-1])


def tied_logits(hidden: torch.Tensor, table: torch.Tensor,
                bias: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Full-catalog scoring through the tied embedding table:
    (N, C) @ (V, C)^T + bias, compute-dtype operands, fp32 result.

    Under a mesh whose model axis splits the catalog (mp > 1 divides V),
    this rank's (N, V/mp) columns (``dist/embedding.py::
    sharded_tied_logits``; the distributed eval ranks them); ``table`` is
    then this rank's rows or the whole table."""
    from easydgl_tpu_torch.core.mesh import spmd_mesh, table_rows
    mesh = spmd_mesh()
    if mesh is not None and table_rows(mesh, bias.shape[0]) is not None:
        from easydgl_tpu_torch.dist.embedding import sharded_tied_logits
        return sharded_tied_logits(hidden, table, bias, mesh, compute_dtype)
    return mm_fp32acc(hidden, table.t(), compute_dtype) + bias


class SequentialModel(nn.Module):
    """Base class: subclasses implement
    ``forward(features, is_training) -> (logits, aux)``."""
    data_mode: str = "regressive"
    loss_mode: str = "softmax_eps"
    uses_tpp: bool = False
    # the long-context attention engine: (module, name of the function its
    # blocks call there, that function's plain version); a test can swap
    # the plain version in to hold the kernels against it on one device
    long_context_engine: Optional[tuple] = None

    @classmethod
    def flax_layout(cls, cfg: Config, init) -> dict:
        """The JAX model's ``init`` param tree for ``cfg``, leaves drawn
        with ``init`` (``parity.FlaxInit``)."""
        raise NotImplementedError(f"{cls.__name__}.flax_layout")

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg

    @property
    def vocab_size(self) -> int:
        """Logit width; EasyDGL adds the MASK id."""
        return self.cfg.num_items

    @property
    def model_seqslen(self) -> int:
        """Sequence length the model consumes (masked models use L+1)."""
        return self.cfg.seqslen


def remat(fn, i: int, x, mask, gen: Optional[torch.Generator]):
    """``fn(i, x, mask, gen)`` (block i; ``mask``: whatever else the block
    takes, not differentiated) under ``torch.utils.checkpoint``: its
    activations are not kept but recomputed in the backward (``nn.remat``
    in the JAX models). The dropout masks come from ``gen``, which the
    checkpoint's own RNG handling does not cover: its state at the block's
    start is kept, and the recompute runs from it and then puts the
    generator back where it found it."""
    if gen is None:
        return torch.utils.checkpoint.checkpoint(fn, i, x, mask, None,
                                                 use_reentrant=False)
    start = gen.get_state()
    calls = [0]

    def run(x):
        calls[0] += 1
        if calls[0] == 1:   # the forward
            return fn(i, x, mask, gen)
        now = gen.get_state()
        gen.set_state(start)
        try:
            return fn(i, x, mask, gen)
        finally:
            gen.set_state(now)

    return torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False)
