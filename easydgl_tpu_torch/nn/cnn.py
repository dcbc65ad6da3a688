"""Dilated convolution stack for GREC (port of ``easydgl_tpu.nn.cnn``),
reference src/module/sequential.py:140-207.

* ``DilatedConv1D``: an atrous 1-D convolution; ``weight`` (W, I, O) as
  flax holds it, ``bias`` (O,). The causal form left-pads
  ``(W - 1) * dilation`` and takes VALID; the other is XLA's SAME, the
  same total pad split with ``total // 2`` on the low side. It is written
  as one GEMM over the W shifted taps (B, T, W * I) @ (W * I, O), in fp32
  with an fp32 result in either compute dtype, as JAX's convolution of
  the fp32 embeddings is: cuBLAS runs fp32 GEMMs in full precision unless
  the process allows TF32, where cuDNN's convolutions default to TF32.
* ``MaskedCNN``: two dilated convolutions (dilation, 2 * dilation), each
  followed by ``LastAxisLayerNorm`` (eps 1e-8) and relu, then the
  residual.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from easydgl_tpu_torch.nn.layers import LastAxisLayerNorm


class DilatedConv1D(nn.Module):
    def __init__(self, filter_width: int, in_channels: int,
                 out_channels: int, dilation: int, causality: bool, *,
                 device=None):
        super().__init__()
        self.filter_width = filter_width
        self.dilation = dilation
        self.causality = causality
        self.weight = nn.Parameter(torch.empty(
            filter_width, in_channels, out_channels, device=device))
        self.bias = nn.Parameter(torch.empty(out_channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, T, I) -> (B, T, O) fp32."""
        w, d = self.filter_width, self.dilation
        t = x.shape[1]
        total = (w - 1) * d
        low = total if self.causality else total // 2
        xp = F.pad(x.float(), (0, 0, low, total - low))
        taps = torch.cat([xp[:, i * d:i * d + t] for i in range(w)], dim=-1)
        return taps @ self.weight.reshape(-1, self.weight.shape[-1]) \
            + self.bias


class MaskedCNN(nn.Module):
    def __init__(self, filter_width: int, channels: int, dilation: int,
                 causality: bool, *, device=None):
        super().__init__()
        self.dconv0 = DilatedConv1D(filter_width, channels, channels,
                                    dilation, causality, device=device)
        self.ln0 = LastAxisLayerNorm(channels, device=device)
        self.dconv1 = DilatedConv1D(filter_width, channels, channels,
                                    2 * dilation, causality, device=device)
        self.ln1 = LastAxisLayerNorm(channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.ln0(self.dconv0(x)))
        h = torch.relu(self.ln1(self.dconv1(h)))
        return h + x
