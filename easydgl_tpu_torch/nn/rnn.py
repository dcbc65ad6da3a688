"""Recurrent layers (port of ``easydgl_tpu.nn.rnn``): the cuDNN-variant GRU
of GRU4REC and S2PNM, and a block LSTM.

The cuDNN GRU is not the textbook GRU: the reset gate is applied AFTER the
candidate's recurrent product, and there are two bias vectors (reference
cudnn_rnn_ops.py:81-116):

    r  = sigmoid(x W_r + h R_r + bW_r + bR_r)
    u  = sigmoid(x W_u + h R_u + bW_u + bR_u)
    h' = tanh(x W_h + bW_h + r * (h R_h + bR_h))
    h  = (1 - u) * h' + u * h

The input projections of all time steps are one product hoisted out of the
recurrence; the loop over time then takes one (B, C) x (C, 3C) product a
step. ``torch.nn.GRU`` has the same gate layout but, in bf16, keeps its
carry and gates in bf16; here, as in the JAX module, the projections and
the carry stay fp32 and only the operands of each product are rounded to
the compute dtype (``mm_fp32acc``).

Weights are stored as the flax module stores them, ``(in, gates * C)`` with
the gates side by side, under the flax names (``w_{l}``, ``r_{l}``,
``bw_{l}``, ``br_{l}``; the LSTM's ``w``, ``r``, ``b``), so the weight
bridge carries them unchanged. Each gate's block of a kernel is an
independent orthogonal matrix (``parity.FlaxInit.per_gate_orthogonal``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from easydgl_tpu_torch.nn.layers import mm_fp32acc


def _param(*shape, device=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, device=device))


def _recurrent_mm(h: torch.Tensor, r_c: torch.Tensor,
                  cdt: Optional[torch.dtype]) -> torch.Tensor:
    """One step's ``h @ r`` with compute-dtype operands and an fp32 result;
    ``r_c`` is the recurrent kernel already in the compute dtype. It is
    widened here, once a step, so that in the backward each step's
    gradient of it is rounded to the compute dtype and the steps' are
    summed in that dtype: what the JAX scan does with the cotangent of its
    closed-over bf16 kernel."""
    if cdt is None:
        return h @ r_c
    return h.to(cdt).float() @ r_c.float()


class CudnnGRU(nn.Module):
    """Multi-layer unidirectional GRU with cuDNN gate math (reference
    cudnn_rnn.CudnnGRU, GRU4REC.py:27-29, S2PNM.py:29-31)."""

    def __init__(self, num_layers: int, in_units: int, num_units: int, *,
                 compute_dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.num_layers = num_layers
        self.num_units = num_units
        self.compute_dtype = compute_dtype
        c = num_units
        for layer in range(num_layers):
            in_c = in_units if layer == 0 else c
            self.register_parameter(f"w_{layer}",
                                    _param(in_c, 3 * c, device=device))
            self.register_parameter(f"r_{layer}",
                                    _param(c, 3 * c, device=device))
            self.register_parameter(f"bw_{layer}",
                                    _param(3 * c, device=device))
            self.register_parameter(f"br_{layer}",
                                    _param(3 * c, device=device))

    def forward(self, x: torch.Tensor, h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, T, C_in), batch-major; h0 (L, B, C) or None (zeros).
        Returns (outputs (B, T, C), final states (L, B, C)), fp32."""
        cdt = self.compute_dtype
        b = x.shape[0]
        c = self.num_units
        finals = []
        for layer in range(self.num_layers):
            w, r, bw, br = (getattr(self, f"{name}_{layer}")
                            for name in ("w", "r", "bw", "br"))
            xw = mm_fp32acc(x, w, cdt) + bw                   # (B, T, 3C)
            r_c = r.to(cdt) if cdt is not None else r
            h = (h0[layer] if h0 is not None
                 else torch.zeros((b, c), dtype=xw.dtype, device=x.device))
            outs = []
            # unbind, not xw[:, step]: its backward stacks the steps'
            # gradients once, where each slice's would fill and add a
            # whole (B, T, 3C) gradient
            for xw_t in xw.unbind(dim=1):
                hr = _recurrent_mm(h, r_c, cdt) + br
                xr, xu, xh = xw_t.split(c, dim=-1)
                hr_r, hr_u, hr_h = hr.split(c, dim=-1)
                rg = torch.sigmoid(xr + hr_r)
                ug = torch.sigmoid(xu + hr_u)
                cand = torch.tanh(xh + rg * hr_h)             # cuDNN variant
                h = (1.0 - ug) * cand + ug * h
                outs.append(h)
            x = torch.stack(outs, dim=1)                      # (B, T, C)
            finals.append(h)
        return x, torch.stack(finals)


class BlockLSTM(nn.Module):
    """Fused-gate LSTM (the reference's vendored ``lstm_ops`` block LSTM,
    compat/lstm_ops.py:122,208,654): gates i, c', f, o side by side,
    ``forget_bias`` added to f, no peepholes. No model uses it."""

    def __init__(self, in_units: int, num_units: int,
                 forget_bias: float = 1.0, *,
                 compute_dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.num_units = num_units
        self.forget_bias = forget_bias
        self.compute_dtype = compute_dtype
        self.w = _param(in_units, 4 * num_units, device=device)
        self.r = _param(num_units, 4 * num_units, device=device)
        self.b = _param(4 * num_units, device=device)

    def forward(self, x: torch.Tensor,
                init: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """x (B, T, C_in); init (c, h), each (B, C), or None (zeros).
        Returns (outputs (B, T, C), (c_final, h_final))."""
        cdt = self.compute_dtype
        b = x.shape[0]
        xw = mm_fp32acc(x, self.w, cdt) + self.b              # (B, T, 4C)
        r_c = self.r.to(cdt) if cdt is not None else self.r
        if init is None:
            zeros = torch.zeros((b, self.num_units), dtype=xw.dtype,
                                device=x.device)
            init = (zeros, zeros)
        c, h = init
        outs = []
        for xw_t in xw.unbind(dim=1):
            gates = xw_t + _recurrent_mm(h, r_c, cdt)
            i, cc, f, o = gates.split(self.num_units, dim=-1)
            c = (torch.sigmoid(f + self.forget_bias) * c
                 + torch.sigmoid(i) * torch.tanh(cc))
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        return torch.stack(outs, dim=1), (c, h)
