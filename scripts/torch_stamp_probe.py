#!/usr/bin/env python3
"""EasyDGL-LC's fp32 eval logits on the card against the CPU, with and
without ``gather_queries``, at L+1 = 160 and 31 (C = 64, H = 2, E = 4,
B = 2, random weights from seed 1): the largest gap of the logits and of
the block's intensities. It separates a gap of the MAU (the intensities
move) from one of the inputs it shares (the stamps' sinusoid codes: a
divisor that CUDA takes as a product with its fp32 reciprocal moves an
ulp of a ~1.2e4-day stamp, and its code by ~1e-3). Imports neither JAX
nor the JAX package; needs a card.

    python3 scripts/torch_stamp_probe.py
"""
from __future__ import annotations

import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from easydgl_tpu_torch.config import preset  # noqa: E402
from easydgl_tpu_torch.data.loader import BatchLoader  # noqa: E402
from easydgl_tpu_torch.data.synthetic import (  # noqa: E402
    synthetic_mark_table, synthetic_split)
from easydgl_tpu_torch.models.registry import build_model  # noqa: E402
from easydgl_tpu_torch.parity import random_flax_params  # noqa: E402
from easydgl_tpu_torch.train.steps import to_device  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_stamp_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    table = synthetic_mark_table(60, 4, seed=2)
    for gather in (True, False):
        for seqslen in (159, 30):
            cfg = preset("EasyDGL-LC", num_items=60, seqslen=seqslen,
                         masklen=16, num_units=64, num_heads=2, num_events=4,
                         batch_size=2, compute_dtype="float32",
                         hidden_dropout_rate=0.0,
                         attention_probs_dropout_rate=0.0,
                         gather_queries=gather)
            ds = synthetic_split(num_rows=2, num_items=60, seqslen=seqslen,
                                 seed=3)
            params = random_flax_params(cfg, 1)
            features, _, _ = next(BatchLoader(
                ds, data_mode="mau", batch_size=2, masklen=16,
                is_training=False, mark_table=table,
                needs_marks=True).epoch(0))
            out = {}
            for dev in ("cuda", "cpu"):
                model = build_model(cfg, device=dev, params=params)
                with torch.no_grad():
                    logits, aux = model(to_device(features, dev))
                out[dev] = (logits.cpu(), aux["intensities"][0].cpu())
            gap = (out["cuda"][0] - out["cpu"][0]).abs()
            want = out["cpu"][0]
            lam = (out["cuda"][1] - out["cpu"][1]).abs()
            print(f"{torch.cuda.get_device_name(0)}; gather_queries={gather}"
                  f" L+1={seqslen + 1}: logits max_abs={float(gap.max()):.3e}"
                  f" worst/tol(1e-4, 1e-4)="
                  f"{float((gap / (1e-4 + 1e-4 * want.abs())).max()):.3f};"
                  f" intensities max_abs={float(lam.max()):.3e} of"
                  f" {float(out['cpu'][1].abs().max()):.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
