#!/usr/bin/env python3
"""Times the flash attention kernels on one GPU beside SDPA's.

At the SASREC-LC attention shape (B=32, H=8, T=2048, dh=64, causal, the
left-padded key mask with holes of ``chip_smoke.flash_inputs``, seed 950 as
phase 4e), in bf16: the forward and the backward (dq, dk and dv), each with
dropout 0 and 0.1 over 10 launches (CUDA events, after warm-up), and
``F.scaled_dot_product_attention``'s forward and backward with the same
key_mask & causal mask. ``--heads`` and ``--dh`` change the head split at
the same batch and length (the backward is timed where it takes the head
width). Prints one JSON line with the card's name and power limit.
Imports neither JAX nor the JAX package. Run from the root of a checkout;
it takes the package and ``chip_smoke.py`` of the working directory, and
drives whichever backward entry that checkout has (``flash_attention_bwd``,
or ``flash_attention_dq`` and ``flash_attention_dkv``), so running it from
an older checkout in the same call compares two versions:

    python3 scripts/torch_flash_bench.py [--label NAME] [--rounds N]
        [--heads H] [--dh DH]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke  # noqa: E402
from easydgl_tpu_torch.kernels import flash_attention as fl  # noqa: E402

B, T = 32, 2048


def backward(bwd, kw):
    if hasattr(fl, "flash_attention_bwd"):
        return fl.flash_attention_bwd(*bwd, **kw)
    return (fl.flash_attention_dq(*bwd, **kw),) + fl.flash_attention_dkv(
        *bwd, **kw)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--dh", type=int, default=64)
    args = ap.parse_args()
    H, DH = args.heads, args.dh
    if not torch.cuda.is_available():
        print("torch_flash_bench: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    q, k, v, km, dout = chip_smoke.flash_inputs(B, H, T, T, DH,
                                                torch.bfloat16, 950)
    sd = torch.tensor(9500, dtype=torch.int64, device="cuda")
    out, lse = fl.flash_attention_fwd(q, k, v, km, causal=True)
    bwd = (q, k, v, km, dout, lse, fl.flash_delta(dout, out))
    tril = torch.ones((T, T), dtype=torch.bool, device="cuda").tril()
    mask = (km > 0)[:, None, None, :] & tril
    res = dict(label=args.label, card=card, heads=H, dh=DH, fwd_ms=[],
               fwd_ms_dropout=[], sdpa_fwd_ms=[], bwd_ms=[],
               bwd_ms_dropout=[], sdpa_bwd_ms=[])
    for _ in range(args.rounds):
        res["fwd_ms"].append(chip_smoke.time_ms(
            lambda: fl.flash_attention_fwd(q, k, v, km, causal=True),
            warmup=2, iters=10))
        res["fwd_ms_dropout"].append(chip_smoke.time_ms(
            lambda: fl.flash_attention_fwd(q, k, v, km, causal=True,
                                           dropout_rate=0.1, seed=sd),
            warmup=2, iters=10))
        if DH not in fl.KERNEL_BWD_HEAD_DIMS:
            res["sdpa_fwd_ms"].append(chip_smoke.sdpa_times(q, k, v, dout,
                                                            mask)[0])
            continue
        res["bwd_ms"].append(chip_smoke.time_ms(
            lambda: backward(bwd, dict(causal=True)), warmup=2, iters=10))
        res["bwd_ms_dropout"].append(chip_smoke.time_ms(
            lambda: backward(bwd, dict(causal=True, dropout_rate=0.1,
                                       seed=sd)), warmup=2, iters=10))
        sdpa_f, sdpa_b = chip_smoke.sdpa_times(q, k, v, dout, mask)
        res["sdpa_fwd_ms"].append(sdpa_f)
        res["sdpa_bwd_ms"].append(sdpa_b)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
