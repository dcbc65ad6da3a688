#!/usr/bin/env python3
"""Times the fused MAU/BiMAU backward, or its forward, on one GPU, whole
and by kernel.

At the flagship train shape (B=512, T=31, H=8, dh=64, E=64, BiMAU, dropout
0.1, bf16), with inputs drawn from a seed as ``chip_smoke.py`` phase 4b
draws them: ``mau_attention_bwd`` over 10 launches (CUDA events, after
warm-up) in each of ``--rounds`` rounds; with ``--kernels`` also its device
time by CUDA kernel (``torch.profiler``, 10 launches). ``--ctsma`` times
the backward at the CTSMA train shape instead (B=512, T=30, H=4, dh=128,
E=64, causal, dropout 0.2, bf16, on a CTSMA batch's key mask and spans, as
phase 4 / 4b (CTSMA) draws them). ``--fwd`` times the forward instead, on
phase 4's bf16 inputs (BiMAU): the eval launch (dropout 0, no residual) and
the train launch (the raw residual, dropout 0.1), in rounds as the
backward. Prints one JSON line with the card's name and power limit.
Imports neither JAX nor the JAX package; run from the root of a checkout
(or of an older one, to compare two versions in one call):

    python3 scripts/torch_mau_bench.py [--label NAME] [--fwd | --ctsma]
        [--rounds N] [--kernels]
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
from easydgl_tpu_torch.kernels.mau_attention import (  # noqa: E402
    _launch_fwd, _seed_tensor, mau_attention_bwd)
from scripts.torch_streamed_bench import kernel_ms, time_ms  # noqa: E402


def bwd_run(ctsma=False):
    """The backward's launch at phase 4b's bf16 inputs (``ctsma``: at phase
    4 / 4b (CTSMA)'s), ready to call."""
    shape, seed, causal, rate, dseed, batch = (
        (chip_smoke.CTSMA_TRAIN, 210, True, 0.2, 9, "CTSMA") if ctsma else
        (chip_smoke.FLAGSHIP, 200, False, 0.1, 5, None))
    args = chip_smoke.mau_inputs(**shape, dtype=torch.bfloat16,
                                 gathered=False, seed=seed, batch=batch)
    q, k, v, t, km, iv, oh, wd, bd, w, sc, qpos = args
    h = shape["h"]
    sd = _seed_tensor(dseed, rate, torch.device("cuda"))
    _, _, raw = _launch_fwd(q, k, v, t, km, iv, oh, wd, bd, w, sc, causal,
                            not causal, h, qpos, sd, rate, want_raw=True)
    go, gl = chip_smoke.mau_bwd_args(args, torch.bfloat16, 7)
    return lambda: mau_attention_bwd(
        q, k, v, t, km, iv, oh, wd, bd, w, sc, raw, go, gl, causal=causal,
        diag_reset=not causal, dropout_rate=rate, dropout_seed=sd,
        num_heads=h, qpos=qpos)


def fwd_runs():
    """{"eval": ..., "train": ...}: the forward's launches at phase 4's bf16
    inputs, ready to call."""
    args = chip_smoke.mau_inputs(**chip_smoke.FLAGSHIP, dtype=torch.bfloat16,
                                 gathered=False, seed=100)
    q, k, v, t, km, iv, oh, wd, bd, w, sc, qpos = args
    sd = _seed_tensor(5, 0.1, torch.device("cuda"))
    return {"eval": lambda: _launch_fwd(q, k, v, t, km, iv, oh, wd, bd, w, sc,
                                        False, True, 8, qpos, None, 0.0,
                                        want_raw=False),
            "train": lambda: _launch_fwd(q, k, v, t, km, iv, oh, wd, bd, w,
                                         sc, False, True, 8, qpos, sd, 0.1,
                                         want_raw=True)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    ap.add_argument("--fwd", action="store_true")
    ap.add_argument("--ctsma", action="store_true")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--kernels", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_mau_bench: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    res = {"label": args.label, "card": card}
    runs = fwd_runs() if args.fwd else {"": bwd_run(args.ctsma)}
    for name, run in runs.items():
        key = f"fwd_{name}" if args.fwd else "bwd"
        res[f"{key}_ms"] = [time_ms(run, warmup=2, iters=10)
                            for _ in range(args.rounds)]
        if args.kernels:
            res[f"{key}_by_kernel"] = kernel_ms(run)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
