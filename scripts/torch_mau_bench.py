#!/usr/bin/env python3
"""Times the fused MAU/BiMAU backward, or its forward, on one GPU, whole
and by kernel.

At the flagship train shape (B=512, T=31, H=8, dh=64, E=64, BiMAU, dropout
0.1, bf16), with inputs drawn from a seed as ``chip_smoke.py`` phase 4b
draws them: ``mau_attention_bwd`` over 10 launches (CUDA events, after
warm-up) in each of ``--rounds`` rounds; with ``--kernels`` also its device
time by CUDA kernel (``torch.profiler``, 10 launches). ``--fwd`` times the
forward instead, on phase 4's bf16 inputs (BiMAU): the eval launch
(dropout 0, no residual) and the train launch (the raw residual, dropout
0.1), in rounds as the backward. Prints one JSON line with the card's name
and power limit. Imports neither JAX nor the JAX package; run from the root
of a checkout (or of an older one, to compare two versions in one call):

    python3 scripts/torch_mau_bench.py [--label NAME] [--fwd] [--rounds N]
        [--kernels]
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


def bwd_run():
    """The backward's launch at phase 4b's bf16 inputs, ready to call."""
    args = chip_smoke.mau_inputs(**chip_smoke.FLAGSHIP, dtype=torch.bfloat16,
                                 gathered=False, seed=200)
    q, k, v, t, km, iv, oh, wd, bd, w, sc, qpos = args
    sd = _seed_tensor(5, 0.1, torch.device("cuda"))
    _, _, raw = _launch_fwd(q, k, v, t, km, iv, oh, wd, bd, w, sc, False,
                            True, 8, qpos, sd, 0.1, want_raw=True)
    go, gl = chip_smoke.mau_bwd_args(args, torch.bfloat16, 7)
    return lambda: mau_attention_bwd(
        q, k, v, t, km, iv, oh, wd, bd, w, sc, raw, go, gl, causal=False,
        diag_reset=True, dropout_rate=0.1, dropout_seed=sd, num_heads=8,
        qpos=qpos)


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
    runs = fwd_runs() if args.fwd else {"": bwd_run()}
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
