#!/usr/bin/env python3
"""Where the time of the port's eval step goes, on one GPU.

Runs ``build_eval_step`` of easydgl_tpu_torch for a preset (default
``EasyDGL``; ``EasyDGL-LC`` is the long-context flagship, L+1 = 2048, B = 8;
``SASREC-LC`` the long-context SASRec, L = 2048, B = 32) with bf16 matmuls
(EasyDGL: 64 marks), random weights from seed 0 and the preset's batch
size, over a synthetic split under ``torch.profiler``, and prints the
device time by kernel, the share of the window the device was busy, and
the host wall time per batch. Imports neither JAX nor the JAX package.

    python3 scripts/torch_eval_profile.py [PRESET] [--batches 8]
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from easydgl_tpu_torch.config import preset  # noqa: E402
from easydgl_tpu_torch.data.loader import BatchLoader  # noqa: E402
from easydgl_tpu_torch.data.synthetic import (  # noqa: E402
    synthetic_mark_table, synthetic_split_vectorized)
from easydgl_tpu_torch.eval.metrics import MetricAccumulator  # noqa: E402
from easydgl_tpu_torch.models.registry import build_model  # noqa: E402
from easydgl_tpu_torch.parity import random_flax_params  # noqa: E402
from easydgl_tpu_torch.train.steps import build_eval_step  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("preset", nargs="?", default="EasyDGL")
    ap.add_argument("--batches", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_eval_profile: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = preset(args.preset, num_events=64, compute_dtype="bfloat16")
    model = build_model(cfg, device="cuda",
                        params=random_flax_params(cfg, seed=0))
    table = (synthetic_mark_table(cfg.num_items, cfg.num_events, seed=0)
             if model.uses_tpp else None)
    split = synthetic_split_vectorized(num_rows=args.batches * cfg.batch_size,
                                       num_items=cfg.num_items,
                                       seqslen=cfg.seqslen, seed=0)
    batches = list(BatchLoader(split, data_mode=model.data_mode,
                               batch_size=cfg.batch_size, masklen=cfg.masklen,
                               is_training=False).epoch(0))
    step = build_eval_step(model, mark_table=table)
    MetricAccumulator().update(step(model, *batches[0]))  # warm-up
    torch.cuda.synchronize()

    acc = MetricAccumulator()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for features, labels, valid in batches:
            acc.update(step(model, features, labels, valid))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in events)
    print(f"{torch.cuda.get_device_name(0)}; {args.preset}:"
          f" {len(batches)} batches x "
          f"{cfg.batch_size} rows: wall {wall * 1e3 / len(batches):.3f} ms"
          f"/batch (profiled), device busy {total_us / 1e3 / len(batches):.3f}"
          f" ms/batch = {100 * total_us / 1e6 / wall:.1f}% of the window")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        per_batch = e.self_device_time_total / 1e3 / len(batches)
        print(f"  {per_batch:8.3f} ms/batch"
              f" {100 * e.self_device_time_total / max(total_us, 1):5.1f}%"
              f"  x{e.count // len(batches):<3d} {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
