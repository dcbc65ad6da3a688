#!/usr/bin/env python3
"""Where the time of the port's faithful train step goes, on one GPU.

Runs ``build_train_step`` of easydgl_tpu_torch for a preset (default
``EasyDGL``, batch 512; ``EasyDGL-LC`` is the long-context flagship, L+1 =
2048, B = 8, masklen 256; ``SASREC-LC`` the long-context SASRec, L = 2048,
B = 32, every position scored; ``BERT4REC-LC`` the long-context BERT4Rec,
L+1 = 2048, B = 32, masklen 256, non-causal flash attention; ``BERT4REC``
at B = 512; ``CTSMA`` at B = 512, L = 30, the fused MAU kernels causal at
dh = 128; ``CTSMA-LC``, L = 2048, B = 8, the streamed kernels causal;
``GRU4REC``, ``S2PNM`` and ``TiSASREC`` at B = 512, L = 30: the GRU
recurrence and the interval attention in plain ops, the catalog kernels;
``TGAT`` (B = 512) and ``TGREC`` (B = 128, C = 50) at L = 30: the dense
Bochner time attention in plain ops, the catalog kernels; ``GREC`` at
B = 512, L+1 = 31: the dilated convolutions in fp32 GEMMs, the catalog
kernels at its untied head (N = 3,072, V = 17,773); ``TimelyREC`` at
B = 512, L = 30, the datetime fields: the user tower, the four MAT
encoders and TAHE in plain ops, the catalog kernels)
with bf16 matmuls, the preset's dropout and loss terms (EasyDGL and CTSMA:
TPP and L2, 64 marks looked up on the device; BERT4REC: sparse_ce and L2),
TF-Adam, random weights from seed 0, over synthetic batches of the
model's protocol already on the device, first unprofiled (host clock,
synchronised) and then under ``torch.profiler``, and prints the host wall
time per step of both runs, the device time by kernel, the device kernels
launched a step and the share of the profiled window the device was busy.
Imports neither JAX nor the JAX package; run it from any checkout's root
(it imports the package beside it) to compare two versions in one call.
It also prints the host's time by operator. With ``--sharded`` the step
is ``build_sharded_train_step`` on a (1, 1) mesh under an NCCL process
group of one rank (``core/runtime.py``).

    python3 scripts/torch_train_profile.py [PRESET] [--steps 8] [--sharded]
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
from easydgl_tpu_torch.models.registry import build_model  # noqa: E402
from easydgl_tpu_torch.parity import random_flax_params  # noqa: E402
from easydgl_tpu_torch.train.steps import (build_train_step,  # noqa: E402
                                           init_state, to_device)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("preset", nargs="?", default="EasyDGL")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--sharded", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = preset(args.preset, num_events=64, compute_dtype="bfloat16")
    bs = cfg.batch_size
    model = build_model(cfg, device="cuda",
                        params=random_flax_params(cfg, seed=0))
    table = (synthetic_mark_table(cfg.num_items, cfg.num_events, seed=0)
             if model.uses_tpp else None)
    split = synthetic_split_vectorized(num_rows=4 * bs,
                                       num_items=cfg.num_items,
                                       seqslen=cfg.seqslen, seed=0,
                                       with_datetime=True)
    batches = [(to_device(f, "cuda"), torch.as_tensor(lab, device="cuda"))
               for f, lab, _ in BatchLoader(
                   split, data_mode=model.data_mode, batch_size=bs,
                   masklen=cfg.masklen, is_training=True).epoch(0)]
    step = build_train_step(model, mark_table=table)
    state = init_state(model)
    if args.sharded:
        from easydgl_tpu_torch.config import MeshConfig
        from easydgl_tpu_torch.core.mesh import make_mesh
        from easydgl_tpu_torch.core.runtime import init_distributed
        from easydgl_tpu_torch.train.sharded import (
            build_sharded_train_step, shard_state)
        init_distributed(None, 1, 0, "cuda")
        mesh = make_mesh(MeshConfig(dp=1, mp=1), "cuda")
        state = shard_state(state, model, mesh)
        step = build_sharded_train_step(model, mesh, mark_table=table)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for features, labels in batches[:2]:  # warm-up
        state, _ = step(state, features, labels, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(args.steps):
        features, labels = batches[i % len(batches)]
        state, loss = step(state, features, labels, gen)
    torch.cuda.synchronize()
    unprofiled = (time.perf_counter() - t0) * 1e3 / args.steps

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(args.steps):
            features, labels = batches[i % len(batches)]
            state, loss = step(state, features, labels, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = args.steps
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in events)
    launches = sum(e.count for e in events) / n
    print(f"{torch.cuda.get_device_name(0)}; {args.preset}"
          f"{' sharded (1, 1)' if args.sharded else ''}: {n} train steps"
          f" x {bs} rows:"
          f" wall {unprofiled:.3f} ms/step unprofiled,"
          f" {wall * 1e3 / n:.3f} ms/step profiled; device busy"
          f" {total_us / 1e3 / n:.3f} ms/step ="
          f" {100 * total_us / 1e6 / wall:.1f}% of the window;"
          f" {launches:.0f} device kernels a step;"
          f" loss {float(loss):.5f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:25]:
        per_step = e.self_device_time_total / 1e3 / n
        print(f"  {per_step:8.3f} ms/step"
              f" {100 * e.self_device_time_total / max(total_us, 1):5.1f}%"
              f"  x{e.count // n:<3d} {e.key[:90]}")
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    print("  host time by operator (self, profiled):")
    for e in host[:20]:
        print(f"  {e.self_cpu_time_total / 1e3 / n:8.3f} ms/step"
              f"  x{e.count // n:<4d} {e.key[:90]}")
    if args.sharded:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
