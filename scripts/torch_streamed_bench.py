#!/usr/bin/env python3
"""Times the streamed MAU kernels and the EasyDGL-LC eval step on one GPU.

At the EasyDGL-LC eval shape (B=8, T=2048, H=8, dh=64, E=64, BiMAU), with
inputs drawn from a seed: each of ``mau_stats``, ``mau_intensity`` and
``mau_modulated_out`` over 20 launches (CUDA events, after warm-up), in bf16
and fp32; then ``build_eval_step`` of ``PRESETS["EasyDGL-LC"]`` (64 marks,
bf16, random weights from seed 0) over 8 batches of 8 rows, host clock,
synchronised, after one warm-up batch. ``--vjp`` times instead the
intensity head's VJP alone (``mau_intensity_bwd``, fp32 whatever the
compute dtype) at the EasyDGL-LC train shape (B=8, T=2048, H=8, dh=64,
E=64): seq_units from ``mau_stats`` on the bf16 inputs, g_lam ~ N(0,
1e-3), over 10 launches in each of ``--rounds`` rounds; with
``--kernels`` also its device time by kernel (``torch.profiler``, 10
launches). ``--dkvt`` times instead the key-major dK/dV/dT kernel
(``mau_dkvt``) at the EasyDGL-LC train shape (bf16, BiMAU, dropout 0.1),
its stats from ``mau_stats`` and ``mau_intensity``, g_su ~ N(0, 1e-2),
rho ~ N(0, 1e-3), in rounds as ``--vjp``. ``--out`` times instead the
modulated-output kernel (``mau_modulated_out``) alone on ``chip_smoke.py``
phase 4c's bf16 inputs (BiMAU, its stats from ``mau_stats`` and
``mau_intensity``), ``--glam`` the d-lambda kernel (``mau_glam``) alone on
phase 4d's (the plain forward's stats and phase 4d's g_out), each at
dropout 0 and 0.1, in rounds as ``--vjp``; both report the share of the
64-key tiles that hold a real key (``live_key_tile_share``) and the share
of (query tile, key tile) pairs the live-tile rule visits
(``visited_tile_share``). ``--int`` times the intensity head
(``mau_intensity``) alone on phase 4c's bf16 inputs (seq_units from
``mau_stats``), ``--dq`` the dq kernel (``mau_dq``) alone on phase 4d's
(the plain pieces' residuals, g_su and rho), at dropout 0 and 0.1 with its
visible-only rule's share of the pairs (``dq_visited_tile_share``, None in
a checkout whose rule has no such form), each in rounds as ``--vjp``.
``--stats`` times the stats kernel (``mau_stats``) alone on phase 4c's bf16
inputs, with the shares of the live-tile rule, in rounds as ``--vjp``.
Prints one JSON line with the card's name and power limit. Imports neither
JAX nor the JAX package; run from the root of a checkout (or of an older
one, to compare two versions in one call):

    python3 scripts/torch_streamed_bench.py [--label NAME]
        [--vjp | --dkvt | --out | --glam | --int | --dq | --stats]
        [--rounds N]
        [--kernels]
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.getcwd())
from easydgl_tpu_torch.config import preset  # noqa: E402
from easydgl_tpu_torch.data.loader import BatchLoader  # noqa: E402
from easydgl_tpu_torch.data.synthetic import (  # noqa: E402
    synthetic_mark_table, synthetic_split_vectorized)
from easydgl_tpu_torch.eval.metrics import MetricAccumulator  # noqa: E402
from easydgl_tpu_torch.kernels.mau_streamed import (  # noqa: E402
    mau_dkvt, mau_intensity, mau_intensity_bwd, mau_modulated_out, mau_stats)
from easydgl_tpu_torch.models.registry import build_model  # noqa: E402
from easydgl_tpu_torch.parity import random_flax_params  # noqa: E402
from easydgl_tpu_torch.train.steps import build_eval_step  # noqa: E402

B, T, H, DH, E = 8, 2048, 8, 64, 64


def inputs(dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = H * DH
    q, k, v, t = (torch.randn(B, T, c, generator=g, device="cuda").to(dtype)
                  for _ in range(4))
    lengths = torch.randint(1, T + 1, (B,), generator=g, device="cuda")
    km = (torch.arange(T, device="cuda")[None] >= T - lengths[:, None]).float()
    iv = -torch.log(torch.rand(B, T, generator=g, device="cuda"))
    oh = (torch.rand(B, T, E, generator=g, device="cuda") < 0.15).float()
    wd = torch.randn(DH + 1, E * DH, generator=g, device="cuda") * 0.2
    bd = torch.randn(E * DH, generator=g, device="cuda") * 0.1
    w = torch.randn(E, DH, generator=g, device="cuda") * 0.2
    sc = torch.randn(E, generator=g, device="cuda") * 0.3
    return q, k, v, t, km, iv, oh, wd, bd, w, sc


def time_ms(fn, warmup=3, iters=20):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_times(dtype):
    q, k, v, t, km, iv, oh, wd, bd, w, sc = inputs(dtype)
    kw = dict(causal=False, num_heads=H)
    m, l, su = mau_stats(q, k, t, km, **kw)
    lam = mau_intensity(su, iv, wd, bd, w, sc)
    return {
        "mau_stats": time_ms(lambda: mau_stats(q, k, t, km, **kw)),
        "mau_intensity": time_ms(lambda: mau_intensity(su, iv, wd, bd, w,
                                                       sc)),
        "mau_modulated_out": time_ms(lambda: mau_modulated_out(
            q, k, v, km, oh, lam, m, l, diag_reset=True, **kw))}


def kernel_ms(run, iters=10):
    """{kernel: device ms a launch of ``run``} over ``iters`` launches."""
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
    return {e.key[:90]: e.self_device_time_total / iters / 1e3
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def vjp_times(rounds, by_kernel):
    q, k, v, t, km, iv, oh, wd, bd, w, sc = inputs(torch.bfloat16)
    _, _, su = mau_stats(q, k, t, km, causal=False, num_heads=H)
    g = torch.Generator(device="cuda").manual_seed(1)
    g_lam = torch.randn(B, H, T, E, generator=g, device="cuda") * 1e-3

    def run():
        mau_intensity_bwd(su, iv, wd, bd, w, sc, g_lam)

    res = {"vjp_ms": [time_ms(run, warmup=2, iters=10)
                      for _ in range(rounds)]}
    if by_kernel:
        res["vjp_by_kernel"] = kernel_ms(run)
    return res


def dkvt_times(rounds, by_kernel):
    q, k, v, t, km, iv, oh, wd, bd, w, sc = inputs(torch.bfloat16)
    m, l, su = mau_stats(q, k, t, km, causal=False, num_heads=H)
    lam = mau_intensity(su, iv, wd, bd, w, sc)
    g = torch.Generator(device="cuda").manual_seed(2)
    go = (torch.randn(B, T, H * DH, generator=g, device="cuda") * 1e-2
          ).to(torch.bfloat16)
    g_su = torch.randn(B, H, T, DH, generator=g, device="cuda") * 1e-2
    rho = torch.randn(B, H, T, generator=g, device="cuda") * 1e-3
    sd = torch.tensor(7000, dtype=torch.int64, device="cuda")

    def run():
        mau_dkvt(q, k, v, t, km, oh, lam, m, l, go, g_su, rho,
                 diag_reset=True, dropout_rate=0.1, dropout_seed=sd,
                 num_heads=H)

    res = {"dkvt_ms": [time_ms(run, warmup=2, iters=10)
                       for _ in range(rounds)]}
    if by_kernel:
        res["dkvt_by_kernel"] = kernel_ms(run)
    return res


def tile_shares(km, causal=False):
    """(share of the 64-key tiles holding a real key, share of the (query
    tile, key tile) pairs that the live-tile rule visits, None in a
    checkout that has no such rule) of a key mask."""
    from easydgl_tpu_torch.kernels import mau_streamed
    live = (F.pad(km > 0, (0, -km.shape[1] % 64)).view(km.shape[0], -1, 64)
            .any(-1))
    rule = getattr(mau_streamed, "streamed_visited_tiles", None)
    vis = None if rule is None else float(
        rule(km, km.shape[1], causal).float().mean())
    return float(live.float().mean()), vis


def out_times(rounds, by_kernel):
    """mau_modulated_out alone on phase 4c's bf16 inputs, dropout 0 and
    0.1."""
    import chip_smoke
    q, k, v, t, km, iv, oh, wd, bd, w, sc, _ = chip_smoke.mau_inputs(
        **chip_smoke.LC, dtype=torch.bfloat16, gathered=False, seed=400)
    kw = dict(causal=False, num_heads=H)
    m, l, su = mau_stats(q, k, t, km, **kw)
    lam = mau_intensity(su, iv, wd, bd, w, sc)
    sd = torch.tensor(4000, dtype=torch.int64, device="cuda")
    live, visited = tile_shares(km)
    res = {"live_key_tile_share": live, "visited_tile_share": visited}
    for rate in (0.0, 0.1):
        def run():
            mau_modulated_out(q, k, v, km, oh, lam, m, l, diag_reset=True,
                              dropout_rate=rate, dropout_seed=sd, **kw)
        res[f"out_ms_drop{rate:g}"] = [time_ms(run, warmup=2, iters=10)
                                      for _ in range(rounds)]
        if by_kernel:
            res[f"out_by_kernel_drop{rate:g}"] = kernel_ms(run)
    return res


def glam_times(rounds, by_kernel):
    """mau_glam alone on phase 4d's bf16 inputs, dropout 0 and 0.1."""
    import chip_smoke
    args = chip_smoke.mau_inputs(**chip_smoke.LC, dtype=torch.bfloat16,
                                 gathered=False, seed=700)
    live, visited = tile_shares(args[4])
    res = {"live_key_tile_share": live, "visited_tile_share": visited}
    for rate in (0.0, 0.1):
        _, _, runs = chip_smoke.streamed_bwd_pieces(
            args, H, causal=False, diag=True, rate=rate, seed=7000,
            plain_fwd=None)
        run = runs["mau_glam"][0]
        del runs
        res[f"glam_ms_drop{rate:g}"] = [time_ms(run, warmup=2, iters=10)
                                       for _ in range(rounds)]
        if by_kernel:
            res[f"glam_by_kernel_drop{rate:g}"] = kernel_ms(run)
    return res


def int_times(rounds, by_kernel):
    """mau_intensity alone on phase 4c's bf16 inputs."""
    import chip_smoke
    q, k, v, t, km, iv, oh, wd, bd, w, sc, _ = chip_smoke.mau_inputs(
        **chip_smoke.LC, dtype=torch.bfloat16, gathered=False, seed=400)
    _, _, su = mau_stats(q, k, t, km, causal=False, num_heads=H)

    def run():
        mau_intensity(su, iv, wd, bd, w, sc)

    res = {"int_ms": [time_ms(run, warmup=2, iters=10)
                      for _ in range(rounds)]}
    if by_kernel:
        res["int_by_kernel"] = kernel_ms(run)
    return res


def stats_times(rounds, by_kernel):
    """mau_stats alone on phase 4c's bf16 inputs."""
    import chip_smoke
    q, k, v, t, km, *_ = chip_smoke.mau_inputs(
        **chip_smoke.LC, dtype=torch.bfloat16, gathered=False, seed=400)
    live, visited = tile_shares(km)

    def run():
        mau_stats(q, k, t, km, causal=False, num_heads=H)

    res = {"live_key_tile_share": live, "visited_tile_share": visited,
           "stats_ms": [time_ms(run, warmup=2, iters=10)
                        for _ in range(rounds)]}
    if by_kernel:
        res["stats_by_kernel"] = kernel_ms(run)
    return res


def dq_times(rounds, by_kernel):
    """mau_dq alone on phase 4d's bf16 inputs, dropout 0 and 0.1."""
    import chip_smoke
    from easydgl_tpu_torch.kernels import mau_streamed
    args = chip_smoke.mau_inputs(**chip_smoke.LC, dtype=torch.bfloat16,
                                 gathered=False, seed=700)
    km = args[4]
    live, visited = tile_shares(km)
    rule = getattr(mau_streamed, "streamed_visited_tiles", None)
    dq_vis = None
    if rule is not None and "visible_only" in inspect.signature(
            rule).parameters:
        dq_vis = float(rule(km, T, False, visible_only=True).float().mean())
    res = {"live_key_tile_share": live, "visited_tile_share": visited,
           "dq_visited_tile_share": dq_vis}
    for rate in (0.0, 0.1):
        _, _, runs = chip_smoke.streamed_bwd_pieces(
            args, H, causal=False, diag=True, rate=rate, seed=7000,
            plain_fwd=None)
        run = runs["mau_dq"][0]
        del runs
        res[f"dq_ms_drop{rate:g}"] = [time_ms(run, warmup=2, iters=10)
                                     for _ in range(rounds)]
        if by_kernel:
            res[f"dq_by_kernel_drop{rate:g}"] = kernel_ms(run)
    return res


def eval_seqs_per_s(batches=8):
    cfg = preset("EasyDGL-LC", num_events=64)
    model = build_model(cfg, device="cuda",
                        params=random_flax_params(cfg, seed=0))
    table = synthetic_mark_table(cfg.num_items, cfg.num_events, seed=0)
    split = synthetic_split_vectorized(num_rows=(batches + 1) * B,
                                       num_items=cfg.num_items,
                                       seqslen=cfg.seqslen, seed=4)
    data = list(BatchLoader(split, data_mode="mau", batch_size=B,
                            masklen=cfg.masklen, is_training=False).epoch(0))
    step = build_eval_step(model, mark_table=table)
    MetricAccumulator().update(step(model, *data[0]))
    torch.cuda.synchronize()
    acc = MetricAccumulator()
    t0 = time.perf_counter()
    for features, labels, valid in data[1:]:
        acc.update(step(model, features, labels, valid))
    torch.cuda.synchronize()
    return batches * B / (time.perf_counter() - t0)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    ap.add_argument("--vjp", action="store_true")
    ap.add_argument("--dkvt", action="store_true")
    ap.add_argument("--out", action="store_true")
    ap.add_argument("--glam", action="store_true")
    ap.add_argument("--int", action="store_true")
    ap.add_argument("--dq", action="store_true")
    ap.add_argument("--stats", action="store_true")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--kernels", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_streamed_bench: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    alone = [fn for flag, fn in ((args.vjp, vjp_times),
                                 (args.dkvt, dkvt_times),
                                 (args.out, out_times),
                                 (args.glam, glam_times),
                                 (args.int, int_times),
                                 (args.dq, dq_times),
                                 (args.stats, stats_times)) if flag]
    if alone:
        times = alone[0](args.rounds, args.kernels)
        print(json.dumps({"label": args.label, "card": card, **times}),
              flush=True)
        return 0
    res = {"label": args.label, "card": card,
           "ms_bf16": kernel_times(torch.bfloat16),
           "ms_fp32": kernel_times(torch.float32),
           "lc_eval_seqs_per_s": eval_seqs_per_s()}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
