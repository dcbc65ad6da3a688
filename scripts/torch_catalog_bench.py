#!/usr/bin/env python3
"""Times the catalog NLL backward, or forward, kernels on one GPU.

At SASREC-LC's training shape (N = B*L = 65,536 rows, V = 17,771, C = 512,
bf16; the inputs of ``chip_smoke.catalog_inputs``, seed 310 as phase 4f):
the backward with every row live, and with the padded positions of one
SASREC-LC train batch (label 0, dlse = dll = 0, the train step's weights);
then at the flagship's N = 3,072, V = 17,772 (seed 300, as phase 4b). Each
over 10 launches (CUDA events, after warm-up). ``--dtype float32`` times
the fp32 kernel (the CUDA cores) at N = 3,072 alone. ``--kernels`` adds each
case's device time by kernel (``torch.profiler``, 10 launches).
``--splits SH,ST ...`` times the SASREC-LC cases again with d_hidden's vocab
splits and d_table's row-tile splits forced to each pair (the library's own
choice is the first timing). ``--forward`` times ``catalog_nll_fwd`` (the
forward and the merge of its splits) at N = 65,536 and 3,072 instead, and
``--splits S ...`` then forces its vocab splits (only where the
checkout's forward takes forced splits; older ones do not). Prints
one JSON line with the card's name and power limit. Imports neither JAX
nor the JAX package. Run from the root of a checkout; it takes the package
and ``chip_smoke.py`` of the working directory, so running it from an older
checkout in the same call compares two versions:

    python3 scripts/torch_catalog_bench.py [--label NAME] [--rounds N]
        [--dtype bfloat16|float32] [--kernels] [--forward]
        [--splits SH,ST ... | --forward --splits S ...]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.getcwd())
import chip_smoke  # noqa: E402
from easydgl_tpu_torch.config import preset  # noqa: E402
from easydgl_tpu_torch.data.loader import BatchLoader  # noqa: E402
from easydgl_tpu_torch.data.synthetic import \
    synthetic_split_vectorized  # noqa: E402
from easydgl_tpu_torch.kernels.scoring import (catalog_nll_bwd,  # noqa: E402
                                               catalog_nll_fwd)

SASREC_LC = dict(n=65536, v=17771, c=512)
FLAGSHIP = dict(n=3072, v=17772, c=512)


def padded_rows() -> torch.Tensor:
    """(B * L,) bool: label 0 in one SASREC-LC train batch (seed 16, as
    ``chip_smoke.sasrec_lc_padded_rows``)."""
    cfg = preset("SASREC-LC")
    split = synthetic_split_vectorized(num_rows=cfg.batch_size,
                                       num_items=cfg.num_items,
                                       seqslen=cfg.seqslen, seed=16)
    loader = BatchLoader(split, data_mode="regressive",
                         batch_size=cfg.batch_size, is_training=True)
    _, labels, _ = next(iter(loader.epoch(0)))
    return torch.as_tensor(labels.reshape(-1) == 0, device="cuda")


def forward_case(shape, seed, dtype, splits=None):
    h, t, b, lab, _, _ = chip_smoke.catalog_inputs(**shape, dtype=dtype,
                                                   seed=seed)
    if splits is not None:
        from easydgl_tpu_torch.kernels.scoring import _launch_fwd
        return lambda: _launch_fwd(h, t, b, lab, splits=splits)
    return lambda: catalog_nll_fwd(h, t, b, lab)


def case(shape, seed, dtype, dead=None, splits=None):
    h, t, b, lab, dlse, dll = chip_smoke.catalog_inputs(
        **shape, dtype=dtype, seed=seed)
    if dead is not None:
        lab[dead], dlse[dead], dll[dead] = 0, 0.0, 0.0
    lse, _ = catalog_nll_fwd(h, t, b, lab)
    if splits is not None:
        from easydgl_tpu_torch.kernels.scoring import _launch_bwd
        return lambda: _launch_bwd(h, t, b, lab, lse, dlse, dll,
                                   splits=splits)
    return lambda: catalog_nll_bwd(h, t, b, lab, lse, dlse, dll)


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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--forward", action="store_true")
    ap.add_argument("--splits", nargs="*", default=[])
    args = ap.parse_args()
    dtype = getattr(torch, args.dtype)
    if not torch.cuda.is_available():
        print("torch_catalog_bench: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    res = dict(label=args.label, card=card, dtype=args.dtype)
    if args.forward:
        cases = [(f"fwd_ms_n{shape['n']}{'' if s is None else f'_splits_{s}'}",
                  shape, seed, s)
                 for s in [None] + [int(x) for x in args.splits]
                 for shape, seed in ((SASREC_LC, 310), (FLAGSHIP, 300))]
        for name, shape, seed, splits in cases:
            run = forward_case(shape, seed, dtype, splits)
            res[name] = [chip_smoke.time_ms(run, warmup=2, iters=10)
                         for _ in range(args.rounds)]
            if args.kernels:
                res[name + "_by_kernel"] = kernel_ms(run)
            del run
        print(json.dumps(res), flush=True)
        return 0
    cases = [("bwd_ms_n3072", FLAGSHIP, 300, None, None)]
    if dtype == torch.bfloat16:
        lc = [("bwd_ms_n65536_all_live", None), ("bwd_ms_n65536_padded",
                                                  padded_rows())]
        cases = [(name, SASREC_LC, 310, dead, None) for name, dead in lc
                 ] + cases + [
            (f"{name}_splits_{pair}", SASREC_LC, 310, dead,
             tuple(int(x) for x in pair.split(",")))
            for pair in args.splits for name, dead in lc]
    for name, shape, seed, dead, splits in cases:
        run = case(shape, seed, dtype, dead, splits)
        res[name] = [chip_smoke.time_ms(run, warmup=2, iters=10)
                     for _ in range(args.rounds)]
        if args.kernels:
            res[name + "_by_kernel"] = kernel_ms(run)
        del run
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
