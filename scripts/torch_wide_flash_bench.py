#!/usr/bin/env python3
"""Times the flash kernels at the Bochner models' wide heads on one GPU.

At L = 2048, B = 8, H = 1, causal, every key live, the shapes TGAT's and
TGREC's flash forms give the kernels: TGAT's q and k 2,048 wide (4 dh)
with v at dh = 512, bf16 and fp32; TGREC's 150 (dh + 2C) in fp32; scale
1/sqrt(dh). Prints, for each shape and each of the two wrappers
(``flash_attention_fwd``, ``flash_attention_bwd``), the kernel's time by
CUDA events at dropout 0 and 0.1, its bound and
F.scaled_dot_product_attention's time on the same inputs (the bound, the
work it counts and SDPA's timing are ``chip_smoke.py``'s, phase 4g's:
``bound``, ``flash_work``, ``sdpa_times``), then the card's name and power
limit, and with ``--label`` one JSON line of the kernels' times under that
label (for ``torch_ablate.py wide``). Imports neither JAX nor the JAX
package; run it from any checkout's root (it imports the package and
``chip_smoke.py`` beside it) to compare two versions in one call:

    python3 scripts/torch_wide_flash_bench.py [--iters 10] [--label NAME]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from chip_smoke import bound, flash_work, sdpa_times, time_ms  # noqa: E402
from easydgl_tpu_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd, flash_attention_fwd, flash_delta)

# (tag, q and k width, v width, dtype, the head the scale is 1/sqrt of)
SHAPES = (("tgat", 2048, 512, torch.bfloat16, 512),
          ("tgat", 2048, 512, torch.float32, 512),
          ("tgrec", 150, 150, torch.float32, 50))
B, T = 8, 2048


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    times = {}
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    for tag, d, dv, dtype, dh in SHAPES:
        q, k = ((0.3 * torch.randn(B, 1, T, d, generator=g, device="cuda"))
                .to(dtype) for _ in range(2))
        v, dout = (torch.randn(B, 1, T, dv, generator=g, device="cuda")
                   .to(dtype) for _ in range(2))
        km = torch.ones(B, T, device="cuda")
        seed = torch.tensor(7, device="cuda")
        kw = dict(causal=True, scale=dh ** -0.5)
        out, lse = flash_attention_fwd(q, k, v, km, **kw)
        bwd = (q, k, v, km, dout, lse, flash_delta(dout, out))
        qs = (q.float() * (d / dh) ** 0.5).to(dtype)   # SDPA scales 1/sqrt(d)
        sdpa = dict(zip(("fwd", "bwd"), sdpa_times(qs, k, v, dout, None)))
        runs = {"fwd": lambda kw: flash_attention_fwd(q, k, v, km, **kw),
                "bwd": lambda kw: flash_attention_bwd(*bwd, **kw)}
        for name, run in runs.items():
            ms = time_ms(lambda: run(kw), warmup=1, iters=args.iters)
            ms_drop = time_ms(lambda: run(dict(kw, dropout_rate=0.1,
                                               seed=seed)),
                              warmup=1, iters=args.iters)
            bound_ms, _ = bound(*flash_work(
                f"flash_attention_{name}", km, h=1, t=T, dh=d, dv=dv,
                dtype=dtype), dtype)
            times[f"{tag}_{str(dtype)[6:]}_{name}_ms"] = ms
            print(f"{tag} {name} {str(dtype)[6:]} width {d} v {dv}: kernel"
                  f" {ms:.4f} ms (dropout 0.1: {ms_drop:.4f}), bound"
                  f" {bound_ms:.4f} ms, SDPA {sdpa[name]:.4f} ms",
                  flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    if args.label is not None:
        print(json.dumps(dict(label=args.label, card=card, **times)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
