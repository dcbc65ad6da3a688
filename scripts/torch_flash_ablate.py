#!/usr/bin/env python3
"""Times variants of the bf16 flash backward kernel with one part taken
out, on one GPU, to show where its time goes.

Each variant edits ``csrc/flash_attention.cu`` in a copy of the package
(with ``chip_smoke.py`` and ``scripts/torch_flash_bench.py``) in a temporary
directory: the dQ reduction removed, the exp removed, the per-entry mask
test removed, one consumer warpgroup instead of two, and so on. The variants compute wrong gradients; only their times
mean something. All copies are built first (one nvcc each, all started
together), then ``torch_flash_bench.py`` runs in each copy in turn, the
unchanged source first and last. Prints one JSON line a copy, and the card's
name and power limit. Imports neither JAX nor the JAX package.

    python3 scripts/torch_flash_ablate.py [VARIANT ...]
"""
from __future__ import annotations

import pathlib
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCE = "easydgl_tpu_torch/kernels/csrc/flash_attention.cu"
# name -> [(old text, new text), ...] applied to the copy's SOURCE
VARIANTS = {
    "control": [],
    "no dQ reduction": [(
        "      tma_reduce_add(&maps.dq, dqw, 0, q0, h, b);\n"
        "      tma_reduce_add(&maps.dq, dqw + 2048, 32, q0, h, b);\n", "")],
    "no exp": [(
        "const float pr = fast_exp2(vis ? fmaf(sa[x], sl2, -lse2) : -INFINITY);",
        "const float pr = vis ? fmaf(sa[x], sl2, -lse2) : 0.f;")],
    "no entry test": [(
        "    const bool test = test_entries(p, code, q0, kw);\n"
        "    const float* lq = stats + s * 2 * BQ;",
        "    const bool test = false;\n"
        "    const float* lq = stats + s * 2 * BQ;")],
    "1 warpgroup": [("constexpr int kTcGroups = 2;",
                     "constexpr int kTcGroups = 1;")],
    "3 stages": [("constexpr int kTcStages = 2;",
                  "constexpr int kTcStages = 3;")],
}
COPY = ("easydgl_tpu_torch", "chip_smoke.py", "scripts/torch_flash_bench.py")


def main(names) -> int:
    names = names or list(VARIANTS)
    text = (ROOT / SOURCE).read_text()
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {}
        for i, name in enumerate(names):
            d = pathlib.Path(tmp) / f"v{i}"
            for item in COPY:
                src, dst = ROOT / item, d / item
                dst.parent.mkdir(parents=True, exist_ok=True)
                if src.is_dir():
                    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
                        "__pycache__"))
                else:
                    shutil.copy(src, dst)
            edited = text
            for old, new in VARIANTS[name]:
                if edited.count(old) != 1:
                    raise SystemExit(f"{name}: the edit does not apply")
                edited = edited.replace(old, new)
            (d / SOURCE).write_text(edited)
            dirs[name] = d
        build = ("from easydgl_tpu_torch.kernels import build;"
                 " build.build(['flash_attention'])")
        procs = [subprocess.Popen([sys.executable, "-c", build], cwd=d)
                 for d in dirs.values()]
        if any(p.wait() != 0 for p in procs):
            raise SystemExit("a build failed")
        order = list(names) + (["control"] if "control" in names else [])
        for name in order:
            out = subprocess.run(
                [sys.executable, "scripts/torch_flash_bench.py", "--label",
                 name], cwd=dirs[name], capture_output=True, text=True,
                timeout=600)
            if out.returncode != 0:
                print(out.stderr[-2000:], file=sys.stderr)
                return 1
            print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
