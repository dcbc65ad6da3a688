#!/usr/bin/env python3
"""Times variants of a hand-written kernel with one part taken out, on one
GPU, to show where its time goes.

Twelve kernels: the bf16 flash backward (``flash``: the dQ reduction, the
exp, the per-entry mask test removed, one consumer warpgroup instead of
two, three stages), the bf16 catalog forward at C = 512 (``catalog_fwd``:
the exponentials, or the products, removed), the intensity VJP (``vjp``:
the products removed, or the column kernel at four blocks an SM, as the
row kernel runs), the bf16 fused MAU backward (``mau_bwd``: the sigmoid's
one-op form (tanh.approx), its intensity products or its dx^T product cut
to their first k step, the dx^T reduce-add removed; by kernel;
``mau_bwd_ctsma`` the same at the CTSMA train shape, dh = 128), the bf16 streamed dK/dV/dT kernel (``dkvt``: the
Philox draw or the products removed, every key tile visited, three
stages), the bf16 streamed output and d-lambda kernels (``out`` and
``glam``, at dropout 0 and 0.1: the Philox draw or the products removed,
every key tile of the range visited, four ring stages instead of two,
every tile's entries formed with their tests, two consumer warpgroups a
block instead of three), the streamed intensity head (``int``: its
products removed, the sigmoid's one-op form (tanh.approx), two consumer
warpgroups a block instead of three), the bf16
streamed dq kernel (``dq``, at dropout 0 and 0.1: the Philox draw or the
products removed, every key tile of the range visited), the bf16 fused
MAU forward (``mau_fwd``, eval and train, by kernel: the intensity head's
product removed; the head alone, the attention kernels not launched; one
consumer warpgroup a block, so that Wd is read from L2 for every 64 rows
(1.14 GB a launch, 0.38 GB at three); the sigmoid's reciprocal by three
Newton steps on the FMA pipe instead of the special-function unit's) and
the bf16 streamed stats kernel (``stats``: the live-tile rule off, every
key tile visited; expf in place of ex2), and the wide flash kernels
(``wide``, ``flash_wide.cu`` at TGAT's and TGREC's heads, bf16 on
``mma.sync`` and fp32: the backward's atomic additions of dq, dk and dv
made plain stores, the products removed (the ldmatrix loads stay), two
forward ring slots instead of three). Each variant edits
the kernel's source in a copy of the package (with ``chip_smoke.py`` and the
kernel's bench) in a temporary directory. The variants with a part removed
compute wrong results; only their times mean something. All copies are
built first (one nvcc each, all started together), then the bench runs in
each copy in turn, the unchanged source first and last. Prints one JSON
line a copy, with the card's name and power limit. Imports neither JAX nor
the JAX package.

    python3 scripts/torch_ablate.py
        flash|catalog_fwd|vjp|mau_bwd|mau_bwd_ctsma|dkvt|out|glam|int|dq|
        mau_fwd|stats|wide [VARIANT ...]
"""
from __future__ import annotations

import pathlib
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = "easydgl_tpu_torch/kernels/csrc/"
# the live-tile rule of mau_streamed.cuh off: every key tile of the range
# visited (an edit of another file than the kernel's source names it first)
RULE_OFF = ("mau_streamed.cuh", "    return bl || code != 0;",
            "    return true;")
# the fused MAU backward's three products (mau_bwd_int_tc) cut to their
# first k step (of four or eight): taken out whole, with or without their
# wgmma fence, commit and wait, they made nvcc crash (a segmentation fault)
Z_STEP = ("kk < 4 * KH; ++kk)\n        wgmma_ss<1, 0>(zt,",
          "kk < 1; ++kk)\n        wgmma_ss<1, 0>(zt,")
Z_STEP_RS = ("for (int kk = 0; kk < 4; ++kk) wgmma_rs<0>(zt,",
             "for (int kk = 0; kk < 1; ++kk) wgmma_rs<0>(zt,")
DWD_STEP = ("kk < 4; ++kk)\n        wgmma_rs<1>(gwd[lh],",
            "kk < 1; ++kk)\n        wgmma_rs<1>(gwd[lh],")
DX_STEP = ("kk < 2 * 4; ++kk)\n        wgmma_ss_n32(xt,",
           "kk < 1; ++kk)\n        wgmma_ss_n32(xt,")
# four ring stages instead of kQmStages
FOUR_STAGES = ("mau_streamed.cuh", "constexpr int kQmStages = 2;",
               "constexpr int kQmStages = 4;")
# every tile's entries formed with their tests, as the partial tiles' are
TESTED = ("    else if (slow)\n      form(std::true_type(), std::false_type());\n"
          "    else\n      form(std::false_type(), std::false_type());",
          "    else\n      form(slow, std::false_type());")
# the output and d-lambda kernels' entries without their dropout factor
NO_DRAW = ("            if constexpr (decltype(dropped)::value) u *= "
           "drop.factor(b, h, i, j);\n")
# keeps the bf16 fragments of a removed product alive
SINK = ("__uint_as_float({0}[4 * kk]) + __uint_as_float({0}[4 * kk + 1]) + "
        "__uint_as_float({0}[4 * kk + 2]) + __uint_as_float({0}[4 * kk + 3])")
# the intensity head both forwards share
HEAD = "intensity_head.cuh"
# the sigmoid's one-op form, defined at the top of a source's namespace
SIG1 = ("\nnamespace {\n",
        "\nnamespace {\n__device__ __forceinline__ float sig1(float z) { float y;"
        " asm(\"tanh.approx.f32 %0, %1;\" : \"=f\"(y) : \"f\"(0.5f * z));"
        " return fmaf(0.5f, y, 0.5f); }\n")
# kernel -> (source, library, bench command, {variant: [(old, new), ...]})
# the bf16 fused MAU backward's variants (mau_bwd, mau_bwd_ctsma)
MAU_BWD = {
    "control": [],
    "one-op sigmoid": [(
        "__floats2bfloat162_rn(sigmoid(fmaf(",
        "__floats2bfloat162_rn(sig1(fmaf("), (
        "                                  sigmoid(fmaf(",
        "                                  sig1(fmaf("), SIG1],
    "products at one k step": [Z_STEP, Z_STEP_RS, DWD_STEP, DX_STEP],
    "dx^T product at one k step": [DX_STEP],
    "no dx^T reduce-add": [(
        "        tma_reduce_add_2d(&maps.dseq, sth, r0 + 32 *"
        " wg, 64 * lh);\n", "")]}
KERNELS = {
    "flash": ("flash_attention.cu", "flash_attention",
              ["scripts/torch_flash_bench.py"], {
                  "control": [],
                  "no dQ reduction": [(
                      "      tma_reduce_add(&maps.dq, dqw, 0, q0, h, b);\n"
                      "      tma_reduce_add(&maps.dq, dqw + 2048, 32, q0, h,"
                      " b);\n", "")],
                  "no exp": [(
                      "const float pr = fast_exp2(vis ? fmaf(sa[x], sl2, "
                      "-lse2) : -INFINITY);",
                      "const float pr = vis ? fmaf(sa[x], sl2, -lse2) : "
                      "0.f;")],
                  "no entry test": [(
                      "    const bool test = test_entries(p, code, q0, kw);\n"
                      "    const float* lq = stats + s * 2 * BQ;",
                      "    const bool test = false;\n"
                      "    const float* lq = stats + s * 2 * BQ;")],
                  "1 warpgroup": [("constexpr int kTcGroups = 2;",
                                   "constexpr int kTcGroups = 1;")],
                  "3 stages": [("constexpr int kTcStages = 2;",
                                "constexpr int kTcStages = 3;")]}),
    "catalog_fwd": ("catalog_nll.cu", "catalog_nll",
                    ["scripts/torch_catalog_bench.py", "--forward",
                     "--kernels"], {
                        "control": [],
                        "no exp": [(
                            "sum += fast_exp2(sc[4 * n + 2 * hr + c] - mx);",
                            "sum += sc[4 * n + 2 * hr + c] - mx;")],
                        "no products": [(
                            "      for (int kk = 0; kk < 4; ++kk) "
                            "wgmma_ss_n128(sc, rd + 512 * kc + 2 * kk, "
                            "vd + 2 * kk, 1);\n",
                            "")]}),
    "vjp": ("mau_streamed_bwd.cu", "mau_streamed_bwd",
            ["scripts/torch_streamed_bench.py", "--vjp", "--kernels"], {
                "control": [],
                "no products": [(
                    "hopper.cuh",
                    "  wgmma_rs<TB>(d, a_lo, b_hi);\n"
                    "  wgmma_rs<TB>(d, a_hi, b_lo);\n"
                    "  wgmma_rs<TB>(d, a_hi, b_hi);\n", "")],
                "columns at 4 blocks an SM": [(
                    "__global__ void __launch_bounds__(kIntThreads) "
                    "mau_int_bwd_cols_tc_kernel",
                    "__global__ void __launch_bounds__(kIntThreads, 4) "
                    "mau_int_bwd_cols_tc_kernel")]}),
    "mau_bwd": ("mau_attention_bwd.cu", "mau_attention_bwd",
                ["scripts/torch_mau_bench.py", "--kernels"], MAU_BWD),
    # the same at the CTSMA train shape (dh = 128, causal, dropout 0.2)
    "mau_bwd_ctsma": ("mau_attention_bwd.cu", "mau_attention_bwd",
                      ["scripts/torch_mau_bench.py", "--ctsma", "--kernels"],
                      MAU_BWD),
    "dkvt": ("mau_streamed_bwd.cu", "mau_streamed_bwd",
             ["scripts/torch_streamed_bench.py", "--dkvt", "--kernels"], {
                 "control": [],
                 "no Philox draw": [(
                     "            if constexpr (decltype(dropped)::value) u *= "
                     "drop.factor(b, h, i, jk[hr]);\n", "")],
                 "no products": [
                     ("    for (int kk = 0; kk < 4; ++kk) wgmma_ss<0, 0>(sa, kd"
                      " + 2 * kk, qd + 2 * kk, 1);  // K Q^T\n", ""),
                     ("    for (int kk = 0; kk < 4; ++kk) wgmma_ss<0, 0>(xa, td"
                      " + 2 * kk, gd + 2 * kk, 1);  // T g_su^T\n", ""),
                     ("    for (int kk = 0; kk < 4; ++kk) wgmma_rs(dt, f + 4 *"
                      " kk, gd + 128 * kk);  // dT += P^T g_su\n", ""),
                     ("        wgmma_ss<0, 0>(ia, od + 512 * c + 2 * kk, ld + 512"
                      " * c + 2 * kk, 1);  // one-hot lam^T\n", "        ;\n"),
                     ("    for (int kk = 0; kk < 4; ++kk) wgmma_rs(dv, f + 4 *"
                      " kk, dd + 128 * kk);  // dV += U^T dO\n", ""),
                     ("    for (int kk = 0; kk < 4; ++kk) wgmma_ss<0, 0>(sa, vd"
                      " + 2 * kk, dd + 2 * kk, 1);  // V dO^T\n", ""),
                     ("    for (int kk = 0; kk < 4; ++kk) wgmma_rs(dk, f + 4 *"
                      " kk, qd + 128 * kk);  // dK += G_s^T Q\n", "")],
                 "every key tile visited": [RULE_OFF],
                 "3 stages": [("constexpr int kKvStages = 2;",
                               "constexpr int kKvStages = 3;")]}),
    "out": ("mau_streamed_fwd.cu", "mau_streamed_fwd",
            ["scripts/torch_streamed_bench.py", "--out", "--rounds", "1"], {
                "control": [],
                "no Philox draw": [(NO_DRAW, "")],
                "no products": [
                    ("      wgmma_ss<0, 0>(sa, qd + step, kd + step, 1);\n",
                     "      ;\n"),
                    ("        wgmma_ss<0, 0>(ia, ld + 512 * c + 2 * kk, od + 512"
                     " * c + 2 * kk, 1);\n", "        ;\n"),
                    ("      for (int c = 0; c < NS; ++c) wgmma_rs(o[c], pf + 4 *"
                     " kk, vd + 512 * c + 128 * kk);  // O += U V\n",
                     "      for (int c = 0; c < NS; ++c) o[c][kk] += "
                     + SINK.format("pf") + ";\n")],
                "every key tile visited": [RULE_OFF],
                "four stages": [FOUR_STAGES],
                "every tile's entries tested": [TESTED],
                "two warpgroups a block": [
                    ("{ns == 1 ? 3 : 2, 1}", "{2, 1}"),
                    ("    case 7: return go(mau_out_tc_kernel<1, 3>,",
                     "    case 6: return go(mau_out_tc_kernel<1, 2>,")]}),
    "glam": ("mau_streamed_bwd.cu", "mau_streamed_bwd",
             ["scripts/torch_streamed_bench.py", "--glam", "--rounds", "1"], {
                 "control": [],
                 "no Philox draw": [(NO_DRAW, "")],
                 "no products": [
                     ("    for (int kk = 0; kk < 4; ++kk) wgmma_ss<0, 0>(sa, qd +"
                      " 2 * kk, kd + 2 * kk, 1);  // S = Q K^T\n", ""),
                     ("    for (int kk = 0; kk < 4; ++kk) wgmma_ss<0, 0>(ga, dd +"
                      " 2 * kk, vd + 2 * kk, 1);  // GM = dO V^T\n", ""),
                     ("        wgmma_rs(gl[c], f + 4 * kk, od + 512 * c + 128 *"
                      " kk);  // G_lam += G one-hot\n",
                      "        gl[c][kk] += " + SINK.format("f") + ";\n")],
                 "every key tile visited": [RULE_OFF],
                 "four stages": [FOUR_STAGES],
                 "every tile's entries tested": [TESTED],
                "every tile's entries tested": [TESTED],
                 "two warpgroups a block": [(
                     "constexpr int glam_groups(int ept) { return ept == 1 ? 3 :"
                     " 2; }", "constexpr int glam_groups(int ept) { return 2;"
                     " }")]}),
    "int": ("mau_streamed_fwd.cu", "mau_streamed_fwd",
            ["scripts/torch_streamed_bench.py", "--int", "--rounds", "1"], {
                "control": [],
                "no products": [(
                    HEAD, "    for (int kk = 0; kk < KK; ++kk) wgmma_rs_x3<1>(z,"
                    " xh[kk], xl[kk], dhi + 128 * kk, dlo + 128 * kk);\n",
                    "    for (int kk = 0; kk < KK; ++kk) z[kk] += __uint_as_float("
                    "xh[kk][0] ^ xl[kk][1]);\n")],
                "one-op sigmoid": [
                    (HEAD, "        float s0 = sigmoid(fmaf(",
                     "        float s0 = sig1(fmaf("),
                    (HEAD, "        float s1 = sigmoid(fmaf(",
                     "        float s1 = sig1(fmaf("),
                    (HEAD,) + SIG1],
                "two warpgroups a block": [(
                    HEAD, "constexpr int int_groups(int dh) { return dh == 128 ?"
                    " 2 : 3; }",
                    "constexpr int int_groups(int dh) { return 2; }")]}),
    "dq": ("mau_streamed_bwd.cu", "mau_streamed_bwd",
           ["scripts/torch_streamed_bench.py", "--dq", "--rounds", "1"], {
               "control": [],
               "no Philox draw": [(
                   "            if constexpr (decltype(dropped)::value) u *= "
                   "drop.factor(b, h, i, j);  // gm's keep\n", "")],
               "no products": [
                   ("    for (int kk = 0; kk < 4; ++kk) wgmma_ss<0, 0>(sa, qd + 2 *"
                    " kk, kd + 2 * kk, 1);  // S, for p\n", ""),
                   ("    for (int kk = 0; kk < 4; ++kk) wgmma_ss<0, 0>(xa, gd + 2 *"
                    " kk, td + 2 * kk, 1);  // GT = g_su T^T\n", ""),
                   ("        wgmma_ss<0, 0>(ia, ld + 512 * c + 2 * kk, od + 512 *"
                    " c + 2 * kk, 1);\n", "        ;\n"),
                   ("    for (int kk = 0; kk < 4; ++kk) wgmma_ss<0, 0>(sa, dd + 2 *"
                    " kk, vd + 2 * kk, 1);  // GM = dO V^T\n", ""),
                   ("    for (int kk = 0; kk < 4; ++kk) wgmma_rs(dq, f + 4 * kk, kd"
                    " + 128 * kk);\n",
                    "    for (int kk = 0; kk < 4; ++kk) dq[kk] += "
                    + SINK.format("f") + ";\n")],
               "every key tile visited": [RULE_OFF]}),
    "mau_fwd": ("mau_attention_fwd.cu", "mau_attention_fwd",
                ["scripts/torch_mau_bench.py", "--fwd", "--kernels",
                 "--rounds", "1"], {
                    "control": [],
                    "no head products": [(
                        HEAD, "    for (int kk = 0; kk < KK; ++kk) wgmma_rs<1>(z,"
                        " xh[kk], dhi + 128 * kk);\n",
                        "    for (int kk = 0; kk < KK; ++kk) z[kk] +="
                        " __uint_as_float(xh[kk][0] ^ xh[kk][1]);\n")],
                    "the head alone": [
                        ("  cudaError_t e = go(mau_fwd_pre_kernel<DH>, blocks,"
                         " kTcThreads,\n                     (size_t)tc_layout("
                         "p.Tq, p.Tk, DH, p.E, false).bytes, s, p);",
                         "  cudaError_t e = cudaSuccess;"),
                        ("  return go(mau_fwd_post_kernel<DH>, blocks,"
                         " kTcThreads,"
                         "\n            (size_t)tc_layout(p.Tq, p.Tk, DH, p.E,"
                         " true).bytes, s, p);", "  return cudaSuccess;")],
                    "one warpgroup a block": [(
                        HEAD, "constexpr int int_groups(int dh) { return dh == 128 ?"
                        " 2 : 3; }",
                        "constexpr int int_groups(int dh) { return 1; }")],
                    "Newton reciprocal": [(
                        "common.cuh",
                        "  return __fdividef(1.f, 1.f + __expf(-z));",
                        "  const float d = 1.f + __expf(-z);\n"
                        "  float r = __int_as_float(0x7EF311C3 - __float_as_int(d));\n"
                        "  r = r * (2.f - d * r);\n  r = r * (2.f - d * r);\n"
                        "  return r * (2.f - d * r);")]}),
    "stats": ("mau_streamed_fwd.cu", "mau_streamed_fwd",
              ["scripts/torch_streamed_bench.py", "--stats", "--kernels",
               "--rounds", "1"], {
                  "control": [],
                  "every key tile visited": [RULE_OFF],
                  "expf in place of ex2": [(
                      "            sa[x] = fast_exp2(entry_exp2(",
                      "            sa[x] = expf(kLn2 * entry_exp2(")]}),
    "wide": ("flash_wide.cu", "flash_wide",
             ["scripts/torch_wide_flash_bench.py", "--iters", "5"], {
                 "control": [],
                 "plain stores for the atomics": [
                     ("__device__ __forceinline__ void add_rows(",
                      "__device__ __forceinline__ void store2_(float2* d, "
                      "float2 v) { *d = v; }\n\n"
                      "__device__ __forceinline__ void add_rows("),
                     ("    atomicAdd(reinterpret_cast<float2*>(d), make_float2("
                      "acc[i][0] * scale, acc[i][1] * scale));\n"
                      "    atomicAdd(reinterpret_cast<float2*>(d + 2), "
                      "make_float2(acc[i][2] * scale, acc[i][3] * scale));",
                      "    store2_(reinterpret_cast<float2*>(d), make_float2("
                      "acc[i][0] * scale, acc[i][1] * scale));\n"
                      "    store2_(reinterpret_cast<float2*>(d + 2), "
                      "make_float2(acc[i][2] * scale, acc[i][3] * scale));"),
                     ("            atomicAdd(reinterpret_cast<float2*>(dst + "
                      "(size_t)r * width + step * kOC + n0 +",
                      "            store2_(reinterpret_cast<float2*>(dst + "
                      "(size_t)r * width + step * kOC + n0 +")],
                 "no products": [(
                     "      mma_bf16(acc[2 * h], a, bq[0], bq[1]);\n"
                     "      mma_bf16(acc[2 * h + 1], a, bq[2], bq[3]);\n",
                     "      acc[2 * h][0] += __uint_as_float(a[0] ^ bq[0] ^ "
                     "bq[3]);\n")],
                 "2 forward ring slots": [(
                     "constexpr int kStagesFwd = 3;",
                     "constexpr int kStagesFwd = 2;")]}),
}
COPY = ("easydgl_tpu_torch", "chip_smoke.py", "scripts")


def main(args) -> int:
    if not args or args[0] not in KERNELS:
        raise SystemExit(f"usage: torch_ablate.py {'|'.join(KERNELS)}"
                         " [VARIANT ...]")
    source, library, bench, variants = KERNELS[args[0]]
    names = args[1:] or list(variants)
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
            for edit in variants[name]:
                path = d / CSRC / (edit[0] if len(edit) == 3 else source)
                old, new = edit[-2:]
                text = path.read_text()
                if text.count(old) != 1:
                    raise SystemExit(f"{name}: the edit does not apply")
                path.write_text(text.replace(old, new))
            dirs[name] = d
        build = ("from easydgl_tpu_torch.kernels import build;"
                 f" build.build(['{library}'])")
        procs = [subprocess.Popen([sys.executable, "-c", build], cwd=d)
                 for d in dirs.values()]
        if any(p.wait() != 0 for p in procs):
            raise SystemExit("a build failed")
        order = list(names) + (["control"] if "control" in names else [])
        for name in order:
            out = subprocess.run(
                [sys.executable, *bench, "--label", name], cwd=dirs[name],
                capture_output=True, text=True, timeout=600)
            if out.returncode != 0:
                print(out.stderr[-2000:], file=sys.stderr)
                return 1
            print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
