#!/usr/bin/env python3
"""Shows that the checks of ``chip_smoke.py`` fail a broken fused MAU
forward or backward or a broken streamed stats, intensity head, output,
d-lambda, dq or dK/dV/dT kernel, on one GPU.

Four mutants of the bf16 fused forward (``csrc/mau_attention_fwd.cu`` and
the intensity head it shares, ``csrc/intensity_head.cuh``): the sigmoid not
rounded to bf16, the interval not rounded to bf16, BiMAU's diagonal left
as lam . one-hot instead of 1, and the second warpgroup of each head block
reading the rows Tq further on (a neighbouring (b, h)'s). Three of the
bf16 stats kernel (``csrc/mau_streamed_fwd.cu``): blind query tiles
visiting only the tiles with a real key (the rule's visible-only form), the
causal range short by one tile, and the online correction left off l.

Six mutants of ``csrc/mau_attention_bwd.cu``'s tensor-core path (bf16):
dbd dropped (its one atomic a column and block), dz without its (1 - sig)
factor, and the second warpgroup's rows of dx^T never added to the
workspace; and three of its dh = 128 form: the second 64-lane half of K
left out of z, dWd^T's lanes 64-127 not written, and dseq's upper half
(dx^T's lanes 64-127) not added. Two of the live-tile rule that the wgmma output, d-lambda
and dkvt kernels share (``csrc/mau_streamed.cuh``): the rows that see no
key left out (so a key tile with no real key is skipped), and the causal
range off by one tile. One of ``csrc/mau_streamed_fwd.cu``'s output
kernel: BiMAU's diagonal iqk left as lam . one-hot instead of 1; two of
its intensity head: the lo . hi pass of the split-bf16 product dropped,
and the interval lane dropped. Three of ``csrc/mau_streamed_bwd.cu``: the
d-lambda entries on BiMAU's diagonal not zeroed, the d-lambda entries
without their dropout factor, and dkvt's modulated probs without theirs
(dV's and dK's); four of its dq: GM without its dropout factor, rho left
out, BiMAU's diagonal iqk left as lam . one-hot, and the visible-only
rule's causal range cut short by one tile (a rule that visits extra tiles
would still give the right dq, so only one that skips too much is a
mutant). For each mutant, and for the unchanged sources as a control, the
package and ``chip_smoke.py`` are copied into a temporary directory, the
copy's source is edited, and the cases of ``chip_smoke.MAU_FWD_CASES``
(through ``mau_fwd_case``) with the rounding probe (``rounding_probe``),
those of ``chip_smoke.MAU_BWD_CASES``
(through ``mau_bwd_case``), the intensity head on
``chip_smoke.INTENSITY_CASES`` (through ``intensity_check``), the output
kernel on the cases of ``chip_smoke.STREAMED_CASES`` (through
``streamed_out_check``) and the stats kernel on them (``stats_check``)
with the entry-by-entry probes (``PROBE_CASES``),
and the d-lambda, dq and dkvt kernels on the cases of
``chip_smoke.STREAMED_BWD_CASES`` (through ``streamed_bwd_case``) run there
(each copy's libraries built first, one nvcc each, all together; then one
process per copy, four at a time). Prints, per copy, the checks that
failed with their worst |kernel - plain| / tolerance, and exits 0 when the
control passes every check and every mutant fails at least one. Imports
neither JAX nor the JAX package. Arguments, if any, pick the mutants whose
names contain one of them (the control always runs).

    python3 scripts/torch_bwd_mutants.py [NAME_PART ...]
"""
from __future__ import annotations

import json
import math
import pathlib
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = "easydgl_tpu_torch/kernels/csrc/"
MAU, FWD, STREAMED = ("mau_attention_bwd.cu", "mau_streamed_fwd.cu",
                      "mau_streamed_bwd.cu")
FUSED, HEAD, RULE = ("mau_attention_fwd.cu", "intensity_head.cuh",
                     "mau_streamed.cuh")
# name -> (source in csrc/, old, new), or None for the control
MUTANTS = {
    "control": None,
    "dbd dropped": (
        MAU, "      atomicAdd(p.dbd + col, bb);\n", ""),
    "dz without (1 - sig)": (
        MAU, "__hmul2(__hmul2(__hmul2(dsw, wr2[hm]), sig), __hsub2(one2, sig));",
        "__hmul2(__hmul2(dsw, wr2[hm]), sig);"),
    "dx^T of the second warpgroup's rows not added": (
        MAU, "        tma_reduce_add_2d(&maps.dseq, sth, r0 + 32 * wg, 64 * lh);",
        "        if (wg == 0) tma_reduce_add_2d(&maps.dseq, sth, r0, 64 * lh);"),
    "dh = 128: the second 64-lane half of K left out of z": (
        MAU, "kk < 4 * KH; ++kk)\n        wgmma_ss<1, 0>(zt,",
        "kk < 4; ++kk)\n        wgmma_ss<1, 0>(zt,"),
    "dh = 128: dWd^T's lanes 64-127 not written": (
        MAU, "  for (int lh = 0; lh < KH; ++lh) {\n    if (issuer)",
        "  for (int lh = 0; lh < 1; ++lh) {\n    if (issuer)"),
    "dh = 128: dseq's upper half not added": (
        MAU, "        tma_reduce_add_2d(&maps.dseq, sth, r0 + 32 * wg, 64 * lh);",
        "        if (lh == 0) tma_reduce_add_2d(&maps.dseq, sth, r0 + 32 * wg,"
        " 0);"),
    "live-tile rule: rows that see no key left out": (
        RULE, "    return bl || code != 0;", "    return code != 0;"),
    "live-tile rule: causal range off by one tile": (
        RULE, "    if (p.causal && !bl && kt * BK > imin(q0 + BQ, p.Tq) - 1) "
        "return false;",
        "    if (p.causal && !bl && kt * BK > imin(q0 + BQ, p.Tq) - 1 - BK) "
        "return false;"),
    "out: BiMAU's diagonal iqk left as lam": (
        FWD, "            float u = ((tested && diag && i == j) ? 1.f : ia[x])"
        " * pr;",
        "            float u = ia[x] * pr;"),
    "glam: BiMAU's diagonal not zeroed": (
        STREAMED, "            float u = (tested && diag && i == j) ? 0.f : "
        "ga[x] * pr;",
        "            float u = ga[x] * pr;"),
    "glam: no dropout factor": (
        STREAMED, "            if constexpr (decltype(dropped)::value) u *= "
        "drop.factor(b, h, i, j);\n", ""),
    "dkvt: no dropout factor in the modulated probs": (
        STREAMED, "            if constexpr (decltype(dropped)::value) u *= "
        "drop.factor(b, h, i, jk[hr]);\n", ""),
    "dq: no dropout factor in GM": (
        STREAMED, "            if constexpr (decltype(dropped)::value) u *= "
        "drop.factor(b, h, i, j);  // gm's keep\n", ""),
    "dq: rho left out": (
        STREAMED, "            xa[x] = pr * (xa[x] - rho[hr]);",
        "            xa[x] = pr * xa[x];"),
    "dq: BiMAU's diagonal iqk left as lam": (
        STREAMED, "            const float iq = (tested && diag && i == j) ? "
        "1.f : ia[x];", "            const float iq = ia[x];"),
    "dq: visible-only rule's causal range cut short by one tile": (
        RULE, "    const bool bl = !visible_only && blind(p, q0);\n",
        "    const bool bl = !visible_only && blind(p, q0);\n"
        "    if (visible_only && p.causal && kt * BK > imin(q0 + BQ, p.Tq) - 1 -"
        " BK) return false;\n"),
    "intensity: the lo . hi pass dropped": (
        HEAD, "wgmma_rs_x3<1>(z, xh[kk], xl[kk], dhi + 128 * kk, dlo + 128 * kk);",
        "wgmma_rs<1>(z, xh[kk], dlo + 128 * kk), wgmma_rs<1>(z, xh[kk], dhi +"
        " 128 * kk);"),
    "intensity: the interval lane dropped": (
        HEAD, "iv[hr] = kFused ? rnd<bf16>(v) : v;",
        "iv[hr] = kFused ? rnd<bf16>(v) : 0.f * v;"),
    "fused forward: the sigmoid not rounded to bf16": (
        HEAD, "        if constexpr (kFused) round_bf16x2(s0, s1);", ""),
    "fused forward: the interval not rounded to bf16": (
        HEAD, "iv[hr] = kFused ? rnd<bf16>(v) : v;", "iv[hr] = v;"),
    "fused forward: BiMAU's diagonal left as lam": (
        FUSED, "const float iqk = (p.diag_reset && j == qps[i]) ? 1.f : acc[s][c];",
        "const float iqk = acc[s][c];"),
    "fused forward: a head warpgroup reads its neighbour's rows": (
        HEAD, "*reinterpret_cast<const uint32_t*>(p.x + (size_t)row * DH + c)",
        "*reinterpret_cast<const uint32_t*>(p.x + (size_t)imin(row + (wg == 1"
        " ? p.Tq : 0), p.rows - 1) * DH + c)"),
    "stats: blind query tiles visit only tiles with a real key": (
        FWD, "b, h, q0, false};  // the output kernel's rule",
        "b, h, q0, true};  // the output kernel's rule"),
    "stats: the causal range short by one tile": (
        FWD, "    if (!blk.wg_visits(p, kt, wg)) {  // a tile of another "
        "warpgroup's queries",
        "    if (!blk.wg_visits(p, kt, wg) || (p.causal && kt * BK > imin(qw +"
        " 64, p.Tq) - 1 - BK)) {"),
    "stats: the online correction left off l": (
        FWD, "        l[hr] *= corr;\n", ""),
}
RESULT = "RESULT "
AT_ONCE = 4   # copies run together (each holds ~13 GB of the card)


def child() -> int:
    """Runs the checks against the package in the working directory;
    prints {case: {output: worst/tol}} as JSON."""
    here = pathlib.Path.cwd().resolve()
    sys.path.insert(0, str(here))
    import torch

    import chip_smoke
    import easydgl_tpu_torch
    assert pathlib.Path(easydgl_tpu_torch.__file__).resolve().is_relative_to(
        here), "the package was not imported from the copy"
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for i, case in enumerate(chip_smoke.MAU_FWD_CASES):
        out["fused fwd " + case[0]] = {
            label: ratio for label, (_, ratio) in
            chip_smoke.mau_fwd_case(i, *case).items()}
    out["rounding probe"] = {label: ratio for label, (_, ratio) in
                             chip_smoke.rounding_probe().items()}
    for i, case in enumerate(chip_smoke.MAU_BWD_CASES):
        res, _ = chip_smoke.mau_bwd_case(i, *case)
        out[case[0]] = {label: ratio for label, (_, ratio) in res.items()}
    for i, case in enumerate(chip_smoke.INTENSITY_CASES):
        out[f"int {case}"] = {"lam": chip_smoke.intensity_check(i, *case)[1]}
    for i, case in enumerate(chip_smoke.STREAMED_CASES):
        data = chip_smoke.streamed_case(i, *case)
        try:   # a non-finite out fails the check by raising
            ratio = chip_smoke.streamed_out_check(i, *case, data)[1]
        except AssertionError:
            ratio = math.inf
        out["fwd " + case[0]] = {"out": ratio, **{
            "stats " + label: r for label, (_, r) in
            chip_smoke.stats_check(i, *case, data).items()}}
    for i, (name, dtype, causal, diag) in enumerate(chip_smoke.PROBE_CASES):
        rel, dropped = chip_smoke.modulation_probe(name, dtype, causal, diag,
                                                   seed=460 + i)
        # the dropped share must lie in (0.07, 0.13): outside it counts as
        # failed, as the smoke's check does
        out[name] = {"entries": rel,
                     "dropped share": 0.0 if 0.07 < dropped < 0.13 else 2.0}
    for i, case in enumerate(chip_smoke.STREAMED_BWD_CASES):
        res = chip_smoke.streamed_bwd_case(
            i, *case, only=("mau_glam", "mau_dq", "mau_dkvt"))[0]
        out["bwd " + case[0]] = {label: ratio for kernel in res.values()
                                 for label, (_, ratio) in kernel.items()}
    print(RESULT + json.dumps(out), flush=True)
    return 0


def make_copy(dst: pathlib.Path, edit):
    shutil.copytree(ROOT / "easydgl_tpu_torch", dst / "easydgl_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", dst / "chip_smoke.py")
    if edit is not None:
        source, old, new = edit
        path = dst / CSRC / source
        text = path.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"mutation target not found once in {source}:"
                               f" {old}")
        path.write_text(text.replace(old, new))


def main() -> int:
    if "--child" in sys.argv:
        return child()
    import torch
    if not torch.cuda.is_available():
        print("torch_bwd_mutants: no CUDA device", file=sys.stderr)
        return 1
    ok = True
    picks = [a for a in sys.argv[1:] if not a.startswith("-")]
    items = [(name, edit) for name, edit in MUTANTS.items()
             if edit is None or not picks or any(x in name for x in picks)]
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, edit) in enumerate(items):
            make_copy(pathlib.Path(tmp) / f"copy{i}", edit)
        builds = [subprocess.Popen(
            [sys.executable, "-c", "from easydgl_tpu_torch.kernels import"
             " build; build.build(['mau_attention_fwd', 'mau_attention_bwd',"
             " 'mau_streamed_fwd', 'mau_streamed_bwd'])"],
            cwd=pathlib.Path(tmp) / f"copy{i}") for i in range(len(items))]
        if any(b.wait() for b in builds):
            print("FAILED: a copy did not build")
            return 1
        results = []
        for w in range(0, len(items), AT_ONCE):
            procs = {name: subprocess.Popen(
                [sys.executable, str(pathlib.Path(__file__).resolve()),
                 "--child"], cwd=pathlib.Path(tmp) / f"copy{i}",
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for i, (name, _) in enumerate(items) if w <= i < w + AT_ONCE}
            results += [(name, proc, proc.communicate(timeout=900)[0])
                        for name, proc in procs.items()]
        for name, proc, text in results:
            lines = [x for x in text.splitlines() if x.startswith(RESULT)]
            if proc.returncode != 0 or not lines:
                print(f"{name}: the run failed (rc {proc.returncode}):\n"
                      + text[-4000:])
                ok = False
                continue
            res = json.loads(lines[-1][len(RESULT):])
            failed = [(case, label, r) for case, checks in res.items()
                      for label, r in checks.items() if r > 1.0]
            worst = max(r for checks in res.values() for r in checks.values())
            caught = bool(failed)
            verdict = ("passes every check" if not caught else
                       f"fails {len(failed)} checks")
            print(f"{name}: {verdict} (worst/tol {worst:.3f})")
            for case, label, r in failed:
                print(f"    {case:28s} {label:16s} worst/tol {r:.3f}")
            ok = ok and caught == (name != "control")
    print("mutants caught, control clean" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
