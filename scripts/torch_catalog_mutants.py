#!/usr/bin/env python3
"""Shows that the catalog checks of ``chip_smoke.py`` fail a catalog
backward kernel whose softmax term is missing, and a catalog forward kernel
that takes a wrong label logit or drops a vocab tile, on one GPU.

The backward's g is ``dlse * exp(s - lse) + dll * onehot(label)``. Four
mutants take the softmax term out of one pass of ``csrc/catalog_nll.cu``:
the d_table / d_bias pass, or the d_hidden pass, of the wgmma kernel (bf16
at C = 512) or of the CUDA-core kernel (the other cases). Two change the
wgmma forward (bf16 at C = 512): one takes each row's label logit from the
neighbouring id (the other id of the thread's pair), one drops the last
(ragged) vocab tile of every row. For each mutant,
and for the unchanged source as a control, the package and
``chip_smoke.py`` are copied into a temporary directory, the copy's source
is edited, and ``chip_smoke.CATALOG_CASES`` run there through
``chip_smoke.catalog_case`` (each copy's library built first, one nvcc
each, all together; then one process per copy, three at a time, as the
plain versions at N = 65,536 take ~20 GB of the card each). Prints, per copy, the checks that failed with their worst
|kernel - plain| / tolerance, and exits 0 when the control passes every
check and every mutant fails at least one. Imports neither JAX nor the JAX
package.

    python3 scripts/torch_catalog_mutants.py
"""
from __future__ import annotations

import json
import pathlib
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCE = "easydgl_tpu_torch/kernels/csrc/catalog_nll.cu"
MUTANTS = {
    "control": None,
    "no softmax term in d_table/d_bias": (
        "g = p.dlse[n] * expf(grow[c] - p.lse[n]) + "
        "(p.labels[n] == arow ? p.dll[n] : 0.f);",
        "g = (p.labels[n] == arow ? p.dll[n] : 0.f);"),
    "no softmax term in d_hidden": (
        "g = a_dlse * expf(grow[c] - a_lse) + "
        "(b0 + c == a_label ? a_dll : 0.f);",
        "g = (b0 + c == a_label ? a_dll : 0.f);"),
    "no softmax term in the wgmma d_table/d_bias": (
        "gv[c] = cs[64 + cl] * fast_exp2(fmaf(x + r_b[hr], kLog2e, -cs[cl]))"
        " +\n                    (lab == r_id[hr] ? cs[128 + cl] : 0.f);",
        "gv[c] = (lab == r_id[hr] ? cs[128 + cl] : 0.f);"),
    "no softmax term in the wgmma d_hidden": (
        "gv[c] = r_dl[hr] * fast_exp2(fmaf(x + cs[cl], kLog2e, -r_l2[hr]))"
        " +\n                    (r_id[hr] == c0 + cl ? r_dll[hr] : 0.f);",
        "gv[c] = (r_id[hr] == c0 + cl ? r_dll[hr] : 0.f);"),
    "label logit from the neighbouring id in the wgmma forward": (
        "if (8 * n + 2 * t4 + c == lc) ll[hr]",
        "if (8 * n + 2 * t4 + c == (lc ^ 1)) ll[hr]"),
    "last vocab tile dropped in the wgmma forward": (
        "const int t1 = imin(tiles, t0 + p.tiles_per_split);",
        "const int t1 = imin(tiles - 1, t0 + p.tiles_per_split);"),
}
RESULT = "RESULT "
AT_ONCE = 3   # copies run together


def child() -> int:
    """Runs the catalog cases against the package in the working
    directory; prints {case: {output: worst/tol}} as JSON."""
    here = pathlib.Path.cwd().resolve()
    sys.path.insert(0, str(here))
    import torch

    import chip_smoke
    import easydgl_tpu_torch
    assert pathlib.Path(easydgl_tpu_torch.__file__).resolve().is_relative_to(
        here), "the package was not imported from the copy"
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for name, shape, dtype, label_term, seed in chip_smoke.CATALOG_CASES:
        res = chip_smoke.catalog_case(name, shape, dtype, label_term, seed)
        out[name] = {label: ratio for label, (_, ratio) in res.items()}
    print(RESULT + json.dumps(out), flush=True)
    return 0


def make_copy(dst: pathlib.Path, edit):
    shutil.copytree(ROOT / "easydgl_tpu_torch", dst / "easydgl_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", dst / "chip_smoke.py")
    if edit is not None:
        path = dst / SOURCE
        text = path.read_text()
        old, new = edit
        if text.count(old) != 1:
            raise RuntimeError(f"mutation target not found once in {SOURCE}:"
                               f" {old}")
        path.write_text(text.replace(old, new))


def main() -> int:
    if "--child" in sys.argv:
        return child()
    import torch
    if not torch.cuda.is_available():
        print("torch_catalog_mutants: no CUDA device", file=sys.stderr)
        return 1
    ok = True
    items = list(MUTANTS.items())
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, edit) in enumerate(items):
            make_copy(pathlib.Path(tmp) / f"copy{i}", edit)
        builds = [subprocess.Popen(
            [sys.executable, "-c", "from easydgl_tpu_torch.kernels import"
             " build; build.build(['catalog_nll'])"],
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
