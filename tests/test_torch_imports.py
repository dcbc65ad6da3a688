"""PyTorch port: import hygiene. The package (its ``train/`` and ``cli/``
modules included), ``chip_smoke.py`` and ``scripts/torch_*.py`` import
torch and never JAX, flax, optax, orbax, triton or the JAX package."""
import ast
import pathlib
import shutil
import subprocess
import sys

import torch

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "easydgl_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "triton")


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_every_module_imports_with_jax_flax_optax_triton_blocked():
    mods = list(_modules()) + ["chip_smoke"]
    code = "\n".join(
        ["import sys"]
        + [f"sys.modules[{m!r}] = None" for m in BLOCKED]
        + ["import importlib"]
        + [f"importlib.import_module({m!r})" for m in mods]
        + ["bad = sorted(m for m in sys.modules if m == 'easydgl_tpu'"
           " or m.startswith('easydgl_tpu.'))",
           "assert not bad, bad"])
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert len(mods) >= 30
    for new in ("easydgl_tpu_torch.kernels.mau_blocked",
                "easydgl_tpu_torch.kernels.mau_streamed",
                "easydgl_tpu_torch.kernels.flash_attention",
                "easydgl_tpu_torch.nn.attention",
                "easydgl_tpu_torch.models.sasrec",
                "easydgl_tpu_torch.train.early_stopping",
                "easydgl_tpu_torch.train.checkpoint",
                "easydgl_tpu_torch.train.profiler",
                "easydgl_tpu_torch.train.loop",
                "easydgl_tpu_torch.cli",
                "easydgl_tpu_torch.cli.train",
                "easydgl_tpu_torch.cli.analytics",
                "easydgl_tpu_torch.nn.rnn",
                "easydgl_tpu_torch.nn.coding",
                "easydgl_tpu_torch.nn.temporal",
                "easydgl_tpu_torch.models.gru4rec",
                "easydgl_tpu_torch.models.s2pnm",
                "easydgl_tpu_torch.models.tisasrec",
                "easydgl_tpu_torch.core.mesh",
                "easydgl_tpu_torch.core.runtime",
                "easydgl_tpu_torch.kernels.spmd",
                "easydgl_tpu_torch.dist.comm",
                "easydgl_tpu_torch.dist.embedding",
                "easydgl_tpu_torch.dist.topk",
                "easydgl_tpu_torch.eval.evaluator",
                "easydgl_tpu_torch.train.sharded"):
        assert new in mods


def test_no_source_imports_the_jax_package():
    files = (sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "scripts").glob("torch_*.py")))
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top != "easydgl_tpu", f"{path}: imports {name}"
                assert top not in BLOCKED, f"{path}: imports {name}"


def test_chip_smoke_fails_without_a_card_or_without_the_package(tmp_path):
    """No result line and a non-zero exit: alone in a directory (no
    package), and here on a machine without CUDA."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    runs = [tmp_path]
    if not torch.cuda.is_available():
        runs.append(ROOT)
    for cwd in runs:
        res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode != 0, (cwd, res.stdout)
        assert '"ok"' not in res.stdout
