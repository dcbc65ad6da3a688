#!/usr/bin/env python3
"""How far a bf16 train step's gradients through the catalog kernels lie
from those through the catalog's plain versions, leaf by leaf, on one GPU.

For GRU4REC, S2PNM and TiSASREC (dense and factored) at the card tests'
size (C = 64, L = 10, B = 4, dropout 0, random weights from seed 0), one
``loss_and_grads`` in bf16 three ways on the card: through the kernels;
through ``catalog_nll_written_out`` (the plain forward, its backward
rounding g to bf16 before both products as the kernels do); through
autograd of ``catalog_nll_reference`` (g kept in fp32). TGAT's and
TGREC's flash forms (2 blocks, TGREC at C = 50 with one head, as the card
test ``test_bochner_train_step_launches_rows_3_to_9``) go the same three
ways for the flash attention too: the kernels,
``flash_attention_written_out`` (ds rounded as the kernels round it), and
autograd of ``flash_attention_reference``. Prints, per model,
each leaf's largest difference of each pair over the leaf's largest
entry (a key bias, 0 in exact arithmetic, over its key weight's), worst
first, as one JSON object a line. Imports neither JAX nor the JAX package.

    python3 scripts/torch_bf16_grad_spread.py [--top 6]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from easydgl_tpu_torch.config import preset  # noqa: E402
from easydgl_tpu_torch.data.loader import BatchLoader  # noqa: E402
from easydgl_tpu_torch.data.synthetic import synthetic_split  # noqa: E402
from easydgl_tpu_torch.kernels.scoring import (  # noqa: E402
    catalog_nll_reference, catalog_nll_written_out)
from easydgl_tpu_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_reference, flash_attention_written_out)
from easydgl_tpu_torch.models.registry import MODELS, build_model  # noqa: E402
from easydgl_tpu_torch.parity import random_flax_params  # noqa: E402
from easydgl_tpu_torch.train import steps  # noqa: E402

BOCHNER_FLASH = dict(attention_impl="flash", num_blocks=2)
CASES = {"GRU4REC": {}, "S2PNM": {}, "TiSASREC": {},
         "TiSASREC-factored": dict(attention_impl="factored"),
         "TGAT-flash": BOCHNER_FLASH,
         "TGREC-flash": dict(BOCHNER_FLASH, num_units=50, num_heads=1)}


def grads_three_ways(name):
    cfg = preset(name.split("-")[0], **{
        **dict(num_items=60, seqslen=10, num_units=64,
               num_heads=1 if name == "S2PNM" else 2, batch_size=4,
               timelen=12, compute_dtype="bfloat16",
               hidden_dropout_rate=0.0, attention_probs_dropout_rate=0.0),
        **CASES[name]})
    model = build_model(cfg, device="cuda", params=random_flax_params(cfg, 0))
    ds = synthetic_split(num_rows=4, num_items=60, seqslen=10, seed=2)
    f, lab, _ = next(BatchLoader(ds, data_mode="regressive", batch_size=4,
                                 is_training=True).epoch(0))
    feats = steps.to_device(f, "cuda")
    labels = torch.as_tensor(lab, device="cuda")
    out = {"kernels": steps.loss_and_grads(model, feats, labels)[1]}
    # TGAT's and TGREC's flash forms: (module, name) of the flash attention
    engine = (MODELS[cfg.model].long_context_engine[:2]
              if cfg.attention_impl == "flash" else None)
    kernels = engine and getattr(*engine)
    saved = steps.catalog_nll
    try:
        for key, fn, flash in (
                ("written_out", catalog_nll_written_out,
                 flash_attention_written_out),
                ("autograd", catalog_nll_reference,
                 flash_attention_reference)):
            steps.catalog_nll = fn
            if engine:
                setattr(*engine, flash)
            out[key] = steps.loss_and_grads(model, feats, labels)[1]
    finally:
        steps.catalog_nll = saved
        if engine:
            setattr(*engine, kernels)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--top", type=int, default=6)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    pairs = (("kernels", "written_out"), ("kernels", "autograd"),
             ("written_out", "autograd"))
    for name in CASES:
        g = grads_three_ways(name)
        rows = []
        for leaf, ref in g["written_out"].items():
            scale_of = g["written_out"][leaf[:-4] + "weight"] \
                if leaf.endswith("attn.k.bias") else ref
            scale = float(scale_of.abs().max())
            rows.append({"leaf": leaf, "scale": scale, **{
                f"{a}-{b}": float((g[a][leaf] - g[b][leaf]).abs().max())
                / scale for a, b in pairs}})
        rows.sort(key=lambda r: -r["kernels-autograd"])
        worst = {f"{a}-{b}": max(r[f"{a}-{b}"] for r in rows)
                 for a, b in pairs}
        print(json.dumps({"model": name, "leaves": len(rows),
                          "worst": worst, "top": rows[:args.top]}))


if __name__ == "__main__":
    main()
