"""Interpretation CLI (port of ``easydgl_tpu.cli.analytics``; replaces
reference src/analytics.py): restore a checkpoint, run test-set eval, and
dump per-batch logits (the reference's "ANALYTICS" collection,
Base.py:154) to a pickle. Runs on ``--device`` (default ``cuda``).
"""
from __future__ import annotations

import argparse
import logging
import os
import pickle

import numpy as np


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", required=True, help="checkpoint directory")
    p.add_argument("--model", required=True)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--mark")
    p.add_argument("--out", default="res", help="output pickle path")
    p.add_argument("--num_items", type=int)
    p.add_argument("--num_units", type=int)
    p.add_argument("--num_heads", type=int)
    p.add_argument("--num_blocks", type=int)
    p.add_argument("--num_events", type=int)
    p.add_argument("--seqslen", type=int)
    p.add_argument("--batch_size", type=int)
    p.add_argument("--attention_impl",
                   choices=["xla", "flash", "factored"],
                   help="every impl shares one param tree; pick the "
                        "memory-appropriate one for the restore")
    p.add_argument("--compute_dtype", choices=["float32", "bfloat16"],
                   help="as in training, to reproduce its metrics")
    p.add_argument("--mask_seen", action="store_true", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda (the default) raises where "
                        "there is none, cpu runs the plain versions")
    args = p.parse_args(argv)

    from easydgl_tpu_torch.config import preset
    from easydgl_tpu_torch.data.loader import BatchLoader, PackedDataset
    from easydgl_tpu_torch.eval.metrics import MetricAccumulator
    from easydgl_tpu_torch.models.registry import build_model
    from easydgl_tpu_torch.train.checkpoint import Checkpointer
    from easydgl_tpu_torch.train.loop import device_prefetch
    from easydgl_tpu_torch.train.steps import (build_analytics_step,
                                               init_state)

    overrides = {k: getattr(args, k) for k in
                 ("num_items", "num_units", "num_heads", "num_blocks",
                  "num_events", "seqslen", "batch_size", "mask_seen",
                  "attention_impl", "compute_dtype")
                 if getattr(args, k) is not None}
    cfg = preset(args.model, **overrides)
    mark = np.load(args.mark) if args.mark else None
    if mark is not None and not cfg.num_events:
        cfg = cfg.replace(num_events=mark.shape[-1])

    test = PackedDataset.load(os.path.join(args.data_dir, "test.npz"))
    model = build_model(cfg, device=args.device)
    dev = next(model.parameters()).device
    # marks looked up on the device, as the training loop's eval does
    dev_marks = mark is not None and model.uses_tpp
    loader = BatchLoader(test, data_mode=model.data_mode,
                         batch_size=cfg.batch_size, masklen=cfg.masklen,
                         is_training=False, mark_table=mark,
                         needs_marks=model.uses_tpp,
                         marks_on_device=dev_marks)
    Checkpointer(args.ckpt).restore(init_state(model))

    step = build_analytics_step(model, mark if dev_marks else None)
    acc = MetricAccumulator()
    all_logits = []
    for features, labels, valid in device_prefetch(loader.epoch(),
                                                   device=dev):
        logits, sums = step(model, features, labels, valid)
        acc.update(sums)
        all_logits.append(logits[valid].cpu().numpy())
    res = acc.result()
    logging.info("TEST: %s", {k: f"{v:.5f}" for k, v in res.items()})
    with open(args.out, "wb") as f:
        pickle.dump(all_logits, f)
    logging.info("wrote %d logit batches to %s", len(all_logits), args.out)
    return res


if __name__ == "__main__":
    main()
