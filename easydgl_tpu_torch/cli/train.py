"""Train CLI (port of ``easydgl_tpu.cli.train``; replaces reference
src/main.py).

Usage:
    python -m easydgl_tpu_torch.cli.train --model EasyDGL --data_dir DATA \\
        [--mark DATA/mark.npy] [--ckpt_dir ckpt/EasyDGL] [overrides...]

``--data_dir`` must hold train.npz / validation.npz / test.npz (the packed
splits the JAX package's ``cli.prep`` writes), or ``--synthetic`` for a
smoke run. Hyperparameter defaults come from the per-model presets
(runme.sh parity); any field of Config can be overridden from the command
line. Runs on ``--device`` (default ``cuda``; raises where there is none,
``--device cpu`` runs the kernels' plain versions).

``--dp`` / ``--mp`` run the sharded path over a (data, model) mesh, one
process per rank (``core/runtime.py``: NCCL on ``cuda``, gloo on the CPU),
started by torchrun or by the explicit flags on each process::

    torchrun --nproc_per_node 4 -m easydgl_tpu_torch.cli.train \
        --model EasyDGL --synthetic --dp 2 --mp 2 --device cpu ...
    python -m easydgl_tpu_torch.cli.train ... --dp 2 --mp 2 \
        --coordinator_address 127.0.0.1:29500 --num_processes 4 \
        --process_id R

``--cp N`` adds a seq axis of N ranks to the mesh (context parallelism,
``dist/context.py``: each data coordinate's rows on N ranks, the
attention's sequence split over them; the model length must divide by
N), ``--cp_impl`` picks its ring or Ulysses core::

    torchrun --nproc_per_node 4 -m easydgl_tpu_torch.cli.train \
        --model SASREC --synthetic --dp 2 --cp 2 --cp_impl ring \
        --device cpu ...

``--pp`` and ``--pp_microbatches`` (pipeline parallelism) are not ported
and raise (ROADMAP A.3b). ``--native on|off|auto`` picks the loader's C++
batcher (``data/native.py``; ``on`` builds it if needed and raises where
it cannot, ``auto`` uses it where JAX's rule finds it: the library
``make -C native`` writes).
"""
from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from easydgl_tpu_torch.device import resolve_device
from easydgl_tpu_torch.train.loop import train_model


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", required=True)
    p.add_argument("--data_dir")
    p.add_argument("--synthetic", action="store_true",
                   help="run on generated data (smoke/benchmark)")
    p.add_argument("--synthetic_rows", type=int, default=2048)
    p.add_argument("--mark", help=".npy multi-hot mark table (CTSMA/EasyDGL)")
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --ckpt_dir")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel mesh size (0 = single device)")
    p.add_argument("--mp", type=int, default=1,
                   help="model-parallel (table row-shard) mesh size")
    p.add_argument("--cp", type=int, default=1,
                   help="context-parallel degree")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline-parallel degree")
    p.add_argument("--pp_microbatches", type=int, default=None,
                   help="GPipe microbatch count")
    p.add_argument("--attention_impl", default=None,
                   choices=["xla", "flash", "factored"],
                   help="attention core: 'flash' = the long-context kernels "
                        "(flash attention for the SASREC family, the "
                        "streamed MAU for EasyDGL/CTSMA)")
    p.add_argument("--cp_impl", default=None, choices=["ring", "ulysses"],
                   help="context-parallel attention algorithm under --cp")
    p.add_argument("--native", default="auto", choices=["auto", "on", "off"],
                   help="the loader's C++ batcher: on (build it if needed, "
                        "raise where it cannot), off (NumPy), auto (where "
                        "`make -C native` built it, as the JAX package)")
    p.add_argument("--remat", action="store_true", default=None,
                   help="recompute encoder blocks in the backward "
                        "(torch.utils.checkpoint) — the long-context memory "
                        "lever")
    p.add_argument("--num_items", type=int)
    p.add_argument("--seqslen", type=int)
    p.add_argument("--num_units", type=int)
    p.add_argument("--num_heads", type=int)
    p.add_argument("--num_blocks", type=int)
    p.add_argument("--num_epochs", type=int)
    p.add_argument("--num_events", type=int)
    p.add_argument("--batch_size", type=int)
    p.add_argument("--masklen", type=int)
    p.add_argument("--timelen", type=int)
    p.add_argument("--filter_width", type=int,
                   help="GREC CNN filter width (reference --filter_width)")
    p.add_argument("--dilations", default=None,
                   help="GREC dilation schedule, comma ints (reference "
                        "--dilations, e.g. 1,4,1,4)")
    p.add_argument("--window_ratio", type=float,
                   help="TimelyREC smoothing window (reference "
                        "--window_ratio)")
    p.add_argument("--time_scale", type=float)
    p.add_argument("--learning_rate", type=float)
    p.add_argument("--l2_reg", type=float)
    p.add_argument("--ct_reg", type=float)
    p.add_argument("--hidden_dropout_rate", type=float)
    p.add_argument("--attention_probs_dropout_rate", type=float)
    p.add_argument("--mask_seen", action="store_true", default=None)
    p.add_argument("--gather_queries", action="store_true", default=None,
                   help="EasyDGL fast path: final-block attention for only "
                        "the prediction rows (NOT reference-exact — see "
                        "models/easydgl.py)")
    p.add_argument("--compute_dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="matmul dtype (params stay fp32); bfloat16 is the "
                        "throughput setting the kernels are tuned for")
    p.add_argument("--seed", type=int)
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda (the default) raises where "
                        "there is none, cpu runs the plain versions")
    # multi-host launch flags of the JAX CLI
    p.add_argument("--coordinator_address", default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    return p.parse_args(argv)


def refuse_unported(args) -> None:
    """Raise for the pipeline-parallel flags."""
    asked = [name for name, on in (
        ("--pp", args.pp > 1),
        ("--pp_microbatches", args.pp_microbatches is not None)) if on]
    if asked:
        raise NotImplementedError(
            f"{', '.join(asked)}: pipeline parallelism is not ported yet "
            "(ROADMAP A.3b)")


def wants_mesh(args) -> bool:
    """The sharded path: --dp, --mp or --cp given, or a world of several
    processes (explicit flags or torchrun's environment)."""
    world = (args.num_processes if args.num_processes is not None
             else int(os.environ.get("WORLD_SIZE", "1")))
    return bool(args.dp) or args.mp > 1 or args.cp > 1 or world > 1


def build_config(args):
    from easydgl_tpu_torch.config import preset
    overrides = {}
    for k in ("num_items", "seqslen", "num_units", "num_heads", "num_blocks",
              "num_epochs", "num_events", "batch_size", "masklen", "timelen",
              "time_scale", "l2_reg", "ct_reg", "hidden_dropout_rate",
              "attention_probs_dropout_rate", "mask_seen", "seed",
              "gather_queries", "attention_impl", "remat", "filter_width",
              "window_ratio", "compute_dtype", "cp_impl"):
        v = getattr(args, k)
        if v is not None:
            overrides[k] = v
    if args.dilations is not None:
        overrides["dilations"] = tuple(
            int(d) for d in str(args.dilations).split(","))
    cfg = preset(args.model, **overrides)
    if args.learning_rate is not None:
        import dataclasses
        cfg = cfg.replace(optim=dataclasses.replace(
            cfg.optim, learning_rate=args.learning_rate))
    return cfg


def load_data(args, cfg):
    from easydgl_tpu_torch.data.loader import PackedDataset
    from easydgl_tpu_torch.data.synthetic import (synthetic_mark_table,
                                                  synthetic_split)
    if args.synthetic:
        mk = dict(num_items=cfg.num_items, seqslen=cfg.seqslen,
                  with_datetime=True)
        splits = (synthetic_split(num_rows=args.synthetic_rows, seed=1, **mk),
                  synthetic_split(num_rows=args.synthetic_rows // 8,
                                  seed=2, **mk),
                  synthetic_split(num_rows=args.synthetic_rows // 8,
                                  seed=3, **mk))
        n_events = cfg.num_events or 64
        mark = synthetic_mark_table(cfg.num_items, n_events, seed=4)
        return splits, mark, cfg.replace(num_events=n_events)
    splits = tuple(
        PackedDataset.load(os.path.join(args.data_dir, f"{s}.npz"))
        for s in ("train", "validation", "test"))
    mark = np.load(args.mark) if args.mark else None
    if mark is not None and not cfg.num_events:
        cfg = cfg.replace(num_events=mark.shape[-1])
    return splits, mark, cfg


def main(argv=None):
    # console + ./model.log, mirroring the reference's conf/logging.conf
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(message)s",
        handlers=[logging.StreamHandler(),
                  logging.FileHandler("model.log")])
    args = parse_args(argv)
    refuse_unported(args)
    device = resolve_device(args.device)
    mesh = None
    cfg = build_config(args)
    if wants_mesh(args):
        from easydgl_tpu_torch.config import MeshConfig
        from easydgl_tpu_torch.core.mesh import make_mesh
        from easydgl_tpu_torch.core.runtime import init_distributed
        device = init_distributed(args.coordinator_address,
                                  args.num_processes, args.process_id,
                                  device).device
        cfg = cfg.replace(mesh=MeshConfig(dp=args.dp or -1, mp=args.mp,
                                          cp=args.cp))
        mesh = make_mesh(cfg.mesh, device.type)
        logging.info("mesh: %s", dict(zip(mesh.mesh_dim_names,
                                           mesh.mesh.shape)))
    (train, valid, test), mark, cfg = load_data(args, cfg)
    logging.info("config: %s", cfg)
    logging.info("device: %s", device)
    _, summary = train_model(cfg, train, valid, test, mark_table=mark,
                             ckpt_dir=args.ckpt_dir, resume=args.resume,
                             device=device, mesh=mesh,
                             use_native={"auto": None, "on": True,
                                         "off": False}[args.native])
    return summary


if __name__ == "__main__":
    main()
