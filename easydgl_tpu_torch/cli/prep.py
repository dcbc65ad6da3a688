"""Offline ETL CLI (port of ``easydgl_tpu.cli.prep``; replaces reference
data/linkpred.py): split CSVs -> packed .npz splits (+ optional mark
table). A host tool: NumPy and pandas, no device flag.

Usage:
    python -m easydgl_tpu_torch.cli.prep --fin CSV_DIR --fout OUT_DIR \\
        [--seqslen 30] [--mark_csv marks.csv]
    python -m easydgl_tpu_torch.cli.prep --raw --fin triplets.csv \\
        --fout OUT_DIR [--min_uc 5] [--min_sc 100] [--n_heldout_users N]

The splits it writes are what ``cli.train --data_dir`` reads.
"""
from __future__ import annotations

import argparse
import logging
import os

import numpy as np


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--fin", required=True,
                   help="folder with the split CSVs (or, with --raw, a "
                        "single raw uid,sid,time triplet CSV)")
    p.add_argument("--fout", required=True, help="output folder")
    p.add_argument("--seqslen", type=int, default=30)
    p.add_argument("--num_items", type=int, default=None)
    p.add_argument("--no_datetime", action="store_true")
    p.add_argument("--mark_csv", help="(sid, event) CSV for the mark table")
    p.add_argument("--raw", action="store_true",
                   help="run the full raw pipeline: filter + user holdout "
                        "+ dense renumbering (linkpred.py:216-246 flow)")
    p.add_argument("--min_uc", type=int, default=5)
    p.add_argument("--min_sc", type=int, default=100)
    p.add_argument("--n_heldout_users", type=int, default=20000)
    args = p.parse_args(argv)

    from easydgl_tpu_torch.data.etl import (mark_table_from_csv, prepare,
                                      prepare_raw)
    if args.raw:
        num_items = prepare_raw(args.fin, args.fout, seqslen=args.seqslen,
                                min_uc=args.min_uc, min_sc=args.min_sc,
                                n_heldout_users=args.n_heldout_users,
                                with_datetime=not args.no_datetime)
    else:
        num_items = prepare(args.fin, args.fout, seqslen=args.seqslen,
                            num_items=args.num_items,
                            with_datetime=not args.no_datetime)
    logging.info("packed splits written to %s (num_items=%d)",
                 args.fout, num_items)
    if args.mark_csv:
        table = mark_table_from_csv(args.mark_csv, num_items)
        np.save(os.path.join(args.fout, "mark.npy"), table)
        logging.info("mark table: %s", table.shape)
    return num_items


if __name__ == "__main__":
    main()
