#!/usr/bin/env python3
"""Smoke run of the PyTorch port (easydgl_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds every CUDA kernel from the checkout's sources (one nvcc per
source, all started together), holds each kernel against its plain PyTorch
version on the card — the MAU/BiMAU forward and backward (dropout included,
the same seed on both sides), the catalog NLL forward and backward (the
forward's lse and label logit to the fp32 tolerance in both dtypes, the
label logit also on the rows whose label is not id 0; the table and bias
gradients also on the vocab ids that are no row's label, and one case
without the label term, so that the softmax term is held on its own), the
three streamed long-context MAU forward kernels (stats, intensity
head, modulated output) and the four streamed backward kernels (d-lambda,
the intensity head's VJP, dq, dk/dv/dt), each on the blocked plain
version's inputs, and the chained streamed backward against the blocked
one, the two flash attention kernels (the forward, and the backward that
forms dq, dk and dv in one key-major pass over the live key tiles) and
their chained backward, and the same two wrappers' wide kernels
(``flash_wide.cu``, heads of any width: TGAT's augmented 2,048 with v at
512, TGREC's 150, and the backward at dh = 128), the catalog kernels also
at TGREC's C = 50 and at GREC's untied head (its learned bias on every
id, the table a transposed view of its (C, V) kernel, V = 17,773), and
at TimelyREC's padded rows, the flash kernels at its heads (B = 512,
T = 30, H = 4, dh = 128) — and times each against its bound (the flash
kernels also against ``F.scaled_dot_product_attention`` on the same
inputs, with the backend it picks at the wide heads). Then
it drives the port's main
paths, each with the launch counters set to 0 just before it and read just
after:

* serving on the flagship EasyDGL configuration (``PRESETS["EasyDGL"]``, 64
  event marks, bf16 matmuls, random weights from a seed loaded through the
  flax weight bridge): the eval step over a synthetic split and batched
  top-k ``Recommender.recommend`` requests;
* serving on the long-context flagship (``PRESETS["EasyDGL-LC"]``, L+1 =
  2048, B = 8, the same widths): eval batches and ``recommend`` requests
  through the streamed kernels;
* training on the flagship: 20 faithful train steps (dropout 0.1 / 0.1, TPP
  and L2 terms, TF-Adam) through ``build_train_step`` with marks looked up
  on the device, then 10 steps on one repeated batch whose loss must fall;
* training on EasyDGL-LC: 10 faithful train steps through the seven
  streamed kernels and the catalog kernels, then 5 on one repeated batch;
* serving on SASREC-LC (``PRESETS["SASREC-LC"]``, L = 2048, B = 32, 2
  blocks, bf16): eval batches and ``recommend`` requests through the flash
  forward kernel;
* training on SASREC-LC: 10 faithful train steps (dropout 0.1 / 0.1, the
  softmax-eps loss over every position, TF-Adam) through the two flash
  kernels and the catalog kernels, then 5 on one repeated batch;
* serving on BERT4REC-LC (``PRESETS["BERT4REC-LC"]``, L+1 = 2048, B = 32,
  2 blocks, bf16, the masked protocol): eval batches and ``recommend``
  requests through the flash forward kernel, not causal;
* training on BERT4REC-LC: 10 faithful train steps (dropout 0.1 / 0.1,
  the sparse_ce loss over the 256 masked positions, L2, TF-Adam) through
  the two flash kernels and the catalog kernels at V = 17,773, then 5 on
  one repeated batch;
* serving and training on BERT4REC (``PRESETS["BERT4REC"]``, B = 512,
  L+1 = 31, 3 blocks, bf16, the xla attention core): eval batches and
  ``recommend`` requests (no kernel), 20 faithful train steps through the
  catalog kernels, then 10 on one repeated batch;
* serving and training on CTSMA (``PRESETS["CTSMA"]``, 64 marks, bf16:
  B = 512, L = 30, 2 causal MAU blocks at dh = 128): eval batches and
  ``recommend`` requests through the fused MAU forward, 20 faithful train
  steps (dropout 0.1 / 0.2, TPP + L2, TF-Adam) through the fused MAU
  kernels and the catalog kernels at N = 15,360, then 10 on one repeated
  batch;
* serving and training on CTSMA-LC (``PRESETS["CTSMA-LC"]``: B = 8,
  L = 2048, 1 causal block): eval batches and ``recommend`` requests
  through the streamed forward kernels, 10 faithful train steps through
  the seven streamed kernels and the catalog kernels at N = 16,384, then 5
  on one repeated batch;
* serving and training on GRU4REC, S2PNM and TiSASREC (their presets,
  bf16: B = 512, L = 30, C = 512; the cuDNN-variant GRU, S2PNM's GRU,
  attention and dictionary combine, TiSASREC's dense interval attention):
  eval batches and ``recommend`` requests (no kernel), 20 faithful train
  steps through the catalog kernels at N = 15,360, then 10 on one repeated
  batch; TiSASREC's interval buckets of whole-day stamps at its preset's
  shape, on the card and the CPU equal to the fp32 division-first order,
  and 8 such rows' fp32 logits card vs CPU in both interval forms; its
  factored interval attention against the dense one on the card at its
  preset (fp32), one forward;
* serving and training on TGAT and TGREC (their presets, bf16: TGAT
  B = 512, C = 512, H = 1, 3 blocks; TGREC B = 128, C = 50, H = 1, 3
  blocks; the dense Bochner time attention): eval batches and
  ``recommend`` requests (no kernel), 20 faithful train steps through the
  catalog kernels, then 10 on one repeated batch; their flash and
  factored forms against the dense form on the card at the preset (fp32
  logits of a whole batch, one fp32 train step on 8 rows with the padding
  made real); then each with ``attention_impl="flash"`` at L = 2048,
  B = 8: eval batches and ``recommend`` requests through the wide flash
  forward, 10 faithful train steps through the wide flash kernels and the
  catalog kernels, then 5 on one repeated batch;
* serving and training on GREC and TimelyREC (their presets, bf16,
  B = 512, C = 512: GREC's eight dilated-CNN blocks and untied head of
  num_items + 2 = 17,773 rows, the grec loss; TimelyREC's causal user
  tower, four time-slot encoders and history encoder): eval batches and
  ``recommend`` requests (no kernel; GREC never returns id 0 or its last
  id), 20 faithful train steps through the catalog kernels (GREC at
  N = 3,072 rows against its transposed head and learned bias), then 10
  on one repeated batch; TimelyREC's ``"flash"`` form against its
  ``"xla"`` form on the card (fp32 logits of a whole batch, one fp32
  train step on 8 rows), then in bf16 eval batches and ``recommend``
  requests through the flash forward at dh = 128 and 10 faithful train
  steps through the flash kernels (the dh = 128 backward on
  ``flash_wide.cu``) and the catalog kernels, then 5 on one repeated
  batch;
* EasyDGL-LC with ``gather_queries=True`` (its preset, B = 8, L+1 = 2048,
  masklen 256): its one block's MAU takes the gathered rows alone, which
  the port routes as JAX does, to the materialised chain (no kernel):
  eval batches and ``recommend`` requests, 10 faithful train steps
  through the catalog kernels, then 5 on one repeated batch;
* the harness on the flagship, in a temporary directory: ``cli.train
  --synthetic`` (4,096 train rows, 8 steps an epoch, bf16) for 2 epochs
  and 1 more with ``--resume`` (the step count must continue), the resumed
  run under ``torch.profiler``, whose kernel names must show rows 1-4;
  ``cli.analytics`` on the checkpoint (its test H100 must equal the
  summary's to 1e-6 relative) and ``Recommender.from_checkpoint``
  (its top-k must equal that of the weights the checkpoint saved); the
  loop's train ex/s with the loader included, beside the step-only figure;
* the distributed layer (phase 10): each SPMD wrapper's shard-local step
  for every shard at mp = 2 and 4 on this one card (the catalog's vocab
  slices of the flagship's 17,772 ids, bf16 and fp32, labels outside a
  slice at -1; the MAU's head groups at the flagship shape, dropout 0 and
  0.1 with each shard's keep rate; flash's head groups at SASREC-LC's
  shape), merged by the wrapper's own merge, forward and backward, against
  the unsharded kernels, and each shard's kernels timed beside their
  bound; then a real NCCL process group of one rank on a (1, 1) mesh: one
  fp32 flagship step through ``build_sharded_train_step`` against
  ``build_train_step`` (the loss and every gradient to 1e-6 of the leaf's
  scale), ``build_distributed_eval_step`` against ``build_eval_step``, 20
  faithful bf16 sharded steps (and the single-device step in turns with
  them), and ``cli.train --dp 1 --mp 1`` for one epoch with
  ``Recommender.from_checkpoint`` on its checkpoint;
* context parallelism (phase 10d) on this one card: the seq axis's cp = 2
  and 4 ranks' blocks held in one process (``dist/context.py::
  LocalExchange``, the bodies the process-group exchange runs) at full
  width (C = 512, H = 8, T = 2048; batches cut to 2 rows): SASREC-LC's
  causal ring and Ulysses, BERT4REC-LC's non-causal ring and EasyDGL-LC's
  two-sweep ring MAU, each model's logits, loss and every gradient against
  the single-device path (the flash and streamed kernels) at dropout 0 in
  fp32 and bf16 (``CP_TOL``), a dropout probe that reads the keep mask
  back, and faithful bf16 train steps single-device and at cp = 2, 4 in
  turns (under cp no attention kernel runs, the catalog kernels do);
* the data-prep path (phase 11): 2.3M raw triplets from a seed (20,000
  users, a 17,770-item catalog, 30-200 events each) through ``cli.prep
  --raw --mark_csv`` (timed), the native batcher built with g++, then the
  flagship through ``cli.train --native on`` and ``--native off`` for one
  epoch each on the packed splits, in turns: train ex/s, host ms a batch
  of batch assembly, the loaders' ``native`` flag, rows 1-4 launched.

Besides, each full-width model runs in fp32 on the card and on the CPU and
is compared: the flagship's eval logits and one train step (loss, every
gradient, the updated parameters), for EasyDGL-LC, SASREC-LC,
BERT4REC-LC and CTSMA-LC the logits of two rows and one train step on two
rows, for BERT4REC and CTSMA one train step on eight rows (CTSMA's logits
on eight rows too), for GRU4REC, S2PNM, TiSASREC, TGAT, TGREC, GREC and
TimelyREC the logits of eight rows and one train step on eight rows, and
for the gathered EasyDGL-LC one train step on two rows.

Every phase prints its own lines; any failure exits non-zero before the
result. The line before the last lists the kernels as JSON, and the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device it exits 1.
"""
from __future__ import annotations

import contextlib
import json
import logging
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from easydgl_tpu_torch.config import MeshConfig, preset
from easydgl_tpu_torch.core.mesh import make_mesh, use_spmd_mesh
from easydgl_tpu_torch.core.runtime import init_distributed
from easydgl_tpu_torch.data.loader import BatchLoader, PackedDataset
from easydgl_tpu_torch.data.synthetic import (day_boundary_stamps,
                                              synthetic_mark_table,
                                              synthetic_split_vectorized)
from easydgl_tpu_torch.dist.context import (LocalExchange, ring_attention,
                                            ulysses_attention,
                                            use_seq_exchange)
from easydgl_tpu_torch.eval.evaluator import build_distributed_eval_step
from easydgl_tpu_torch.eval.metrics import MetricAccumulator
from easydgl_tpu_torch.eval.recommender import Recommender
from easydgl_tpu_torch.kernels import build
from easydgl_tpu_torch.kernels.flash_attention import (
    _BWD, _FWD, FLASH_KERNELS, flash_attention, flash_attention_bwd,
    flash_attention_fwd, flash_attention_reference, flash_bwd_reference,
    flash_delta, flash_fwd_reference, flash_live_tiles, flash_visited_tiles,
    narrow_kernels)
from easydgl_tpu_torch.kernels.mau_attention import dropout_factor
from easydgl_tpu_torch.kernels.mau_attention import (
    _chain, _launch_fwd, _seed_tensor, mau_attention, mau_attention_bwd,
    mau_attention_bwd_reference, mau_attention_reference)
from easydgl_tpu_torch.kernels.mau_blocked import (
    dkvt_reference, dq_reference, glam_reference, intensity_reference,
    intensity_vjp_reference, mau_blocked, mau_blocked_forward,
    output_reference, row_correction, stats_reference)
from easydgl_tpu_torch.kernels.mau_streamed import (
    STREAMED_KERNELS, mau_dkvt, mau_dq, mau_glam, mau_intensity,
    mau_intensity_bwd, mau_modulated_out, mau_stats, mau_streamed,
    streamed_visited_tiles)
from easydgl_tpu_torch.kernels.scoring import (catalog_live_rows,
                                               catalog_nll,
                                               catalog_nll_bwd,
                                               catalog_nll_bwd_reference,
                                               catalog_nll_fwd,
                                               catalog_nll_reference)
from easydgl_tpu_torch.kernels.spmd import (catalog_merge,
                                            catalog_nll_local,
                                            flash_attention_local,
                                            head_block, mau_attention_local,
                                            shard_labels, shard_seed)
from easydgl_tpu_torch.models.registry import (MODELS, build_model,
                                               model_class)
from easydgl_tpu_torch.models.tisasrec import (interval_buckets,
                                               interval_buckets_numpy)
from easydgl_tpu_torch.parity import random_flax_params
from easydgl_tpu_torch.train.sharded import (build_sharded_train_step,
                                             shard_state)
from easydgl_tpu_torch.train.steps import (build_eval_step, build_train_step,
                                           device_marks, dropout_generator,
                                           init_state, loss_and_grads,
                                           to_device)

# Published H100 SXM peaks (NVIDIA data sheet, dense): device memory rate,
# and the operation rate for each input type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# |kernel - plain| <= atol + rtol * scale, elementwise. fp32: scale = |plain|;
# the two sum in different orders (fp32 reassociation, ~1e-6 relative).
# bf16: both round the same operands to bf16 at the same points, but a sum
# taken in another order (tensor cores vs cuBLAS) can flip a bf16 rounding
# of a summand by one ulp (2^-8 relative) — of the sigmoid, and of the
# modulated probs before @V. So `out` is held relative to the size of its
# summands, scale = sum_j |m_ij v_jd| (the plain version run on |v|; m >= 0),
# which bounds what such flips can move even where the sum cancels; `lam`
# (fp32 out of the fp32 sums) to |plain|.
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
# Gradients and the catalog NLL's outputs, |kernel - plain| <= tol * the
# output's largest |plain| entry, with no absolute floor: fp32 sums of up to
# B*H*Tq (126,976) terms taken in another order and by atomics; in bf16 a
# reordered sum can flip the one bf16 rounding of an output by one ulp (at
# most 2^-7 of its largest entry) and that of an intermediate (dz, sig, g)
# by one ulp of a single summand.
SCALE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# whole-model logits, fp32 on the card vs fp32 on the CPU
SLICE_TOL = (1e-4, 1e-4)
# Gradient leaves that are zero in exact arithmetic: a key projection's bias
# (SASREC's, S2PNM's and TiSASREC's attention, CTSMA's MAU) b adds q_i . b
# to every logit of row i, which the softmax cancels, so its computed
# gradient is rounding noise on either device (~1e-9 where the key
# weight's is ~1e-3). The train-step checks hold it to 1e-4 of the key
# weight's gradient scale instead of its own.
ZERO_GRAD_LEAF = re.compile(r"(^|_)(attn|mau)\.k\.bias$")
FLAGSHIP = dict(b=512, tq=31, tk=31, h=8, dh=64, e=64)
# PRESETS["CTSMA"]'s heads (C=512, H=4: dh=128) at the flagship's T and E
DH128 = dict(b=32, tq=31, tk=31, h=4, dh=128, e=64)
# PRESETS["CTSMA"]'s train shape on one of its batches (regressive_entire:
# L = 30), and the same at 32 rows for the checks
CTSMA_TRAIN = dict(b=512, tq=30, tk=30, h=4, dh=128, e=64)
CTSMA_CHECK = dict(CTSMA_TRAIN, b=32, batch="CTSMA")
# PRESETS["CTSMA-LC"]'s shape (B = 8, L = 2048), timed on one of its
# batches (``batch="CTSMA-LC"``)
CTSMA_LC = dict(b=8, tq=2048, tk=2048, h=8, dh=64, e=64)
CATALOG = dict(n=3072, v=17772, c=512)   # B*masklen rows, the tied table
CTSMA_CATALOG = dict(n=15360, v=17771, c=512)   # B*L rows, CTSMA
# PRESETS["TGREC"]'s training rows: B*L = 3,840 at C = 50 (the wrapper pads
# C to 52, whole 4-column vectors)
TGREC_CATALOG = dict(n=3840, v=17771, c=50)
SASREC_LC_CATALOG = dict(n=65536, v=17771, c=512)   # B*L rows
# GREC's training rows, B*masklen = 3,072, against its untied head of
# num_items + 2 rows
GREC_CATALOG = dict(n=3072, v=17773, c=512)
# B*masklen rows against num_items + 2 ids (the MASK id and one more)
BERT4REC_LC_CATALOG = dict(n=8192, v=17773, c=512)
TRAIN_STEPS, REPEAT_STEPS = 20, 10
LC_TRAIN_STEPS, LC_REPEAT_STEPS = 10, 5
# SASREC-LC and BERT4REC-LC
FLASH_TRAIN_STEPS, FLASH_REPEAT_STEPS = 10, 5
BERT4REC_TRAIN_STEPS, BERT4REC_REPEAT_STEPS = 20, 10
# the models whose paths run no attention kernel, only the catalog kernels
# in training: name -> (phase letter, data seed, the preset's shape)
RECURRENT_AND_INTERVAL = {
    "GRU4REC": ("h", 31, "B=512, L=30, C=512, 1 cuDNN-variant GRU layer"),
    "S2PNM": ("i", 34, "B=512, L=30, C=512, 1 GRU layer, 1 causal head of "
                       "512 over the 2C-wide codes"),
    "TiSASREC": ("j", 37, "B=512, L=30, C=512, H=8, 2 blocks, the dense "
                          "(B, L, L, C) interval codes, timelen 256"),
    "GREC": ("m", 47, "B=512, L+1=31, C=512, 8 dilated-CNN blocks "
                      "(dilations 1, 4, 1, 4; width 3), the untied head of "
                      "17,773 rows"),
    "TimelyREC": ("n", 49, "B=512, L=30, C=512, H=4, the causal user "
                           "tower, four time-slot encoders, the history "
                           "encoder")}
# phase 7's loss and catalog shape, where it is not softmax-eps over every
# position, N = 15,360
TRAIN_WHAT = {"GREC": "the grec loss (row-masked mean CE + 0.001 x the "
                      "mean l2 of the 72 parameter tensors), the catalog "
                      "kernels at N=3,072, V=17,773 (untied)"}
# the Bochner time models: name -> (phase letter, data seed, the preset's
# shape); each also runs its flash form at L = 2048, B = 8 (BOCHNER_LC)
BOCHNER = {
    "TGAT": ("k", 41, "B=512, L=30, C=512, H=1, 3 blocks, the dense "
                      "(B, L, L, C) time codes"),
    "TGREC": ("l", 45, "B=128, L=30, C=50, H=1, 3 blocks, the dense "
                       "(B, L, L, 2C) time-concatenated keys and values")}
BOCHNER_LC = dict(attention_impl="flash", seqslen=2048, batch_size=8)
LC = dict(b=8, tq=2048, tk=2048, h=8, dh=64, e=64)   # EasyDGL-LC eval shape
STREAMED = (mau_stats, mau_intensity, mau_modulated_out)
STREAMED_BWD = (mau_glam, mau_intensity_bwd, mau_dq, mau_dkvt)
STREAMED_REPLACES = {
    name: f"easydgl_tpu/kernels/mau_streamed.py:{line}" for name, line in (
        ("mau_stats", 607), ("mau_intensity", 239), ("mau_modulated_out", 634),
        ("mau_intensity_bwd", 274), ("mau_glam", 692), ("mau_dq", 739),
        ("mau_dkvt", 768))}
MAU_GRADS = ("dq", "dk", "dv", "dt", "dWd", "dbd", "dw", "dscaling")
# The CUDA kernels each wrapper launches on the bf16 main paths.
CUDA_KERNELS = {
    "mau_attention_fwd": ["mau_fwd_pre_kernel<64>", "mau_int_round_kernel",
                          "mau_int_fwd_tc_kernel<64, 1>",
                          "mau_fwd_post_kernel<64>"],
    "mau_attention_bwd": ["mau_bwd_attn<bf16, 64, 1>", "mau_bwd_int_tc<64>",
                          "mau_bwd_attn<bf16, 64, 2>",
                          "mau_bwd_attn<bf16, 128, 1>", "mau_bwd_int_tc<128>",
                          "mau_bwd_attn<bf16, 128, 2>"],
    "catalog_nll_fwd": ["catalog_fwd_tc_kernel", "catalog_merge"],
    "catalog_nll_bwd": ["catalog_bwd_tc_kernel<1>",
                        "catalog_bwd_tc_kernel<2>"],
    "mau_stats": ["mau_stats_tc_kernel"],
    "mau_intensity": ["mau_int_split_kernel", "mau_int_fwd_tc_kernel"],
    "mau_modulated_out": ["mau_out_tc_kernel"],
    "mau_glam": ["mau_glam_tc_kernel"],
    "mau_intensity_bwd": ["mau_int_bwd_rows_tc_kernel",
                          "mau_int_bwd_cols_tc_kernel"],
    "mau_dq": ["mau_dq_tc_kernel"],
    "mau_dkvt": ["mau_dkvt_tc_kernel"],
    "flash_attention_fwd": ["flash_fwd_tc_kernel",
                            "flash_wide_fwd_tc_kernel",
                            "flash_wide_fwd_kernel"],
    "flash_attention_bwd": ["flash_bwd_tc_kernel",
                            "flash_wide_bwd_tc_kernel",
                            "flash_wide_bwd_kernel"]}


PHASE_STARTS = []     # (phase name, perf_counter) as each phase is logged


def log(msg: str):
    if msg.startswith("phase "):
        PHASE_STARTS.append((msg.split(":")[0][6:],
                             time.perf_counter()))
    print(msg, flush=True)


def phase_seconds(end: float) -> dict:
    """Seconds from each logged phase to the next (the last to ``end``)."""
    ends = [t for _, t in PHASE_STARTS[1:]] + [end]
    out = {}
    for (name, t), e in zip(PHASE_STARTS, ends):
        out[name] = out.get(name, 0.0) + e - t
    return {name: round(v, 1) for name, v in out.items()}


def check(cond: bool, msg: str):
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------- kernels


def preset_batch(name, rows, seed):
    """(key mask (rows, T), intervals (rows, T), marks (rows, T, E)) of a
    train batch of preset ``name`` (64 marks) on the card: left-padded
    synthetic histories (start time 1e9 s), spans as CTSMA forms them
    (unclipped differences of the scaled timestamps: the last padding row's
    is the first real item's whole timestamp, ~11,574 days), marks from a
    seeded table."""
    cfg = preset(name, num_events=64)
    split = synthetic_split_vectorized(num_rows=rows, num_items=cfg.num_items,
                                       seqslen=cfg.seqslen, seed=seed)
    table = synthetic_mark_table(cfg.num_items, 64, seed=seed)
    feats, _, _ = next(iter(BatchLoader(
        split, data_mode=model_class(cfg).data_mode, batch_size=rows,
        is_training=True, mark_table=table, needs_marks=True).epoch(0)))
    ids = torch.as_tensor(feats["seqs_i"], device="cuda")
    ts = torch.as_tensor(feats["seqs_t"], device="cuda") / cfg.time_scale
    return ((ids != 0).float(), ts[:, 1:] - ts[:, :-1],
            torch.as_tensor(feats["seqs_marks"], device="cuda"))


def mau_inputs(*, b, tq, tk, h, dh, e, dtype, gathered, seed, lengths=None,
               batch=None):
    """Inputs at realistic magnitudes: projections ~N(0, 1), intervals
    ~Exp(1) days clipped to [0, 100], 15%-dense multi-hot marks, left-padded
    key masks (``lengths`` real keys a row, else uniform in [1, Tk]) with row
    0 fully masked. ``batch``: a preset whose train batch (``preset_batch``,
    B rows) gives the key mask, the intervals and the marks instead; row 0
    is still fully masked (a batch's zero tail rows)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=dev) * std

    c = h * dh
    q = normal(b, tq, c).to(dtype)
    k, v, t = (normal(b, tk, c).to(dtype) for _ in range(3))
    lengths = (torch.randint(1, tk + 1, (b,), generator=g, device=dev)
               if lengths is None else torch.tensor(lengths, device=dev))
    key_mask = (torch.arange(tk, device=dev)[None] >= tk - lengths[:, None])
    key_mask = key_mask.float()
    key_mask[0] = 0.0
    intervals = (-torch.log(torch.rand(b, tq, generator=g, device=dev))
                 ).clamp(0.0, 100.0)
    onehot = (torch.rand(b, tk, e, generator=g, device=dev) < 0.15).float()
    if batch is not None:
        key_mask, intervals, onehot = preset_batch(batch, b, seed)
        check(key_mask.shape == (b, tk) and intervals.shape == (b, tq)
              and onehot.shape == (b, tk, e), f"{batch} batch shape")
        key_mask[0] = 0.0
    wd = normal(dh + 1, e * dh, std=0.2)
    bd, w, scaling = normal(e * dh, std=0.1), normal(e, dh, std=0.2), \
        normal(e, std=0.3)
    qpos = None
    if gathered:
        # distinct sorted positions per row; the last row's queries sit at
        # the end, as gather_queries places the eval query
        qpos = torch.sort(torch.rand(b, tk, generator=g, device=dev)
                          .argsort(-1)[:, :tq], -1).values
        qpos[-1] = torch.arange(tk - tq, tk, device=dev)
    return (q, k, v, t, key_mask, intervals, onehot, wd, bd, w, scaling,
            qpos)


def run_pair(fn, args, *, causal, diag, h):
    (q, k, v, t, km, iv, oh, wd, bd, w, sc, qpos) = args
    return fn(q, k, v, t, km, iv, oh, wd, bd, w, sc, causal=causal,
              diag_reset=diag, num_heads=h, qpos=qpos)


def compare_ratios(name, got, want, dtype, out_scale, labels=("out", "lam"),
                   second_tol=None):
    """{label: (max abs err, worst/tol)} of (out, second), logged: out held
    elementwise to TOL[dtype] of out_scale, the second output to
    ``second_tol`` (default TOL[dtype]) of itself; a non-finite output gets
    an infinite ratio."""
    res = {}
    for label, a, b, scale, (atol, rtol) in zip(
            labels, got, want, (out_scale, want[1]),
            (TOL[dtype], second_tol or TOL[dtype])):
        a, b = a.float(), b.float()
        err = (a - b).abs()
        ratio = float((err / (atol + rtol * scale.float().abs())).max())
        if not bool(torch.isfinite(a).all()):
            ratio = math.inf
        mabs = float(err.max())
        mrel = float((err / b.abs().clamp_min(1e-6)).max())
        log(f"  {name:22s} {label}: max_abs={mabs:.3e} max_rel={mrel:.3e}"
            f" max|plain|={float(b.abs().max()):.3e}"
            f" tol(atol={atol:g}, rtol={rtol:g}) worst/tol={ratio:.3f}")
        res[label] = (mabs, ratio)
    return res


def compare(name, got, want, dtype, out_scale, labels=("out", "lam"),
            second_tol=None):
    """``compare_ratios``, each output within its tolerance; returns the
    largest absolute error."""
    res = compare_ratios(name, got, want, dtype, out_scale, labels,
                         second_tol)
    for label, (_, ratio) in res.items():
        check(ratio <= 1.0, f"{name}: {label} outside tolerance")
    return max(err for err, _ in res.values())


# name, shape, dtype, causal, diag_reset, gathered queries
MAU_FWD_CASES = (
    ("bimau_fp32_flagship", FLAGSHIP, torch.float32, False, True, False),
    ("bimau_bf16_flagship", FLAGSHIP, torch.bfloat16, False, True, False),
    ("mau_causal_fp32", FLAGSHIP, torch.float32, True, False, False),
    ("mau_causal_bf16", FLAGSHIP, torch.bfloat16, True, False, False),
    ("bimau_qpos_tq6_fp32", dict(FLAGSHIP, tq=6), torch.float32, False, True,
     True),
    ("bimau_qpos_tq6_bf16", dict(FLAGSHIP, tq=6), torch.bfloat16, False, True,
     True),
    ("bimau_qpos_tq1_bf16", dict(FLAGSHIP, tq=1), torch.bfloat16, False, True,
     True),
    ("causal_qpos_tq6_fp32", dict(FLAGSHIP, tq=6), torch.float32, True, False,
     True),
    ("small_dh16_e4_fp32", dict(b=4, tq=11, tk=11, h=2, dh=16, e=4),
     torch.float32, True, True, False),
    ("tk128_fp32", dict(b=16, tq=128, tk=128, h=8, dh=64, e=64),
     torch.float32, False, True, False),
    ("tk128_dh32_bf16", dict(b=16, tq=128, tk=128, h=16, dh=32, e=64),
     torch.bfloat16, True, False, False),
    ("dh128_bimau_bf16", DH128, torch.bfloat16, False, True, False),
    ("dh128_causal_fp32", DH128, torch.float32, True, False, False),
    # the bf16 head over rows of many heads at narrow heads, few and many
    # events: a ragged last column tile, two event tiles, gathered queries
    ("small_dh16_e3_bf16", dict(b=5, tq=11, tk=11, h=2, dh=16, e=3),
     torch.bfloat16, True, True, False),
    ("e128_qpos_tq9_bf16", dict(b=16, tq=9, tk=31, h=8, dh=64, e=128),
     torch.bfloat16, False, True, True),
    # as PRESETS["CTSMA"] drives it: causal without the reset at dh = 128,
    # on a CTSMA batch's key mask (rows that see no key) and spans
    ("ctsma_causal_dh128_bf16", CTSMA_CHECK, torch.bfloat16, True, False,
     False))


def mau_fwd_case(i, name, shape, dtype, causal, diag, gathered):
    """Case i of ``MAU_FWD_CASES``: the forward against the plain version;
    {output: (max abs err, worst/tol)}."""
    args = mau_inputs(**shape, dtype=dtype, gathered=gathered, seed=i)
    got = run_pair(mau_attention, args, causal=causal, diag=diag, h=shape["h"])
    torch.cuda.synchronize()
    want = run_pair(mau_attention_reference, args, causal=causal, diag=diag,
                    h=shape["h"])
    check(tuple(got[0].shape) == tuple(want[0].shape)
          and got[0].dtype == dtype, f"{name}: out shape/dtype")
    check(tuple(got[1].shape) == tuple(want[1].shape)
          and got[1].dtype == torch.float32, f"{name}: lam shape/dtype")
    out_scale = want[0]
    if dtype == torch.bfloat16:
        abs_v = args[:2] + (args[2].abs(),) + args[3:]
        out_scale = run_pair(mau_attention_reference, abs_v, causal=causal,
                             diag=diag, h=shape["h"])[0]
    return compare_ratios(name, got, want, dtype, out_scale)


def rounding_probe(seed=90):
    """The bf16 forward on inputs where the fused contract's rounding points
    decide lam, so that lam (and the training residual raw) are held to the
    fp32 tolerance: t = 0 makes seq_units, and x's seq_units lanes, exactly
    0, so z = rnd(iv) Wd[dh] + bd is formed with one rounding on both
    sides; every interval (37.3..37.31) rounds to the bf16 37.25, and Wd's
    interval lane is 2, so an unrounded interval moves z by 0.1; bd puts
    each sigmoid 0.45 of a bf16 ulp above a bf16 value v in (0.55, 0.9), so
    that it rounds down to v by a margin of 0.05 ulp, far above the fp32
    error of either side's sigmoid, and an unrounded sigmoid moves raw (64
    columns an event, w = 0.5) by ~0.06 of ~22. {output: (max abs err,
    worst/tol)}: out at the bf16 scale tolerance, lam and raw at fp32's."""
    shape = dict(b=16, tq=31, tk=31, h=8, dh=64, e=64)
    args = list(mau_inputs(**shape, dtype=torch.bfloat16, gathered=False,
                           seed=seed))
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, tq, e, dh = shape["b"], shape["tq"], shape["e"], shape["dh"]
    args[3] = torch.zeros_like(args[3])                               # t
    args[5] = 37.3 + 0.01 * torch.rand(b, tq, generator=g, device="cuda")
    ulp = 2.0 ** -8
    v = torch.round((0.55 + 0.35 * torch.rand(
        e * dh, generator=g, device="cuda", dtype=torch.float64)) / ulp) * ulp
    target = v + 0.45 * ulp
    zc = torch.log(target / (1 - target))
    args[7][dh] = 2.0                                    # Wd's interval lane
    args[8] = (zc - 2.0 * 37.25).float()                              # bd
    args[9] = torch.full((e, dh), 0.5, device="cuda")                 # w
    args[10] = torch.zeros(e, device="cuda")                          # scaling
    q, k, vv, t, km, iv, oh, wd, bd, w, sc, qpos = args
    kw = dict(causal=False, diag=True, h=shape["h"])
    out, lam, raw = _launch_fwd(q, k, vv, t, km, iv, oh, wd, bd, w, sc, False,
                                True, shape["h"], qpos, None, 0.0,
                                want_raw=True)
    torch.cuda.synchronize()
    want = run_pair(mau_attention_reference, args, **kw)
    chain = _chain(q, k, vv, t, km, iv, oh, wd, bd, w, sc, causal=False,
                   diag_reset=True, dropout_rate=0.0, dropout_seed=None,
                   num_heads=shape["h"], qpos=qpos)
    name = "rounding_probe_bf16"
    return {"out": scale_err(name, "out", out, want[0], torch.bfloat16),
            "lam": scale_err(name, "lam", lam, want[1], torch.float32),
            "raw": scale_err(name, "raw", raw, chain["raw"], torch.float32)}


def phase_kernel_checks():
    log("phase 3: mau_attention kernel vs plain PyTorch on the card")
    errs = {}
    for i, case in enumerate(MAU_FWD_CASES):
        res = mau_fwd_case(i, *case)
        for label, (_, ratio) in res.items():
            check(ratio <= 1.0, f"{case[0]}: {label} outside tolerance")
        errs[case[0]] = max(err for err, _ in res.values())
    log("  the bf16 rounding points, held at the fp32 tolerance:")
    for label, (_, ratio) in rounding_probe().items():
        check(ratio <= 1.0, f"rounding probe: {label} outside tolerance")
    return errs


def mau_keys(km, causal=False, visible_only=False, shared_blind=False
             ) -> float:
    """The keys a query row of the MAU needs (Tq = Tk), averaged over the
    (batch row, query) pairs: the visible ones (``causal``: real and at or
    before the query). A masked key of a row that sees a real one gets a
    prob of exactly 0 and costs nothing. A row that sees no key has probs
    exactly uniform over all Tk keys, so it needs every key; with
    ``shared_blind`` only once per batch row (and head), since its m and l
    are constants and its seq_units, and at dropout 0 its output, come from
    one sum over the keys that every blind row of that batch row shares:
    the forward at dropout 0. A per-pair dropout mask (the backward's glam
    and dkvt) needs every key of every blind row. ``visible_only``: the
    visible ones alone, for dq, whose every term is 0 where an entry is not
    visible."""
    seen = (km > 0).double()
    vis = seen.cumsum(-1) if causal else seen.sum(-1, keepdim=True)
    if visible_only:
        return float(vis.mean())
    blind = vis == 0
    if shared_blind:   # Tk keys once over a batch row's Tk query rows
        return float((vis.mean(-1) + blind.any(-1)).mean())
    return float(torch.where(blind, float(km.shape[-1]), vis).mean())


def mau_work(*, b, tq, tk, h, dh, e, dtype, keys):
    """(bytes, flops) the function needs: each input read once, each output
    written once; the products of the chain over the ``keys`` (``mau_keys``)
    each query row needs."""
    it = torch.tensor([], dtype=dtype).element_size()
    c = h * dh
    nbytes = (it * (b * tq * c + 3 * b * tk * c)           # q, k, v, t
              + 4 * (b * tk + 2 * b * tq + b * tk * e)  # mask iv qpos onehot
              + it * ((dh + 1) * e * dh + e * dh) + 4 * (e * dh + e)
              + it * b * tq * c + 4 * b * h * tq * e)       # out, lam
    rows = b * h * tq
    flops = 2 * rows * (
        (dh + 1) * e * dh      # z = [su | iv] @ Wd
        + e * dh               # per-event reduce with w
        + 3 * keys * dh        # QK^T, probs @ T, modulated @ V
        + keys * e)            # lam @ onehot^T
    return nbytes, flops


def measured(row: dict) -> dict:
    """The entries of a timing row that the kernels line may carry: times
    this run measured and the bound. Floors, L2 bytes and tile shares are
    reckoned, not measured, and stay on their phase's log line."""
    return {k: v for k, v in row.items()
            if k in ("ms", "plain_ms", "bound_ms", "bound_by", "gemm_ms",
                     "ms_dropout_0_1")}


def time_ms(fn, warmup=3, iters=20):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def wd_l2_bytes(*, b, tq, h, dh, e, dtype, **_) -> int:
    """Bytes of Wd (and, in bf16, the interval lane, bd and w beside each
    tile) that the forward reads from L2 in one launch, reckoned from its
    grid and schedule, not read from a counter:
    bf16, for each of the intensity head's row blocks (64 rows a consumer
    warpgroup, ``int_groups``: three at dh <= 64, two at 128) the bf16 (dh,
    E*dh) tiles once and 3 x E*dh fp32 side lanes; fp32, each of the B*H
    blocks the fp32 (dh+1, E*dh) Wd once for every 32 query rows."""
    edh = e * dh
    if dtype == torch.bfloat16:
        blocks = -(-b * h * tq // (64 * (2 if dh == 128 else 3)))
        return blocks * (2 * dh * edh + 4 * 3 * edh)
    return b * h * -(-tq // 32) * 4 * (dh + 1) * edh


def phase_kernel_timing():
    log("phase 4: mau_attention timing at the flagship eval shape "
        "(B=512, T=31, C=512, H=8, E=64)")
    rows = {}
    fl = FLAGSHIP
    sigmoids = fl["b"] * fl["h"] * fl["tq"] * fl["e"] * fl["dh"]
    one, two = special_floor_ms(sigmoids), special_floor_ms(2 * sigmoids)
    for dtype in (torch.bfloat16, torch.float32):
        args = mau_inputs(**FLAGSHIP, dtype=dtype, gathered=False, seed=100)

        def kern():
            run_pair(mau_attention, args, causal=False, diag=True, h=8)

        def plain():
            run_pair(mau_attention_reference, args, causal=False, diag=True,
                     h=8)

        ms = time_ms(kern)
        plain_ms = time_ms(plain)
        nbytes, flops = mau_work(**FLAGSHIP, dtype=dtype,
                                 keys=mau_keys(args[4], shared_blind=True))
        bound_ms, bound_by = bound(nbytes, flops, dtype)
        l2 = wd_l2_bytes(**FLAGSHIP, dtype=dtype)
        log(f"  {str(dtype):15s} kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
            f"  bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB,"
            f" {flops / 1e9:.1f} GFLOP)  kernel/bound {ms / bound_ms:.1f}x;"
            f" sigmoid floor ({sigmoids / 1e6:.1f} M) {one:.4f} ms at one"
            f" special-function op a sigmoid, {two:.4f} ms at two (ex2 and a"
            f" reciprocal: the exact form the kernel runs"
            f"{', rounded to bf16' if dtype == torch.bfloat16 else ''});"
            f" Wd bytes from L2 reckoned from the grid (no counter read):"
            f" {l2 / 1e9:.3f} GB a launch")
        rows[dtype] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by,
                           sigmoid_form="exact (ex2 and a reciprocal)")
        if dtype == torch.bfloat16:
            split = kernel_split(kern)
            log("    by kernel: " + ", ".join(f"{n} {t:.4f} ms"
                                              for n, t in split.items()))
            rows[dtype]["by_kernel"] = split
    return rows


def scale_err(name, label, got, want, dtype):
    """(max |kernel - plain|, that over SCALE_TOL of the largest |plain|
    entry) of one output, logged."""
    a, b = got.float(), want.float()
    check(tuple(a.shape) == tuple(b.shape), f"{name}: {label} shape")
    check(bool(torch.isfinite(a).all()), f"{name}: {label} not finite")
    tol = SCALE_TOL[dtype]
    err = float((a - b).abs().max())
    scale = float(b.abs().max())
    ratio = (err / (tol * scale) if scale > 0.0 else
             0.0 if err == 0.0 else math.inf)
    log(f"  {name:24s} {label:16s}: max_abs={err:.3e}"
        f" max|plain|={scale:.3e} tol={tol:g}*max|plain|"
        f" worst/tol={ratio:.3f}")
    return err, ratio


def compare_by_scale(name, labels, got, want, dtype):
    """Holds each output to SCALE_TOL of its largest entry; returns the
    largest absolute error."""
    max_abs = 0.0
    for label, a, b in zip(labels, got, want):
        err, ratio = scale_err(name, label, a, b, dtype)
        check(ratio <= 1.0, f"{name}: {label} outside tolerance")
        max_abs = max(max_abs, err)
    return max_abs


def mau_bwd_args(args, dtype, seed):
    """g_out and g_lam at the magnitudes training gives them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, w = args[0], args[9]
    b, tq, c = q.shape
    e, dh = w.shape
    go = (torch.randn(b, tq, c, generator=g, device="cuda") * 1e-2).to(dtype)
    gl = torch.randn(b, c // dh, tq, e, generator=g, device="cuda") * 1e-3
    return go, gl


def run_mau_bwd(args, *, causal, diag, h, rate, seed, plain):
    """The forward kernel (training: dropout and the raw residual), then
    the backward kernel or its plain version, the same seed on both."""
    (q, k, v, t, km, iv, oh, wd, bd, w, sc, qpos) = args
    go, gl = mau_bwd_args(args, q.dtype, 7)
    sd = torch.tensor(seed, dtype=torch.int64, device="cuda")
    kw = dict(causal=causal, diag_reset=diag, dropout_rate=rate,
              dropout_seed=sd, num_heads=h, qpos=qpos)
    if plain:
        return mau_attention_bwd_reference(q, k, v, t, km, iv, oh, wd, bd, w,
                                           sc, go, gl, **kw)
    _, _, raw = _launch_fwd(q, k, v, t, km, iv, oh, wd, bd, w, sc, causal,
                            diag, h, qpos, _seed_tensor(sd, rate, q.device),
                            rate, want_raw=True)
    return mau_attention_bwd(q, k, v, t, km, iv, oh, wd, bd, w, sc, raw, go,
                             gl, **kw)


# name, shape, dtype, causal, diag, gathered, dropout rate
MAU_BWD_CASES = (
    ("bimau_bf16_flagship", FLAGSHIP, torch.bfloat16, False, True, False,
     0.0),
    ("bimau_bf16_drop", FLAGSHIP, torch.bfloat16, False, True, False, 0.1),
    ("bimau_fp32_flagship", FLAGSHIP, torch.float32, False, True, False, 0.0),
    ("bimau_fp32_drop", FLAGSHIP, torch.float32, False, True, False, 0.1),
    ("mau_causal_bf16", FLAGSHIP, torch.bfloat16, True, False, False, 0.1),
    ("mau_causal_fp32", FLAGSHIP, torch.float32, True, False, False, 0.0),
    ("bimau_qpos_tq6_bf16", dict(FLAGSHIP, tq=6), torch.bfloat16, False,
     True, True, 0.1),
    ("bimau_qpos_tq6_fp32", dict(FLAGSHIP, tq=6), torch.float32, False, True,
     True, 0.0),
    ("tk128_fp32_drop", dict(b=16, tq=128, tk=128, h=8, dh=64, e=64),
     torch.float32, False, True, False, 0.1),
    ("tk128_bf16", dict(b=16, tq=128, tk=128, h=8, dh=64, e=64),
     torch.bfloat16, True, False, False, 0.0),
    ("dh128_bimau_bf16", DH128, torch.bfloat16, False, True, False, 0.0),
    ("dh128_bimau_bf16_drop", DH128, torch.bfloat16, False, True, False,
     0.1),
    ("dh128_causal_bf16_drop", DH128, torch.bfloat16, True, False, False,
     0.1),
    ("dh128_causal_fp32", DH128, torch.float32, True, False, False, 0.0),
    ("dh128_bimau_fp32_drop", DH128, torch.float32, False, True, False, 0.1),
    ("ctsma_causal_dh128_bf16_drop", CTSMA_CHECK, torch.bfloat16, True,
     False, False, 0.2),
    # the tensor-core path at dh = 128: gathered queries (Tq < Tk), and
    # Tk = 128, where 16 query rows a block (qc < Tq) sum the key gradients
    # in fp32 across blocks
    ("dh128_bimau_qpos_tq6_bf16", dict(DH128, tq=6), torch.bfloat16, False,
     True, True, 0.1),
    ("tk128_dh128_causal_bf16", dict(b=16, tq=128, tk=128, h=4, dh=128,
                                     e=64), torch.bfloat16, True, False,
     False, 0.1),
)


def mau_bwd_case(i, name, shape, dtype, causal, diag, gathered, rate):
    """Case i of ``MAU_BWD_CASES``: the backward kernels against the plain
    version on the same inputs and seed; {output: (max abs err,
    worst/tol)} of the eight gradients, and of the training forward's out
    and lam under dropout; the kernels' dq."""
    args = mau_inputs(**shape, dtype=dtype, gathered=gathered, seed=50 + i)
    kw = dict(causal=causal, diag=diag, h=shape["h"], rate=rate,
              seed=1000 + i)
    got = run_mau_bwd(args, plain=False, **kw)
    torch.cuda.synchronize()
    want = run_mau_bwd(args, plain=True, **kw)
    res = {label: scale_err(name, label, a, b, dtype)
           for label, a, b in zip(MAU_GRADS, got, want)}
    if rate > 0:  # the training forward: the same mask on both sides
        sd = torch.tensor(1000 + i, dtype=torch.int64, device="cuda")
        fwd = mau_attention(*args[:11], causal, diag, rate,
                            num_heads=shape["h"], qpos=args[11],
                            dropout_seed=sd)
        ref = mau_attention_reference(
            *args[:11], causal=causal, diag_reset=diag, dropout_rate=rate,
            dropout_seed=sd, num_heads=shape["h"], qpos=args[11])
        for label, a, b in zip(("out", "lam"), fwd, ref):
            res["forward " + label] = scale_err(name + "_fwd", label, a, b,
                                                dtype)
    return res, got[0]


def phase_bwd_checks():
    log("phase 3b: mau_attention backward (and the training forward) kernel"
        " vs plain PyTorch on the card")
    errs = {}
    for i, case in enumerate(MAU_BWD_CASES):
        res, dq = mau_bwd_case(i, *case)
        for label, (_, ratio) in res.items():
            check(ratio <= 1.0, f"{case[0]}: {label} outside tolerance")
        errs[case[0]] = max(err for label, (err, _) in res.items()
                            if not label.startswith("forward"))
        # a fully masked row (row 0 of every case) gets zero dq
        check(float(dq[0].float().abs().max()) == 0.0,
              f"{case[0]}: fully masked row: dq not zero")
    return errs


def label_zero_rows(name, n, seed) -> torch.Tensor:
    """(n,) bool: the rows of one train batch of preset ``name`` whose label
    is id 0 (the flattened labels the train step scores), from left-padded
    histories of the lengths synthetic data draws: SASREC-LC's padded
    positions (n = B * L), BERT4REC-LC's masked positions that fall on
    padding (n = B * masklen)."""
    cfg = preset(name)
    split = synthetic_split_vectorized(num_rows=cfg.batch_size,
                                       num_items=cfg.num_items,
                                       seqslen=cfg.seqslen, seed=seed,
                                       with_datetime=True)
    loader = BatchLoader(split, data_mode=model_class(cfg).data_mode,
                         batch_size=cfg.batch_size, masklen=cfg.masklen,
                         is_training=True)
    _, labels, _ = next(iter(loader.epoch(0)))
    check(labels.size == n, f"{n} rows: not a {name} batch")
    return torch.as_tensor(labels.reshape(-1) == 0, device="cuda")


def sasrec_lc_padded_rows(n=SASREC_LC_CATALOG["n"]) -> torch.Tensor:
    """(B * L,) bool: the padded positions of one SASREC-LC train batch."""
    return label_zero_rows("SASREC-LC", n, 16)


def bert4rec_lc_masked_rows(n=BERT4REC_LC_CATALOG["n"]) -> torch.Tensor:
    """(B * masklen,) bool: the masked positions of one BERT4REC-LC train
    batch that fall on padding (the masked protocol's ignore_head = 0 lets
    a position fall anywhere)."""
    return label_zero_rows("BERT4REC-LC", n, 19)


def ctsma_padded_rows(n=CTSMA_CATALOG["n"]) -> torch.Tensor:
    """(B * L,) bool: the padded positions of one CTSMA train batch."""
    return label_zero_rows("CTSMA", n, 23)


def timelyrec_padded_rows(n=CTSMA_CATALOG["n"]) -> torch.Tensor:
    """(B * L,) bool: the padded positions of one TimelyREC train batch."""
    return label_zero_rows("TimelyREC", n, 51)


def alternating_rows(n) -> torch.Tensor:
    """(n,) bool, dead rows mixed within and across 64-row tiles: runs of
    three dead and three live rows, a whole dead tile (rows 64-127) and a
    whole live one (192-255)."""
    r = torch.arange(n, device="cuda")
    dead = (r // 3) % 2 == 0
    dead[64:128] = True
    dead[192:256] = False
    return dead


# rows whose gradient the case makes exactly zero (label 0, dlse = dll = 0)
CATALOG_DEAD = {"sasrec_lc_bf16_padded": sasrec_lc_padded_rows,
                "bert4rec_lc_bf16_masked": bert4rec_lc_masked_rows,
                "ctsma_bf16_padded": ctsma_padded_rows,
                "timelyrec_bf16_padded": timelyrec_padded_rows,
                "alternating_bf16": alternating_rows,
                "alternating_bf16_c64": alternating_rows,
                "alternating_fp32": alternating_rows}


def catalog_inputs(*, n, v, c, dtype, seed, label_term=True, dead=None,
                   untied=False):
    """The loss's cotangents: dlse and dll ~ N(0, 1) / N, or dll = 0 when
    ``label_term`` is off, so that g is the softmax term alone. ``dead``
    (n,) bool marks rows as the train step's padded positions: label 0
    and dlse = dll = 0. ``untied``: GREC's head, a learned bias on every
    id (no -1000 on id 0) and the table the transposed view of a (C, V)
    kernel, cast to the compute dtype as the train step casts it (the
    wrapper makes it contiguous)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    h = torch.randn(n, c, generator=g, device="cuda").to(dtype)
    table = (torch.rand(v, c, generator=g, device="cuda") - 0.5) * (
        2 * math.sqrt(6.0 / (v + c)))               # glorot, as the model
    b = torch.randn(v, generator=g, device="cuda") * 0.1
    if untied:
        table = table.t().contiguous().t()
    else:
        b[0] = -1000.0
    lab = torch.randint(0, v, (n,), generator=g, device="cuda")
    lab[0], lab[-1] = 0, v - 1
    dlse = torch.randn(n, generator=g, device="cuda") / n
    dll = torch.randn(n, generator=g, device="cuda") / n
    if not label_term:
        dll.zero_()
    if dead is not None:
        lab[dead] = 0
        dlse[dead] = 0.0
        dll[dead] = 0.0
    return h, table.to(dtype), b, lab, dlse, dll


# name, shape, dtype, label term, seed
CATALOG_CASES = (
    ("flagship_bf16", CATALOG, torch.bfloat16, True, 70),
    ("flagship_fp32", CATALOG, torch.float32, True, 71),
    ("unaligned_bf16", dict(n=77, v=1001, c=64), torch.bfloat16, True, 72),
    ("unaligned_fp32", dict(n=77, v=1001, c=64), torch.float32, True, 73),
    ("n15360_bf16", dict(CATALOG, n=15360), torch.bfloat16, True, 74),
    ("flagship_bf16_no_label_term", CATALOG, torch.bfloat16, False, 75),
    # SASREC-LC's training rows: B*T = 65,536 against its 17,771 items
    ("sasrec_lc_bf16", SASREC_LC_CATALOG, torch.bfloat16, True, 76),
    # the same with a SASREC-LC batch's padded rows (CATALOG_DEAD)
    ("sasrec_lc_bf16_padded", SASREC_LC_CATALOG, torch.bfloat16, True, 77),
    # BERT4REC-LC's training rows: B*masklen = 8,192 against its 17,773
    # ids (a vocab tail of 109 in a 128-id chunk), the rows whose masked
    # position fell on padding dead (CATALOG_DEAD)
    ("bert4rec_lc_bf16_masked", BERT4REC_LC_CATALOG, torch.bfloat16, True,
     81),
    # CTSMA's training rows: B*L = 15,360 against its 17,771 items, the
    # rows at the padding dead (CATALOG_DEAD)
    ("ctsma_bf16_padded", CTSMA_CATALOG, torch.bfloat16, True, 82),
    # dead and live rows mixed within and across 64-row tiles, on the
    # wgmma kernel (bf16, C = 512) and the CUDA cores (bf16 at C = 64, fp32)
    ("alternating_bf16", dict(n=333, v=1001, c=512), torch.bfloat16, True,
     78),
    ("alternating_bf16_c64", dict(n=333, v=1001, c=64), torch.bfloat16,
     True, 79),
    ("alternating_fp32", dict(n=333, v=1001, c=64), torch.float32, True, 80),
    # TGREC's training rows at C = 50, which the wrapper pads to 52
    ("tgrec_c50_bf16", TGREC_CATALOG, torch.bfloat16, True, 83),
    ("tgrec_c50_fp32", TGREC_CATALOG, torch.float32, True, 84),
    # GREC's masked rows against its untied head (CATALOG_UNTIED)
    ("grec_bf16_untied", GREC_CATALOG, torch.bfloat16, True, 85),
    ("grec_fp32_untied", GREC_CATALOG, torch.float32, True, 86),
    # TimelyREC's training rows, the padding dead (CATALOG_DEAD)
    ("timelyrec_bf16_padded", CTSMA_CATALOG, torch.bfloat16, True, 87))
CATALOG_UNTIED = ("grec_bf16_untied", "grec_fp32_untied")
CATALOG_FWD, CATALOG_BWD = ("lse", "ll"), ("d_hidden", "d_table", "d_bias")
CATALOG_FWD_CHECKS = CATALOG_FWD + ("ll label != 0",)


def catalog_case(name, shape, dtype, label_term, seed):
    """The catalog kernels vs their plain versions on one input:
    {output: (max_abs, worst/tol)}. The forward's lse and ll are held to
    the fp32 scale tolerance in both dtypes: each score sums products of
    the compute dtype's values, exact in fp32, in fp32 on both sides (the
    tensor cores, cuBLAS in fp32), so only fp32 reassociation and the
    exponentials separate them; ll also on the rows whose label is not id
    0 (``catalog_inputs`` gives id 0 a bias of -1000, which sets ll's
    largest entry). Besides each whole output, d_table and
    d_bias are held on the vocab ids that are no row's label, where g is
    the softmax term dlse * exp(s - lse) alone: at these inputs the label
    term's entries (dll * h, ~1/N) are ~1000x the softmax term's (~1/(N V)
    summed over N rows), so a whole-output scale alone would pass a wrong
    softmax term. The case without the label term holds d_hidden to it.
    Where the case has dead rows (``CATALOG_DEAD``), d_hidden must be
    exactly 0 on them."""
    dead = CATALOG_DEAD[name](shape["n"]) if name in CATALOG_DEAD else None
    h, t, b, lab, dlse, dll = catalog_inputs(**shape, dtype=dtype, seed=seed,
                                             label_term=label_term,
                                             dead=dead,
                                             untied=name in CATALOG_UNTIED)
    check(t.is_contiguous() != (name in CATALOG_UNTIED),
          f"{name}: the table's layout")
    got = catalog_nll_fwd(h, t, b, lab)
    torch.cuda.synchronize()
    want = catalog_nll_reference(h, t, b, lab)
    # ll also on the rows whose label is not id 0, whose bias of -1000 sets
    # ll's largest entry: a logit taken from a neighbouring id moves ll by
    # ~0.3, within 1e-4 of 1000
    other = lab != 0
    check(bool(other.any()), f"{name}: every label is id 0")
    res = {label: scale_err(name + "_fwd", label, a, w, torch.float32)
           for label, a, w in list(zip(CATALOG_FWD, got, want)) + [
               ("ll label != 0", got[1][other], want[1][other])]}
    lse = want[0]
    got = catalog_nll_bwd(h, t, b, lab, lse, dlse, dll)
    torch.cuda.synchronize()
    check(got[0].dtype == got[1].dtype == dtype, f"{name}: grad dtype")
    if dead is not None:
        check(bool(dead.any()) and not bool(dead.all()),
              f"{name}: no dead or no live row")
        check(float(got[0][dead].float().abs().max()) == 0.0,
              f"{name}: d_hidden is not exactly 0 on the dead rows")
    want = catalog_nll_bwd_reference(h, t, b, lab, lse, dlse, dll)
    free = torch.ones(t.shape[0], dtype=torch.bool, device="cuda")
    free[lab.long()] = False
    check(bool(free.any()), f"{name}: every vocab id is a label")
    outs = list(zip(CATALOG_BWD, got, want)) + [
        ("d_table no label", got[1][free], want[1][free]),
        ("d_bias no label", got[2][free], want[2][free])]
    for label, a, w in outs:
        res[label] = scale_err(name + "_bwd", label, a, w, dtype)
    return res


def phase_catalog_checks():
    log("phase 3c: catalog_nll kernels vs plain PyTorch on the card")
    errs = {}
    for name, shape, dtype, label_term, seed in CATALOG_CASES:
        res = catalog_case(name, shape, dtype, label_term, seed)
        for label, (_, ratio) in res.items():
            check(ratio <= 1.0, f"{name}: {label} outside tolerance")
        errs[name] = tuple(max(res[k][0] for k in keys)
                           for keys in (CATALOG_FWD_CHECKS, CATALOG_BWD))
    return errs


def stats_ratios(name, got, want, dtype):
    """{output: (max abs err, worst/tol)} of the stats kernel's (m, l,
    seq_units) against the plain version's, logged. A row that sees no key
    has m = -(2^32)+1 exactly and would set the scale of m and l: m there
    must be equal (else an infinite ratio), elsewhere within SCALE_TOL of
    the largest |m| of the rows that see a key; l (>= 1) within SCALE_TOL
    of itself, elementwise; seq_units by scale; an output that is not
    finite gets an infinite ratio."""
    m, l, su = got
    tol = SCALE_TOL[dtype]
    dead = want.m < -1e9
    res = {"m (dead rows)": (float((m[dead] - want.m[dead]).abs().max())
                             if bool(dead.any()) else 0.0,
                             0.0 if torch.equal(m[dead], want.m[dead])
                             else math.inf)}
    for label, a, b in (("m (live rows)", m[~dead], want.m[~dead]),
                        ("seq_units", su, want.su)):
        res[label] = (scale_err(name, label, a, b, dtype)
                      if bool(torch.isfinite(a).all()) else (math.inf, math.inf))
    l_err = (l - want.l).abs()
    l_ratio = float((l_err / (tol * want.l)).max())
    if not bool(torch.isfinite(l).all()):
        l_ratio = math.inf
    log(f"  {name:24s} {'l':16s}: max_abs={float(l_err.max()):.3e}"
        f" tol={tol:g}*|plain| elementwise worst/tol={l_ratio:.3f}")
    res["l"] = (float(l_err.max()), l_ratio)
    return res


def stats_check(i, name, shape, dtype, causal, diag, rate, case=None):
    """The stats kernel on case i of ``STREAMED_CASES`` against the plain
    forward's m, l and seq_units, and l on the fully masked row 0 (uniform
    over its Tk keys: l = Tk exactly): {output: (max abs err, worst/tol)}."""
    args, _, want = case or streamed_case(i, name, shape, dtype, causal,
                                          diag, rate)
    q, k, _, t, km, *_ = args
    before = mau_stats.launches
    got = mau_stats(q, k, t, km, causal=causal, num_heads=shape["h"])
    torch.cuda.synchronize()
    check(mau_stats.launches == before + 1, f"{name}: mau_stats no launch")
    res = stats_ratios(name, got, want, dtype)
    res["l of the fully masked row"] = (
        float((got[1][0] - shape["tk"]).abs().max()),
        0.0 if bool((got[1][0] == shape["tk"]).all()) else math.inf)
    return res


# E = 128 (two 64-event tiles); a batch with a fully masked row, a row whose
# first real key falls inside a key tile (under causal its rows before it
# see no key) and a row with 40 real keys
E128 = dict(LC, b=3, tq=300, tk=300, e=128)
BLIND = dict(LC, b=4, tq=1000, tk=1000, lengths=(0, 930, 40, 1000))
# name, shape, dtype, causal, diag_reset, dropout rate
STREAMED_CASES = (
    ("lc_bimau_bf16", LC, torch.bfloat16, False, True, 0.0),
    ("lc_bimau_fp32", LC, torch.float32, False, True, 0.0),
    ("lc_bimau_bf16_drop", LC, torch.bfloat16, False, True, 0.1),
    ("lc_causal_fp32_drop", LC, torch.float32, True, False, 0.1),
    ("t1000_causal_bf16", dict(LC, b=3, tq=1000, tk=1000), torch.bfloat16,
     True, False, 0.0),
    ("t300_bimau_fp32_drop", dict(LC, b=3, tq=300, tk=300), torch.float32,
     False, True, 0.1),
    ("t77_dh16_e4_bf16_drop", dict(b=3, tq=77, tk=77, h=2, dh=16, e=4),
     torch.bfloat16, True, False, 0.1),
    ("t300_e128_bimau_bf16_drop", E128, torch.bfloat16, False, True, 0.1),
    ("t1000_blind_causal_bf16_drop", BLIND, torch.bfloat16, True, False,
     0.1),
    ("t1000_blind_bimau_bf16", BLIND, torch.bfloat16, False, True, 0.0),
    # as CTSMA-LC drives them: causal, on its batch's key mask and spans
    ("ctsma_lc_causal_bf16_drop", dict(CTSMA_LC, b=2, batch="CTSMA-LC"),
     torch.bfloat16, True, False, 0.1))


def streamed_case(i, name, shape, dtype, causal, diag, rate):
    """Case i of ``STREAMED_CASES``: (its inputs, the dropout seed, the
    blocked plain forward)."""
    args = mau_inputs(**shape, dtype=dtype, gathered=False, seed=300 + i)
    sd = torch.tensor(5000 + i, dtype=torch.int64, device="cuda")
    want = mau_blocked_forward(*args[:11], causal=causal, diag_reset=diag,
                               dropout_rate=rate, dropout_seed=sd,
                               num_heads=shape["h"])
    return args, sd, want


def streamed_out_check(i, name, shape, dtype, causal, diag, rate,
                       case=None):
    """The output kernel on case i's plain forward (its lam, m and l)
    against the plain version's out: (max abs err, worst/tol)."""
    args, sd, want = case or streamed_case(i, name, shape, dtype, causal,
                                           diag, rate)
    q, k, v, t, km, iv, oh, *_ = args
    out = mau_modulated_out(q, k, v, km, oh, want.lam, want.m, want.l,
                            causal=causal, diag_reset=diag,
                            dropout_rate=rate, dropout_seed=sd,
                            num_heads=shape["h"])
    torch.cuda.synchronize()
    check(out.dtype == dtype, f"{name}: out dtype")
    return scale_err(name, "out", out, want.out, dtype)


# dh, E, B, T of the intensity head alone, H = 2: every head width the
# kernel takes, E = 64 and 128 and a wide one, row counts B * H * T that are
# no multiple of the 64-row tile, dh = 16 with a ragged last column tile
INTENSITY_CASES = ((16, 64, 2, 1000), (16, 3, 2, 77), (32, 128, 1, 999),
                   (64, 64, 3, 701), (64, 400, 1, 333), (128, 64, 2, 130),
                   (128, 128, 1, 333), (128, 700, 1, 77))


def intensity_check(i, dh, e, b, t):
    """The intensity head alone on seq_units ~ N(0, 0.5) at (dh, E, B, T)
    against ``intensity_reference``: (max abs err, worst/tol) at the fp32
    tolerance."""
    g = torch.Generator(device="cuda").manual_seed(900 + i)
    h, dev = 2, "cuda"

    def normal(*shape, std):
        return torch.randn(*shape, generator=g, device=dev) * std

    su = normal(b, h, t, dh, std=0.5)
    iv = (-torch.log(torch.rand(b, t, generator=g, device=dev))).clamp(0.0,
                                                                      100.0)
    wd, bd = normal(dh + 1, e * dh, std=0.2), normal(e * dh, std=0.1)
    w, sc = normal(e, dh, std=0.2), normal(e, std=0.3)
    before = mau_intensity.launches
    lam = mau_intensity(su, iv, wd, bd, w, sc)
    torch.cuda.synchronize()
    check(mau_intensity.launches == before + 1, "mau_intensity: no launch")
    return scale_err(f"int_dh{dh}_e{e}_b{b}_t{t}", "lam", lam,
                     intensity_reference(su, iv, wd, bd, w, sc),
                     torch.float32)


def phase_streamed_checks():
    log("phase 3d: streamed MAU kernels (stats, intensity head, modulated "
        "output) vs the blocked plain version on the card, each kernel on "
        "the plain version's inputs")
    log("  the intensity head alone at every head width (fp32 tolerance):")
    for i, case in enumerate(INTENSITY_CASES):
        check(intensity_check(i, *case)[1] <= 1.0,
              f"intensity {case}: lam outside tolerance")
    errs = {}
    for i, (name, shape, dtype, causal, diag, rate) in \
            enumerate(STREAMED_CASES):
        args, sd, want = streamed_case(i, name, shape, dtype, causal, diag,
                                       rate)
        q, k, v, t, km, iv, oh, wd, bd, w, sc, _ = args
        h = shape["h"]
        stats = stats_check(i, name, shape, dtype, causal, diag, rate,
                            (args, sd, want))
        for label, (_, ratio) in stats.items():
            check(ratio <= 1.0, f"{name}: stats {label} outside tolerance")
        lam = mau_intensity(want.su, iv, wd, bd, w, sc)
        torch.cuda.synchronize()
        check(lam.dtype == torch.float32, f"{name}: lam dtype")
        out_err, out_ratio = streamed_out_check(
            i, name, shape, dtype, causal, diag, rate, (args, sd, want))
        check(out_ratio <= 1.0, f"{name}: out outside tolerance")
        case = {"mau_stats": max(stats[label][0] for label in (
                    "m (live rows)", "seq_units")),
                "mau_intensity": compare_by_scale(name, ("lam",), (lam,),
                                                  (want.lam,), torch.float32),
                "mau_modulated_out": out_err}
        # the interval term must count, or a kernel that drops it would
        # pass (the TPU kernel drops it at dh % 128 == 0)
        lam0 = intensity_reference(want.su, torch.zeros_like(iv), wd, bd, w,
                                   sc)
        moved = float((want.lam - lam0).abs().max())
        need = 10 * SCALE_TOL[torch.float32] * float(want.lam.abs().max())
        log(f"  {name:24s} interval term: max|lam - lam(iv=0)| = "
            f"{moved:.3e} (must exceed {need:.3e})")
        check(moved > need, f"{name}: the interval term does not count")
        if i == 0:  # the three kernels chained, as the model calls them
            chain = mau_streamed(*args[:11], causal, diag, rate, num_heads=h,
                                 dropout_seed=sd)
            compare_by_scale(name + "_chain", ("out", "lam"), chain,
                             (want.out, want.lam), dtype)
        errs[name] = case
        del want, stats, lam
    log("  streamed vs fused kernels, T=31, fp32, dropout 0.1, one seed:")
    args = mau_inputs(**FLAGSHIP, dtype=torch.float32, gathered=False,
                      seed=399)
    sd = torch.tensor(4242, dtype=torch.int64, device="cuda")
    got = mau_streamed(*args[:11], False, True, 0.1, num_heads=8,
                       dropout_seed=sd)
    want = mau_attention(*args[:11], False, True, 0.1, num_heads=8,
                         dropout_seed=sd)
    compare_by_scale("streamed_vs_fused", ("out", "lam"), got, want,
                     torch.float32)
    log("  modulation probe, v_j = e_j (out_ij is the dropped, modulated prob"
        " of entry (i, j)), T=100, dh=128, dropout 0.1, held entry by entry:")
    for i, (name, dtype, causal, diag) in enumerate(PROBE_CASES):
        rel, dropped = modulation_probe(name, dtype, causal, diag,
                                        seed=460 + i)
        check(rel <= 1.0, f"{name}: an entry outside tolerance")
        check(0.07 < dropped < 0.13, f"{name}: dropped share {dropped:.4f}")
    return errs


# name, dtype, causal, diag_reset
PROBE_CASES = (("probe_bimau_bf16_drop", torch.bfloat16, False, True),
               ("probe_causal_bf16_drop", torch.bfloat16, True, False),
               ("probe_bimau_fp32_drop", torch.float32, False, True))


def modulation_probe(name, dtype, causal, diag, seed):
    """The output kernel with each key's value the unit vector of its index
    (v[j, h*dh + d] = 1 where d == j), so out[i, h*dh + j] is entry (h, i, j)
    of the dropped, modulated probs, rounded once. That holds the probs, iqk,
    the diagonal reset and the dropout mask entry by entry, where a check by
    scale averages them over the keys: entries the plain version drops or
    hides are 0 on both sides, the others within SCALE_TOL of themselves (a
    rounding may flip by an ulp). T=100 spans a full and a partial key tile;
    about a tenth of the nonzero entries must be dropped. Returns (the worst
    |kernel - plain| / |plain| over SCALE_TOL, inf where an entry that
    should be 0 is not; the dropped share)."""
    shape = dict(b=3, tq=100, tk=100, h=2, dh=128, e=4)
    b, tk, h, dh = shape["b"], shape["tk"], shape["h"], shape["dh"]
    args = list(mau_inputs(**shape, dtype=dtype, gathered=False, seed=seed))
    args[2] = torch.eye(tk, dh, device="cuda")[None, :, None, :].expand(
        b, tk, h, dh).reshape(b, tk, h * dh).to(dtype).contiguous()
    q, k, v, t, km, iv, oh, wd, bd, w, sc, _ = args
    sd = torch.tensor(seed, dtype=torch.int64, device="cuda")
    kw = dict(causal=causal, diag_reset=diag, num_heads=h)
    want = mau_blocked_forward(*args[:11], dropout_rate=0.1, dropout_seed=sd,
                               **kw)
    kept = output_reference(q, k, v, km, oh, want.lam, want.m, want.l,
                            **kw).float()
    got = mau_modulated_out(q, k, v, km, oh, want.lam, want.m, want.l,
                            dropout_rate=0.1, dropout_seed=sd, **kw).float()
    ref = want.out.float()
    zero = ref == 0
    zeros_ok = torch.equal(got[zero], ref[zero])
    rel = float(((got - ref).abs()[~zero] / ref.abs()[~zero]).max())
    dropped = float((zero & (kept != 0)).sum() / (kept != 0).sum())
    log(f"  {name:24s} nonzero entries: max |kernel - plain| / |plain| ="
        f" {rel:.3e} (tol {SCALE_TOL[dtype]:g}); dropped share {dropped:.4f}"
        f" of {int((kept != 0).sum())}; zeros kept: {zeros_ok}")
    return (rel / SCALE_TOL[dtype] if zeros_ok else math.inf), dropped


# name, shape, dtype, causal, diag_reset, dropout rate
STREAMED_BWD_CASES = (
    ("lc_bimau_bf16_drop", dict(LC, b=2), torch.bfloat16, False, True, 0.1),
    ("lc_bimau_fp32", dict(LC, b=2), torch.float32, False, True, 0.0),
    ("lc_causal_bf16", dict(LC, b=2), torch.bfloat16, True, False, 0.0),
    ("lc_causal_fp32_drop", dict(LC, b=2), torch.float32, True, False, 0.1),
    ("t300_bimau_bf16", dict(LC, b=3, tq=300, tk=300), torch.bfloat16, False,
     True, 0.0),
    ("t300_causal_fp32_drop", dict(LC, b=3, tq=300, tk=300), torch.float32,
     True, False, 0.1),
    ("t77_dh16_e4_bf16_drop", dict(b=3, tq=77, tk=77, h=2, dh=16, e=4),
     torch.bfloat16, True, False, 0.1),
    ("t65_dh32_e12_fp32_drop", dict(b=2, tq=65, tk=65, h=4, dh=32, e=12),
     torch.float32, False, True, 0.1),
    ("t300_e128_bimau_bf16_drop", E128, torch.bfloat16, False, True, 0.1),
    ("t1000_blind_causal_bf16_drop", BLIND, torch.bfloat16, True, False,
     0.1),
    ("t1000_blind_bimau_bf16", BLIND, torch.bfloat16, False, True, 0.0),
    ("ctsma_lc_causal_bf16_drop", dict(CTSMA_LC, b=2, batch="CTSMA-LC"),
     torch.bfloat16, True, False, 0.1))
INTENSITY_GRADS = ("g_su", "dWd", "dbd", "dw", "dscaling")


def streamed_bwd_pieces(args, h, *, causal, diag, rate, seed, plain_fwd,
                        cotangent_seed=7):
    """The backward pieces of each kernel on the plain version's inputs:
    the plain forward's residuals, g_out / g_lam at training magnitudes,
    then for each kernel (its name, the kernel call, the plain call)."""
    q, k, v, t, km, iv, oh, wd, bd, w, sc, _ = args
    sd = torch.tensor(seed, dtype=torch.int64, device="cuda")
    kw = dict(causal=causal, diag_reset=diag, dropout_rate=rate,
              dropout_seed=sd, num_heads=h)
    fwd = (mau_blocked_forward(*args[:11], **kw) if plain_fwd is None
           else plain_fwd)
    go, gl_up = mau_bwd_args(args, q.dtype, cotangent_seed)
    g_lam = glam_reference(q, k, v, km, oh, fwd.m, fwd.l, go, **kw) + gl_up
    g_su = intensity_vjp_reference(fwd.su, iv, wd, bd, w, sc, g_lam)[0]
    rho = row_correction(fwd.out, go, fwd.su, g_su, h)
    p2 = (q, k, v, t, km, oh, fwd.lam, fwd.m, fwd.l, go, g_su, rho)
    runs = {
        "mau_glam": (lambda: mau_glam(q, k, v, km, oh, fwd.m, fwd.l, go, **kw),
                     lambda: glam_reference(q, k, v, km, oh, fwd.m, fwd.l, go,
                                            **kw)),
        "mau_intensity_bwd": (
            lambda: mau_intensity_bwd(fwd.su, iv, wd, bd, w, sc, g_lam),
            lambda: intensity_vjp_reference(fwd.su, iv, wd, bd, w, sc,
                                            g_lam)),
        "mau_dq": (lambda: mau_dq(*p2, **kw), lambda: dq_reference(*p2, **kw)),
        "mau_dkvt": (lambda: mau_dkvt(*p2, **kw),
                     lambda: dkvt_reference(*p2, **kw))}
    return fwd, (go, gl_up), runs


def chained_grads(fn, args, h, go, gl, *, causal, diag, rate, seed):
    """The eight gradients of ``fn`` (mau_streamed or mau_blocked) by
    autograd at cotangents (go, gl)."""
    diff = [x.detach().clone().requires_grad_(i in (0, 1, 2, 3, 7, 8, 9, 10))
            for i, x in enumerate(args[:11])]
    sd = torch.tensor(seed, dtype=torch.int64, device="cuda")
    out, lam = fn(*diff, causal, diag, rate, num_heads=h, dropout_seed=sd)
    return torch.autograd.grad(
        (out.float() * go.float()).sum() + (lam * gl).sum(),
        [diff[i] for i in (0, 1, 2, 3, 7, 8, 9, 10)])


def streamed_bwd_case(i, name, shape, dtype, causal, diag, rate,
                      only=None):
    """Case i of ``STREAMED_BWD_CASES``: each backward kernel (those named
    in ``only``, else all four) against its plain piece on the plain
    version's inputs; {kernel: {output: (max abs err, worst/tol)}} (the
    intensity VJP held at the fp32 tolerance in both dtypes), and the
    inputs and cotangents for the chained check."""
    args = mau_inputs(**shape, dtype=dtype, gathered=False, seed=600 + i)
    flags = dict(causal=causal, diag=diag, rate=rate, seed=6000 + i)
    fwd, (go, gl), runs = streamed_bwd_pieces(args, shape["h"],
                                              plain_fwd=None, **flags)
    labels = {"mau_intensity_bwd": INTENSITY_GRADS, "mau_glam": ("g_lam",),
              "mau_dq": ("dq",), "mau_dkvt": ("dk", "dv", "dt")}
    case = {}
    for kname, (kern, plain) in runs.items():
        if only is not None and kname not in only:
            continue
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        got, want = ((got, want) if isinstance(got, tuple)
                     else ((got,), (want,)))
        if kname != "mau_intensity_bwd":
            check(all(x.dtype == (torch.float32 if kname == "mau_glam"
                                  else dtype) for x in got),
                  f"{name}: {kname} dtype")
        tol_dtype = torch.float32 if kname == "mau_intensity_bwd" else dtype
        case[kname] = {label: scale_err(name, label, a, b, tol_dtype)
                       for label, a, b in zip(labels[kname], got, want)}
        del got, want
    del fwd, runs
    return case, args, (go, gl), flags


def phase_streamed_bwd_checks():
    log("phase 3e: streamed MAU backward kernels (d-lambda, intensity VJP, "
        "dq, dk/dv/dt) vs the blocked plain pieces on the card, each kernel"
        " on the plain version's inputs; then the chained backward")
    errs = {}
    for i, (name, shape, dtype, causal, diag, rate) in \
            enumerate(STREAMED_BWD_CASES):
        case, args, (go, gl), flags = streamed_bwd_case(
            i, name, shape, dtype, causal, diag, rate)
        for kname, res in case.items():
            for label, (_, ratio) in res.items():
                check(ratio <= 1.0, f"{name}: {label} outside tolerance")
        errs[name] = {kname: max(err for err, _ in res.values())
                      for kname, res in case.items()}
        if i < 2:  # the chained backward, as the model calls it
            h = shape["h"]
            got = chained_grads(mau_streamed, args, h, go, gl, **flags)
            torch.cuda.synchronize()
            want = chained_grads(mau_blocked, args, h, go, gl, **flags)
            compare_by_scale(name + "_chain", MAU_GRADS, got, want, dtype)
            check(float(got[0][0].float().abs().max()) == 0.0,
                  f"{name}: the fully masked row has a nonzero dq")
    return errs


# ---------------------------------------------------------------- flash

# (name, B, H, Tq, Tk, dh, dtype, causal, rate); every case has a fully
# masked row 0, and left-padded rows where Tq == Tk
FLASH_CASES = (
    ("lc_causal_bf16_drop", 2, 8, 2048, 2048, 64, torch.bfloat16, True, 0.1),
    ("lc_causal_fp32", 2, 8, 2048, 2048, 64, torch.float32, True, 0.0),
    ("lc_full_bf16", 2, 8, 2048, 2048, 64, torch.bfloat16, False, 0.0),
    ("lc_full_fp32_drop", 2, 8, 2048, 2048, 64, torch.float32, False, 0.1),
    ("t77_causal_fp32_drop", 3, 2, 77, 77, 64, torch.float32, True, 0.1),
    ("t300_full_bf16_drop", 2, 4, 300, 300, 32, torch.bfloat16, False, 0.1),
    ("t1000_causal_bf16_dh16", 2, 2, 1000, 1000, 16, torch.bfloat16, True,
     0.0),
    ("t1000_full_fp32_dh16", 2, 2, 1000, 1000, 16, torch.float32, False,
     0.0),
    ("tq100_tk300_causal_fp32_drop", 2, 4, 100, 300, 64, torch.float32, True,
     0.1),
    ("tq300_tk77_full_bf16", 2, 4, 300, 77, 32, torch.bfloat16, False, 0.0),
    ("tq300_tk77_causal_bf16_drop", 2, 4, 300, 77, 64, torch.bfloat16, True,
     0.1),
    # whole batch rows of padding (rows 0 and 2) beside a row with none
    ("t1000_dead_rows_causal_bf16_drop", 4, 2, 1000, 1000, 64,
     torch.bfloat16, True, 0.1),
    # Tk not a multiple of 64, padding that ends mid-tile (100 keys)
    ("t333_midtile_causal_bf16_drop", 2, 4, 333, 333, 64, torch.bfloat16,
     True, 0.1),
    ("t333_midtile_full_fp32", 2, 4, 333, 333, 64, torch.float32, False,
     0.0),
    # BERT4REC-LC's attention: non-causal, bf16, dropout 0.1; a row of
    # padding beside one whose padding ends mid-tile (700 keys)
    ("bert4rec_lc_full_bf16_drop", 2, 8, 2048, 2048, 64, torch.bfloat16,
     False, 0.1))
# left padding a batch row for the cases that set it (Tk or more: a row of
# padding), in place of random lengths
FLASH_PAD = {"t1000_dead_rows_causal_bf16_drop": (1000, 300, 1000, 0),
             "tgat_w2048_causal_bf16": (300, 70),
             "tgat_w2048_causal_bf16_drop": (300, 70),
             "tgat_w2048_causal_fp32_drop": (300, 70),
             "tgat_w2048_v2048_causal_fp32": (130, 100),
             "tgrec_w150_causal_fp32": (333, 100, 0),
             "tgrec_w150_causal_fp32_drop": (333, 100, 0),
             "tgat_w2048_t2048_causal_bf16": (2048, 100, 1037),
             "tgat_w2048_t2048_causal_bf16_drop": (2048, 100, 1037),
             "tgrec_w150_t2048_causal_fp32": (2048, 37, 700),
             "t333_midtile_causal_bf16_drop": (0, 100),
             "t333_midtile_full_fp32": (0, 100),
             "bert4rec_lc_full_bf16_drop": (2048, 700)}
# dh = 128: the narrow forward kernels, the wide backward kernel; then
# TimelyREC's user tower at its preset (B = 512, H = 4, T = 30, causal,
# left-padded rows, attention dropout 0.1), and in fp32 on 64 rows
FLASH_DH128_CASES = (
    ("t300_causal_bf16_dh128", 2, 2, 300, 300, 128, torch.bfloat16, True,
     0.1),
    ("t300_full_fp32_dh128", 2, 2, 300, 300, 128, torch.float32, False,
     0.0),
    ("timelyrec_causal_bf16_drop", 512, 4, 30, 30, 128, torch.bfloat16,
     True, 0.1),
    ("timelyrec_causal_fp32", 64, 4, 30, 30, 128, torch.float32, True,
     0.0))
# the wide kernels (flash_wide.cu) at the Bochner models' augmented heads,
# H = 1, causal, left-padded: TGAT's q and k 2,048 wide with v at dh = 512
# (as the port passes it) in bf16 and fp32, and v 2,048 wide in fp32;
# TGREC's 150 in fp32 (FLASH_WIDE gives v's width and q's and k's spread)
FLASH_WIDE_CASES = (
    ("tgat_w2048_causal_bf16", 2, 1, 300, 300, 2048, torch.bfloat16, True,
     0.0),
    ("tgat_w2048_causal_bf16_drop", 2, 1, 300, 300, 2048, torch.bfloat16,
     True, 0.1),
    ("tgat_w2048_causal_fp32_drop", 2, 1, 300, 300, 2048, torch.float32,
     True, 0.1),
    ("tgat_w2048_v2048_causal_fp32", 2, 1, 130, 130, 2048, torch.float32,
     True, 0.0),
    ("tgrec_w150_causal_fp32", 3, 1, 333, 333, 150, torch.float32, True,
     0.0),
    ("tgrec_w150_causal_fp32_drop", 3, 1, 333, 333, 150, torch.float32,
     True, 0.1),
    # at the models' flash shape, T = 2048 (TGAT's dropout 0.1, TGREC's
    # 0), where a key tile's 32 query tiles split over 8 blocks; scale
    # 1/sqrt(dh) of the un-augmented head, as the models pass it
    ("tgat_w2048_t2048_causal_bf16", 3, 1, 2048, 2048, 2048, torch.bfloat16,
     True, 0.0),
    ("tgat_w2048_t2048_causal_bf16_drop", 3, 1, 2048, 2048, 2048,
     torch.bfloat16, True, 0.1),
    ("tgrec_w150_t2048_causal_fp32", 3, 1, 2048, 2048, 150, torch.float32,
     True, 0.0))
FLASH_WIDE = {name: dict(dv=512, qk_std=0.3) for name in (
    "tgat_w2048_causal_bf16", "tgat_w2048_causal_bf16_drop",
    "tgat_w2048_causal_fp32_drop", "tgat_w2048_t2048_causal_bf16",
    "tgat_w2048_t2048_causal_bf16_drop")}
FLASH_WIDE.update({name: dict(qk_std=0.3) for name in (
    "tgat_w2048_v2048_causal_fp32", "tgrec_w150_causal_fp32",
    "tgrec_w150_causal_fp32_drop", "tgrec_w150_t2048_causal_fp32")})
FLASH_SCALE = {"tgat_w2048_t2048_causal_bf16": 512 ** -0.5,
               "tgat_w2048_t2048_causal_bf16_drop": 512 ** -0.5,
               "tgrec_w150_t2048_causal_fp32": 50 ** -0.5}
# the cases whose (max abs err, worst/tol) the kernels line reports
FLASH_WIDE_REPORTED = ("timelyrec_causal_bf16_drop",
                       "tgat_w2048_causal_bf16_drop",
                       "tgrec_w150_causal_fp32_drop",
                       "tgat_w2048_t2048_causal_bf16",
                       "tgat_w2048_t2048_causal_bf16_drop",
                       "tgrec_w150_t2048_causal_fp32")
FLASH_GRADS = ("dq", "dk", "dv")


def flash_inputs(b, h, tq, tk, dh, dtype, seed, pad=None, dv=None,
                 qk_std=1.0):
    """q, k ~ N(0, qk_std^2) (B, H, T, dh), v, dO ~ N(0, 1) (B, H, T, dv,
    default dh), views of the (B, T, C) layout the model gives them; a key
    mask with 10% holes, left-padded where Tq == Tk (``pad`` keys a row,
    else a random length a row), with row 0 fully masked. At the wide
    heads qk_std < 1 keeps the logits, sums of 2,048 products, of order
    1."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def heads(t, w, std=1.0):
        x = (std * torch.randn(b, t, h * w, generator=g, device=dev)).to(
            dtype)
        return x.view(b, t, h, w).transpose(1, 2)

    dv = dh if dv is None else dv
    q, k = heads(tq, dh, qk_std), heads(tk, dh, qk_std)
    v, dout = heads(tk, dv), heads(tq, dv)
    km = (torch.rand(b, tk, generator=g, device=dev) > 0.1).float()
    if tq == tk:
        lengths = (torch.randint(1, tk + 1, (b,), generator=g, device=dev)
                   if pad is None else
                   tk - torch.tensor(pad, device=dev).clamp(max=tk))
        km = km * (torch.arange(tk, device=dev)[None]
                   >= tk - lengths[:, None]).float()
    km[0] = 0.0
    return q, k, v, km, dout


def flash_plain_chain(q, k, v, km, dout, kw):
    """The plain pieces chained as ``_FlashAttention`` chains the kernels:
    (out, lse, delta, dq, dk, dv)."""
    out, lse = flash_fwd_reference(q, k, v, km, **kw)
    delta = flash_delta(dout, out)
    return (out, lse, delta) + flash_bwd_reference(q, k, v, km, dout, lse,
                                                   delta, **kw)


def flash_chain(fn, q, k, v, km, dout, kw):
    """(dq, dk, dv) by autograd of ``fn`` (flash_attention, or the plain
    forward) at the cotangent dO."""
    diff = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = fn(*diff, km, **kw)
    return torch.autograd.grad((out.float() * dout.float()).sum(), diff)


def check_zero_row(name, tensors, rows=(0,)):
    for label, x in tensors:
        for r in rows:
            check(float(x[r].float().abs().max()) == 0.0,
                  f"{name}: {label} is not exactly 0 on the fully masked"
                  f" row {r}")


def flash_dropout_probe(dtype, t=64):
    """q = 0 and k = v = I (uniform probs 1/t over the t keys): out, dq (at
    dO = 1) and dv (at dO = I) of the kernels show the keep factor of every
    (i, j) as they drew it; each is held to ``dropout_factor``. out * t is
    keep rounded to the compute dtype (p = exp(0) = 1 exactly); dv and dq
    carry p = exp(-log t), within an ulp of 1/t, rounded to bf16 once (dv)
    or twice (dq: ds, then dq) in bf16."""
    b, h, rate = 2, 2, 0.25
    eye = torch.eye(t, device="cuda").expand(b, h, t, t).to(dtype)
    eye = eye.contiguous()
    q = torch.zeros(b, h, t, t, device="cuda", dtype=dtype)
    ones = torch.ones(b, h, t, t, device="cuda", dtype=dtype)
    km = torch.ones(b, t, device="cuda")
    kw = dict(causal=False, dropout_rate=rate, scale=1.0,
              seed=torch.tensor(123, device="cuda"))
    out, lse = flash_attention_fwd(q, eye, eye, km, **kw)
    delta = flash_delta(ones, out)
    dq = flash_attention_bwd(q, eye, eye, km, ones, lse, delta, **kw)[0]
    dv = flash_attention_bwd(q, eye, eye, km, eye, lse,
                             flash_delta(eye, out), **kw)[2]
    keep = dropout_factor(123, (b, h, t, t), rate, "cuda")
    bf16 = dtype == torch.bfloat16
    torch.testing.assert_close(out.float() * t, keep.to(dtype).float(),
                               atol=0, rtol=0)
    torch.testing.assert_close(dv.transpose(-1, -2).float() * t, keep,
                               atol=0, rtol=1e-2 if bf16 else 1e-5)
    torch.testing.assert_close(dq.float() * t + delta[..., None], keep,
                               atol=2e-2 if bf16 else 1e-5, rtol=0)
    kernels = "narrow" if t in (16, 32, 64) else "wide"
    log(f"  dropout probe ({str(dtype)[6:]}, width {t}, the {kernels}"
        f" kernels): out, dq and dv draw dropout_factor's mask (keep"
        f" {float((keep > 0).float().mean()):.4f})")


def phase_flash_checks():
    log("phase 3f: flash attention kernels (forward; dq, dk, dv in one"
        " backward) vs the plain versions on the card, each kernel on the"
        " plain version's inputs, the backward launched twice; then the"
        " chained _FlashAttention backward and the dropout probe; the wide"
        " kernels (flash_wide.cu) at dh = 128's backward and at TGAT's and"
        " TGREC's augmented heads")
    errs = {}
    for i, (name, b, h, tq, tk, dh, dtype, causal, rate) in enumerate(
            FLASH_CASES + FLASH_DH128_CASES + FLASH_WIDE_CASES):
        q, k, v, km, dout = flash_inputs(b, h, tq, tk, dh, dtype, 900 + i,
                                         FLASH_PAD.get(name),
                                         **FLASH_WIDE.get(name, {}))
        sd = torch.tensor(9000 + i, dtype=torch.int64, device="cuda")
        kw = dict(causal=causal, dropout_rate=rate, seed=sd,
                  scale=FLASH_SCALE.get(name))
        got = flash_attention_fwd(q, k, v, km, **kw)
        torch.cuda.synchronize()
        want = flash_fwd_reference(q, k, v, km, **kw)
        check(got[0].dtype == dtype and got[1].dtype == torch.float32,
              f"{name}: out / lse dtype")
        # out: held to its summands, scale = the plain version run on |v|
        # (sum_j p_ij keep_ij |v_j| / l_i): in bf16 the kernel rounds each
        # p to bf16 relative to the running max, the plain version relative
        # to the row's max, so a summand can differ by one bf16 ulp (2^-8),
        # and out itself is rounded once; in fp32 both sum in another order.
        # lse is fp32 in both dtypes (1e-4 relative).
        scale = (flash_fwd_reference(q, k, v.abs(), km, **kw)[0]
                 if dtype == torch.bfloat16 else want[0])
        res = {"flash_attention_fwd": compare_ratios(
            name, got, want, dtype, scale, labels=("out", "lse"),
            second_tol=TOL[torch.float32])}
        check_zero_row(name, [("out", got[0])])
        out_p, lse_p, delta_p, dq_p, dk_p, dv_p = flash_plain_chain(
            q, k, v, km, dout, kw)
        bwd = (q, k, v, km, dout, lse_p, delta_p)
        grads = flash_attention_bwd(*bwd, **kw)
        torch.cuda.synchronize()
        res["flash_attention_bwd"] = {
            label: scale_err(name, label, a, b, dtype)
            for label, a, b in zip(FLASH_GRADS, grads, (dq_p, dk_p, dv_p))}
        # {kernel: (max abs err, worst/tol)}, each output within tolerance
        case = {}
        for kname, outs in res.items():
            for label, (_, ratio) in outs.items():
                check(ratio <= 1.0, f"{name}: {label} outside tolerance")
            case[kname] = (max(err for err, _ in outs.values()),
                           max(ratio for _, ratio in outs.values()))
        dead = [r for r in range(b) if not bool((km[r] > 0).any())]
        check_zero_row(name, zip(FLASH_GRADS, grads), dead)
        # run to run: the narrow kernel's dk and dv are each one block's
        # sums, so two launches agree exactly; dq (and the wide kernel's dk
        # and dv, a key tile's query tiles split over blocks) sums its parts
        # by atomics in the order the blocks run, so it is held to the
        # kernel-vs-plain tolerance
        again = flash_attention_bwd(*bwd, **kw)
        torch.cuda.synchronize()
        exact = narrow_kernels(_BWD, q, v)
        check(not exact or (torch.equal(again[1], grads[1])
                            and torch.equal(again[2], grads[2])),
              f"{name}: dk / dv differ between two launches")
        n_rerun = 1 if exact else 3
        compare_by_scale(name + "_rerun", FLASH_GRADS[:n_rerun],
                         again[:n_rerun], grads[:n_rerun], dtype)
        # the chained backward: fp32 against autograd of the plain forward,
        # bf16 against the chained plain pieces (the same rounding points)
        chain = flash_chain(flash_attention, q, k, v, km, dout, kw)
        torch.cuda.synchronize()
        ref = (flash_chain(flash_attention_reference, q, k, v, km, dout, kw)
               if dtype == torch.float32 else (dq_p, dk_p, dv_p))
        compare_by_scale(name + "_chain", FLASH_GRADS, chain, ref, dtype)
        check_zero_row(name + "_chain", zip(FLASH_GRADS, chain), dead)
        errs[name] = case
        del got, want, scale, out_p, dq_p, dk_p, dv_p, chain, ref, grads
    for dtype in (torch.bfloat16, torch.float32):
        for t in (64, 256):
            flash_dropout_probe(dtype, t)
    return errs


SASREC_LC_ATTN = dict(b=32, h=8, t=2048, dh=64)   # one SASREC-LC block
# one backward kernel replaces the TPU's dq and dk/dv kernels: the kernels
# line has an entry for each TPU row, both naming it
FLASH_REPLACES = (
    ("flash_attention_fwd", "easydgl_tpu/kernels/flash_attention.py:318"),
    ("flash_attention_bwd", "easydgl_tpu/kernels/flash_attention.py:366"),
    ("flash_attention_bwd", "easydgl_tpu/kernels/flash_attention.py:390"))


def visible_pairs(km, t, causal=True) -> float:
    """The (query, key) pairs the key mask and causality leave visible,
    summed over the batch rows, T = Tq = Tk: key j is seen by the T - j
    queries at or after it under causality, by all T otherwise."""
    seen_by = torch.arange(t, 0, -1, device=km.device, dtype=torch.float64)
    if not causal:
        seen_by.fill_(t)
    return float(((km > 0).double() * seen_by).sum())


def flash_work(name, km, *, h, t, dh, dtype, causal=True, dv=None):
    """(bytes, flops) of one flash kernel on these inputs: q, k, v (dO) read
    once, out (dq, dk, dv) written once, the key mask and the fp32 row
    stats; the products over the visible pairs (``visible_pairs``), which
    the function needs: two in the forward (QK^T, PV), five in the backward
    (QK^T, dO V^T, P^T dO, dS^T Q, dS K). The kernels do more: they compute
    whole 64 x 64 tiles, those on the diagonal and those with masked keys."""
    b = km.shape[0]
    dv = dh if dv is None else dv
    it = torch.tensor([], dtype=dtype).element_size()
    seq, seq_v, rows = it * b * h * t * dh, it * b * h * t * dv, b * h * t
    pairs = 2 * h * visible_pairs(km, t, causal)   # 2 flops a product term
    if name == "flash_attention_fwd":   # q, k, v in; out, lse out
        return 2 * seq + 2 * seq_v + 4 * b * t + 4 * rows, \
            pairs * (dh + dv)
    # q, k, v, dO, lse, delta in; dq, dk, dv out
    return 4 * seq + 3 * seq_v + 4 * b * t + 8 * rows, \
        pairs * (3 * dh + 2 * dv)


def visited_tile_share(km, t, causal=True) -> float:
    """The share of the causal (query tile, key tile) pairs that the
    forward and the backward visit on this key mask
    (``flash_visited_tiles``)."""
    b, n = km.shape[0], -(-t // 64)
    visited = flash_visited_tiles(flash_live_tiles(km), t, causal)
    return float(visited.sum()) / (b * (n * (n + 1) // 2 if causal
                                        else n * n))


def sdpa_times(q, k, v, dout, mask, dropout_p=0.0):
    """(forward ms, backward ms) of F.scaled_dot_product_attention on the
    same inputs; the backward as forward + backward minus the forward,
    both with inputs that need a gradient."""
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))
    kw = dict(attn_mask=mask) if mask is not None else dict(is_causal=True)
    kw["dropout_p"] = dropout_p

    def fwd():
        return F.scaled_dot_product_attention(qg, kg, vg, **kw)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qg, kg, vg), dout)

    f_ms = time_ms(fwd, warmup=2, iters=10)
    return f_ms, time_ms(fwd_bwd, warmup=2, iters=10) - f_ms


def phase_flash_timing():
    log("phase 4e: flash kernels at the SASREC-LC shape (B=32, H=8, T=2048,"
        " dh=64, causal, left-padded key mask)")
    rows = {}
    sh = SASREC_LC_ATTN
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, km, dout = flash_inputs(sh["b"], sh["h"], sh["t"], sh["t"],
                                         sh["dh"], dtype, 950)
        sd = torch.tensor(9500, dtype=torch.int64, device="cuda")
        kw0 = dict(causal=True)
        kwd = dict(causal=True, dropout_rate=0.1, seed=sd)
        out, lse = flash_attention_fwd(q, k, v, km, **kw0)
        bwd = (q, k, v, km, dout, lse, flash_delta(dout, out))
        runs = {
            "flash_attention_fwd": (
                lambda kw: flash_attention_fwd(q, k, v, km, **kw),
                lambda: flash_fwd_reference(q, k, v, km, **kw0)),
            "flash_attention_bwd": (
                lambda kw: flash_attention_bwd(*bwd, **kw),
                lambda: flash_bwd_reference(*bwd, **kw0))}
        t = sh["t"]
        tril = torch.ones((t, t), dtype=torch.bool, device="cuda").tril()
        mask = (km > 0)[:, None, None, :] & tril
        sdpa_f, sdpa_b = sdpa_times(q, k, v, dout, mask)
        causal_f, causal_b = sdpa_times(q, k, v, dout, None)
        del mask
        fast = dtype == torch.bfloat16
        for name, (kern, plain) in runs.items():
            ms = time_ms(lambda: kern(kw0), warmup=2, iters=10 if fast else 3)
            ms_drop = time_ms(lambda: kern(kwd), warmup=1,
                              iters=10 if fast else 3)
            plain_ms = time_ms(plain, warmup=1, iters=2)
            nbytes, flops = flash_work(name, km, h=sh["h"], t=sh["t"],
                                       dh=sh["dh"], dtype=dtype)
            bound_ms, bound_by = bound(nbytes, flops, dtype)
            lib_ms = sdpa_f if name == "flash_attention_fwd" else sdpa_b
            log(f"  {name:19s} {str(dtype):15s} kernel {ms:.4f} ms (dropout"
                f" 0.1: {ms_drop:.4f})  plain {plain_ms:.4f} ms  SDPA"
                f" {lib_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by}:"
                f" {nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP)"
                f"  kernel/bound {ms / bound_ms:.1f}x")
            rows[(name, dtype)] = dict(ms=ms, ms_dropout=ms_drop,
                                       plain_ms=plain_ms, bound_ms=bound_ms,
                                       bound_by=bound_by, library_ms=lib_ms)
        rows[("flash_attention_bwd", dtype)]["library_covers"] = (
            "dq, dk and dv: SDPA's whole backward")
        pairs, causal_pairs = visible_pairs(km, t), sh["b"] * t * (t + 1) / 2
        bwd_ms = rows[("flash_attention_bwd", dtype)]["ms"]
        fwd_ms = rows[("flash_attention_fwd", dtype)]["ms"]
        log(f"  visible (query, key) pairs: {pairs:.0f} of the"
            f" {causal_pairs:.0f} causal ones ({pairs / causal_pairs:.4f});"
            f" key tiles the forward and the backward visit:"
            f" {visited_tile_share(km, t):.4f} of the causal tile pairs;"
            f" forward {fwd_ms:.4f} ms against SDPA's forward {sdpa_f:.4f} ms"
            f" ({sdpa_f / fwd_ms:.2f}x), backward {bwd_ms:.4f} ms against"
            f" SDPA's backward {sdpa_b:.4f} ms ({sdpa_b / bwd_ms:.2f}x)")
        log(f"  SDPA ({str(dtype)[6:]}) with the key_mask & causal boolean"
            f" mask: forward {sdpa_f:.4f} ms, backward (dq, dk, dv together)"
            f" {sdpa_b:.4f} ms; with is_causal=True and no key mask (another"
            f" function on padded rows): forward {causal_f:.4f} ms, backward"
            f" {causal_b:.4f} ms")
        del q, k, v, dout, bwd, runs, out, lse
    return rows


def bert4rec_lc_train_key_mask() -> torch.Tensor:
    """(B, L+1) key mask (ids != 0) of one BERT4REC-LC train batch: the
    masked protocol puts the MASK id, a real key, at positions that fall on
    padding too, so every 64-key tile holds live keys."""
    cfg = preset("BERT4REC-LC")
    split = synthetic_split_vectorized(num_rows=cfg.batch_size,
                                       num_items=cfg.num_items,
                                       seqslen=cfg.seqslen, seed=19)
    features, _, _ = next(iter(BatchLoader(
        split, data_mode="masked", batch_size=cfg.batch_size,
        masklen=cfg.masklen, is_training=True).epoch(0)))
    return torch.as_tensor(features["seqs_i"] != 0, device="cuda").float()


def phase_flash_noncausal_timing():
    log("phase 4e, non-causal: flash kernels at the BERT4REC-LC shape (B=32,"
        " H=8, T=2048, dh=64, bf16, not causal) on the causal bf16 timing's"
        " left-padded key mask, and on a BERT4REC-LC train batch's key mask")
    sh, dtype = SASREC_LC_ATTN, torch.bfloat16
    t = sh["t"]
    q, k, v, km, dout = flash_inputs(sh["b"], sh["h"], t, t, sh["dh"], dtype,
                                     950)
    sd = torch.tensor(9501, dtype=torch.int64, device="cuda")
    kw0 = dict(causal=False)
    kwd = dict(causal=False, dropout_rate=0.1, seed=sd)
    rows = {}
    for mask_name, km in (("left_padded", km),
                          ("train_batch_mask", bert4rec_lc_train_key_mask())):
        out, lse = flash_attention_fwd(q, k, v, km, **kw0)
        bwd = (q, k, v, km, dout, lse, flash_delta(dout, out))
        runs = {
            "flash_attention_fwd": (
                lambda kw: flash_attention_fwd(q, k, v, km, **kw),
                lambda: flash_fwd_reference(q, k, v, km, **kw0)),
            "flash_attention_bwd": (
                lambda kw: flash_attention_bwd(*bwd, **kw),
                lambda: flash_bwd_reference(*bwd, **kw0))}
        mask = (km > 0)[:, None, None, :]
        sdpa_f, sdpa_b = sdpa_times(q, k, v, dout, mask)
        sdpa_fd, sdpa_bd = sdpa_times(q, k, v, dout, mask, dropout_p=0.1)
        for name, (kern, plain) in runs.items():
            ms = time_ms(lambda: kern(kw0), warmup=2, iters=10)
            ms_drop = time_ms(lambda: kern(kwd), warmup=1, iters=10)
            plain_ms = time_ms(plain, warmup=1, iters=2)
            nbytes, flops = flash_work(name, km, h=sh["h"], t=t, dh=sh["dh"],
                                       dtype=dtype, causal=False)
            bound_ms, bound_by = bound(nbytes, flops, dtype)
            fwd = name == "flash_attention_fwd"
            lib_ms, lib_drop = (sdpa_f, sdpa_fd) if fwd else (sdpa_b, sdpa_bd)
            log(f"  {mask_name:16s} {name:19s} kernel {ms:.4f} ms (dropout"
                f" 0.1: {ms_drop:.4f})  plain {plain_ms:.4f} ms  SDPA"
                f" {lib_ms:.4f} ms (dropout 0.1: {lib_drop:.4f})  bound"
                f" {bound_ms:.4f} ms ({bound_by}:"
                f" {nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP)"
                f"  kernel/bound {ms / bound_ms:.1f}x")
            rows.setdefault(name, {})[mask_name] = dict(
                ms=ms, ms_dropout_0_1=ms_drop, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
                library_ms_dropout_0_1=lib_drop)
        pairs = visible_pairs(km, t, causal=False)
        share = visited_tile_share(km, t, causal=False)
        log(f"  {mask_name}: visible (query, key) pairs {pairs:.0f} of"
            f" {sh['b'] * t * t} ({pairs / (sh['b'] * t * t):.4f}); key tiles"
            f" the kernels visit: {share:.4f} of the tile pairs; SDPA with"
            f" the key mask (B, 1, 1, T): forward {sdpa_f:.4f} ms, backward"
            f" (dq, dk, dv together) {sdpa_b:.4f} ms")
        del out, lse, bwd, runs, mask
    return rows


def streamed_work(name, *, b, tq, tk, h, dh, e, dtype, keys):
    """(bytes, flops, dtype of the operations) of one streamed kernel: each
    input read once, each output written once; the products over the
    ``keys`` (``mau_keys``) each query row needs; the intensity head's
    operations are fp32 whatever the compute dtype."""
    it = torch.tensor([], dtype=dtype).element_size()
    c, rows = h * dh, b * h * tq
    if name == "mau_stats":   # q, k, t, mask in; m, l, seq_units out
        return (it * (b * tq * c + 2 * b * tk * c) + 4 * b * tk
                + 4 * rows * (2 + dh), 2 * rows * keys * 2 * dh, dtype)
    if name == "mau_intensity":   # seq_units, iv, Wd, bd, w, scaling; lam
        return (4 * (rows * dh + b * tq + (dh + 1) * e * dh + 2 * e * dh + e
                     + rows * e),
                2 * rows * ((dh + 1) * e * dh + e * dh), torch.float32)
    # q, k, v, mask, one-hot, lam, m, l in; out
    return (it * (2 * b * tq * c + 2 * b * tk * c)
            + 4 * (b * tk + b * tk * e + rows * e + 2 * rows),
            2 * rows * keys * (2 * dh + e), dtype)


def phase_streamed_timing(title, sh, *, causal, seed, batch=None,
                          dtypes=(torch.bfloat16, torch.float32)):
    """Phase 4c: the three streamed forward kernels at shape ``sh`` (BiMAU
    with the diagonal reset, or ``causal`` MAU without), each dtype of
    ``dtypes``, on inputs from ``seed`` (``batch``: a preset's train batch
    gives the key mask, spans and marks); their bounds over ``mau_keys``
    at dropout 0."""
    log(title)
    rows = {}
    diag = not causal
    for dtype in dtypes:
        args = mau_inputs(**sh, dtype=dtype, gathered=False, seed=seed,
                          batch=batch)
        q, k, v, t, km, iv, oh, wd, bd, w, sc, _ = args
        kw = dict(causal=causal, num_heads=sh["h"])
        m, l, su = mau_stats(q, k, t, km, **kw)
        lam = mau_intensity(su, iv, wd, bd, w, sc)
        runs = {
            "mau_stats": (lambda: mau_stats(q, k, t, km, **kw),
                          lambda: stats_reference(q, k, t, km, **kw)),
            "mau_intensity": (
                lambda: mau_intensity(su, iv, wd, bd, w, sc),
                lambda: intensity_reference(su, iv, wd, bd, w, sc)),
            "mau_modulated_out": (
                lambda: mau_modulated_out(q, k, v, km, oh, lam, m, l,
                                          diag_reset=diag, **kw),
                lambda: output_reference(q, k, v, km, oh, lam, m, l,
                                         diag_reset=diag, **kw))}
        heads = [x.view(sh["b"], sh["tk"], sh["h"], sh["dh"]).transpose(1, 2)
                 for x in (q, k, v)]
        sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
            *heads, is_causal=causal))
        live, visited = tile_shares(km, causal)
        keys = mau_keys(km, causal, shared_blind=True)
        log(f"  key mask: {live:.4f} of the 64-key tiles hold a real key;"
            f" the live-tile rule of the bf16 stats and output kernels visits"
            f" {visited:.4f} of the (query tile, key tile) pairs, the others"
            f" every pair; keys a query row needs {keys:.2f} of {sh['tk']}"
            " (a row that sees none: every key, once per batch row)")
        sd = torch.tensor(seed * 10, dtype=torch.int64, device="cuda")
        drop_ms = time_ms(lambda: mau_modulated_out(
            q, k, v, km, oh, lam, m, l, diag_reset=diag, dropout_rate=0.1,
            dropout_seed=sd, **kw), warmup=2, iters=10)
        for name, (kern, plain) in runs.items():
            ms = time_ms(kern, warmup=2, iters=10)
            plain_ms = time_ms(plain, warmup=1, iters=3)
            nbytes, flops, op_dtype = streamed_work(name, **sh, dtype=dtype,
                                                    keys=keys)
            bound_ms, bound_by = bound(nbytes, flops, op_dtype)
            extra = {}
            if name == "mau_intensity":
                bound_ms, extra = intensity_bound(name, dtype, sh)
                bound_by = extra.pop("bound_by")
            share = (visited if name in ("mau_stats", "mau_modulated_out")
                     and dtype == torch.bfloat16 else 1.0)
            if name == "mau_stats":
                # one exp an entry of every (query tile, key tile) pair it
                # visits
                exps = share * sh["b"] * sh["h"] * 4096 * (
                    -(-sh["tq"] // 64)) * (-(-sh["tk"] // 64))
                extra = dict(special_floor_ms=special_floor_ms(exps))
                log(f"  {name:17s} {str(dtype):15s} exp floor"
                    f" {extra['special_floor_ms']:.4f} ms ({exps / 1e6:.1f} M"
                    f" exps, one special-function op each, over the"
                    f" {share:.4f} of the tile pairs it visits)")
            log(f"  {name:17s} {str(dtype):15s} kernel {ms:.4f} ms  plain"
                f" {plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by}:"
                f" {nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP"
                f" {str(op_dtype)[6:]})  kernel/bound {ms / bound_ms:.1f}x;"
                f" tile pairs visited {share:.4f}")
            rows[(name, dtype)] = dict(ms=ms, plain_ms=plain_ms,
                                       bound_ms=bound_ms, bound_by=bound_by,
                                       library_ms=None, sdpa_ms=sdpa_ms,
                                       live_key_tile_share=live,
                                       visited_tile_share=share, **extra)
            if name == "mau_modulated_out":
                rows[(name, dtype)]["ms_dropout_0_1"] = drop_ms
                log(f"  {name:17s} {str(dtype):15s} kernel {drop_ms:.4f} ms"
                    " at dropout 0.1 (the train launches' rate)")
        log(f"  for scale, F.scaled_dot_product_attention on the same q/k/v"
            f" ({str(dtype)[6:]}{', causal' if causal else ''}):"
            f" {sdpa_ms:.4f} ms")
    return rows


def tile_shares(km, causal=False):
    """(share of the 64-key tiles that hold a real key, share of the (query
    tile, key tile) pairs that ``streamed_visited_tiles`` visits)."""
    live = flash_live_tiles(km) > 0
    return (float(live.float().mean()),
            float(streamed_visited_tiles(km, km.shape[1], causal).float()
                  .mean()))


def streamed_bwd_work(name, *, b, tq, tk, h, dh, e, dtype, keys):
    """(bytes, flops, dtype of the operations) of one streamed backward
    kernel: each input read once, each output written once; the products
    its function needs, over the ``keys`` (``mau_keys``) each query row
    needs (the intensity VJP's three of rows x (dh+1) x E*dh in fp32
    whatever the compute dtype)."""
    it = torch.tensor([], dtype=dtype).element_size()
    c, rows = h * dh, b * h * tq
    small = 4 * (b * tk + b * tk * e)              # key mask, one-hot
    if name == "mau_glam":   # q, dO, k, v, stats in; g_lam out
        return (it * (2 * b * tq * c + 2 * b * tk * c) + small
                + 4 * rows * (2 + e), 2 * rows * keys * (2 * dh + e), dtype)
    if name == "mau_intensity_bwd":   # seq_units, iv, weights, g_lam in
        return (4 * (2 * rows * dh + b * tq + 2 * (dh + 1) * e * dh
                     + 4 * e * dh + 2 * e + rows * e),
                2 * rows * (3 * (dh + 1) * e * dh + 2 * e * dh),
                torch.float32)
    # q, dO, g_su, k, v, t, lam, stats, rho in; dq or dk, dv, dt out
    nout = b * tq * c if name == "mau_dq" else 3 * b * tk * c
    nprod = 4 if name == "mau_dq" else 6
    return (it * (3 * b * tq * c + 3 * b * tk * c + nout) + small
            + 4 * rows * (e + 3), 2 * rows * keys * (nprod * dh + e), dtype)


def intensity_bounds(name, *, b, tq, h, dh, e, **_):
    """(fp32 CUDA-core bound, split-bf16 tensor-core bound) in ms of the
    intensity head (``mau_intensity``: one product of rows x (dh+1) x E*dh)
    or its VJP (``mau_intensity_bwd``: three): its work on the CUDA cores at
    67 TFLOP/s; and its products, three bf16 passes each (the hi/lo split
    the kernels run), at the tensor cores' 989 TFLOP/s (each the larger of
    that and its bytes)."""
    fwd = name == "mau_intensity"
    nbytes, flops, _ = (streamed_work if fwd else streamed_bwd_work)(
        name, b=b, tq=tq, tk=tq, h=h, dh=dh, e=e, dtype=torch.float32, keys=0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    products = (1 if fwd else 3) * 2 * b * h * tq * (dh + 1) * e * dh
    return (bound(nbytes, flops, torch.float32)[0],
            max(t_bytes, 3 * products / PEAK_FLOPS[torch.bfloat16] * 1e3))


def intensity_bound(name, dtype, sh):
    """The intensity head's or its VJP's bound at shape ``sh``, the lower
    of its split-bf16 and fp32 bounds (its products run on the tensor cores
    in three bf16 passes), and the row entries that say so, with its sigmoid
    floor at one and at two special-function ops a sigmoid (the kernels
    keep the exact form, ex2 and a reciprocal: two); logged."""
    fp32_ms, tc_ms = intensity_bounds(name, **sh)
    sigmoids = sh["b"] * sh["h"] * sh["tq"] * sh["e"] * sh["dh"]
    one, two = special_floor_ms(sigmoids), special_floor_ms(2 * sigmoids)
    log(f"  {name:17s} {str(dtype):15s} bound in split bf16 on the tensor"
        f" cores {tc_ms:.4f} ms ({1 if name == 'mau_intensity' else 3}"
        f" product(s) x 3 passes at 989 TFLOP/s); in fp32 on the CUDA cores"
        f" (67 TFLOP/s) the same work takes at least {fp32_ms:.4f} ms; the"
        f" bound is the lower, {min(fp32_ms, tc_ms):.4f} ms. Sigmoid floor"
        f" ({sigmoids / 1e6:.1f} M): {one:.4f} ms at one special-function op"
        f" a sigmoid, {two:.4f} ms at two (ex2 and a reciprocal, the exact"
        " form the kernel runs)")
    return min(fp32_ms, tc_ms), dict(
        bound_by="operations", bound_fp32_ms=fp32_ms,
        bound_split_bf16_ms=tc_ms, special_floor_ms=two,
        special_floor_one_op_ms=one)


def phase_streamed_bwd_timing(title, sh, *, causal, seed, batch=None,
                              dtypes=(torch.bfloat16, torch.float32)):
    """Phase 4d: the four streamed backward kernels at shape ``sh`` and
    dropout 0.1, as ``phase_streamed_timing`` takes its arguments; glam's
    and dkvt's bounds over every key of a row that sees none (the per-pair
    dropout mask), dq's over the visible keys alone."""
    log(title)
    rows = {}
    for dtype in dtypes:
        args = mau_inputs(**sh, dtype=dtype, gathered=False, seed=seed,
                          batch=batch)
        _, _, runs = streamed_bwd_pieces(args, sh["h"], causal=causal,
                                         diag=not causal, rate=0.1,
                                         seed=seed * 10, plain_fwd=None)
        live, visited = tile_shares(args[4], causal)
        dq_visited = float(streamed_visited_tiles(
            args[4], sh["tq"], causal, visible_only=True).float().mean())
        log(f"  key mask: {live:.4f} of the 64-key tiles hold a real key;"
            f" the live-tile rule (bf16 glam, dkvt) visits {visited:.4f} of"
            f" the (query tile, key tile) pairs, its visible-only form (bf16"
            f" dq) {dq_visited:.4f}, the others every pair")
        for name, (kern, plain) in runs.items():
            ms = time_ms(kern, warmup=1, iters=5)
            plain_ms = time_ms(plain, warmup=1, iters=2)
            # dq's terms are 0 where an entry is not visible: it needs the
            # visible keys alone, even in a row that sees none
            keys = mau_keys(args[4], causal, visible_only=name == "mau_dq")
            nbytes, flops, op_dtype = streamed_bwd_work(
                name, **sh, dtype=dtype, keys=keys)
            bound_ms, bound_by = bound(nbytes, flops, op_dtype)
            extra = {}
            if name == "mau_intensity_bwd":
                bound_ms, extra = intensity_bound(name, dtype, sh)
                bound_by = extra.pop("bound_by")
            # one special-function op an exp (each pair of the attention side
            # it needs); the intensity VJP's sigmoids at one op each
            sh_rows = sh["b"] * sh["h"] * sh["tq"]
            special = (sh_rows * sh["e"] * sh["dh"]
                       if name == "mau_intensity_bwd" else sh_rows * keys)
            floor_ms = special_floor_ms(special)
            share = ({"mau_glam": visited, "mau_dkvt": visited,
                      "mau_dq": dq_visited}.get(name, 1.0)
                     if dtype == torch.bfloat16 else 1.0)
            log(f"  {name:17s} {str(dtype):15s} kernel {ms:.4f} ms  plain"
                f" {plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by}:"
                f" {nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP"
                f" {str(op_dtype)[6:]})  kernel/bound {ms / bound_ms:.1f}x;"
                f" special-function floor {floor_ms:.4f} ms"
                f" ({special / 1e6:.1f} M ops); tile pairs visited"
                f" {share:.4f}")
            rows[(name, dtype)] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None,
                special_floor_ms=floor_ms, live_key_tile_share=live,
                visited_tile_share=share,
                **{k: v for k, v in extra.items()
                   if k != "special_floor_ms"})
        del runs
    return rows


def special_ops_per_s() -> float:
    """The card's special-function rate (exp2, tanh, reciprocal...): 16
    results a clock per SM (the CUDA programming guide's throughput table,
    compute capability 9.0) x SMs x the maximum SM clock nvidia-smi reads."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True,
        timeout=60).stdout.split()[0])
    return 16 * torch.cuda.get_device_properties(0).multi_processor_count \
        * mhz * 1e6


def special_floor_ms(ops: float) -> float:
    """The least time ``ops`` special-function results take on the card,
    one op each; beside a bound, which counts only bytes and products."""
    return ops / special_ops_per_s() * 1e3


def kernel_split(run, iters=5):
    """{CUDA kernel: device ms a call of ``run``} by ``torch.profiler`` over
    ``iters`` calls; PyTorch's own kernels are left out."""
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"namespace\)::(\w+(<[^()]*>)?)\(", e.key)
        if e.device_type == torch.autograd.DeviceType.CUDA and m:
            out[m.group(1)] = e.self_device_time_total / iters / 1e3
    return out


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def mau_bwd_work(*, b, tq, tk, h, dh, e, dtype, keys):
    """(bytes, flops) of the backward: q, k, v, t, g_out in and dq..dt out
    in the compute dtype; the small inputs, raw, g_lam and the weight
    gradients in fp32; z recomputed once, dx and dWd, and the attention
    products (probs recomputed, dmod, dv, dint @ onehot, su, dprobs, dt,
    dq, dk) over the ``keys`` (``mau_keys``) each query row needs."""
    it = torch.tensor([], dtype=dtype).element_size()
    c, rows = h * dh, b * h * tq
    nbytes = (it * 2 * (2 * b * tq * c + 3 * b * tk * c)      # in + out
              + 4 * (b * tk + 2 * b * tq + b * tk * e)      # mask iv qpos oh
              + 4 * 2 * rows * e                            # raw, g_lam
              + 4 * 2 * ((dh + 1) * e * dh + 2 * e * dh + e))  # weights, grads
    flops = 2 * rows * (3 * (dh + 1) * e * dh + e * dh
                        + 8 * keys * dh + 2 * keys * e)
    return nbytes, flops


def catalog_work(*, n, v, c, dtype, backward, live=None):
    """(bytes, flops). The backward's work is over the ``live`` rows (dlse
    or dll nonzero; all n by default): it reads their hidden rows and forms
    their score, dh and dT products; g is exactly 0 on the other rows, whose
    dh it writes as zeros."""
    it = torch.tensor([], dtype=dtype).element_size()
    if backward:   # h, T, b, labels, lse, dlse, dll in; dh, dT, db out
        live = n if live is None else live
        return (it * (live * c + n * c + 2 * v * c) + 8 * v + 16 * n,
                3 * 2 * live * v * c)
    return it * (n * c + v * c) + 4 * v + 12 * n, 2 * n * v * c


def phase_train_kernel_timing():
    log("phase 4b: timing of the training kernels at the flagship train "
        "shape (MAU: B=512, T=31, H=8, dh=64, E=64, dropout 0.1; catalog: "
        "N=3072, V=17,772, C=512)")
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        args = mau_inputs(**FLAGSHIP, dtype=dtype, gathered=False, seed=200)
        kw = dict(causal=False, diag=True, h=8, rate=0.1, seed=5)
        sd = _seed_tensor(5, 0.1, torch.device("cuda"))
        (q, k, v, t, km, iv, oh, wd, bd, w, sc, qpos) = args
        ms_fwd_train = time_ms(lambda: _launch_fwd(
            q, k, v, t, km, iv, oh, wd, bd, w, sc, False, True, 8, qpos, sd,
            0.1, want_raw=True))
        _, _, raw = _launch_fwd(q, k, v, t, km, iv, oh, wd, bd, w, sc, False,
                                True, 8, qpos, sd, 0.1, want_raw=True)
        go, gl = mau_bwd_args(args, dtype, 7)
        ms = time_ms(lambda: mau_attention_bwd(
            q, k, v, t, km, iv, oh, wd, bd, w, sc, raw, go, gl, causal=False,
            diag_reset=True, dropout_rate=0.1, dropout_seed=sd, num_heads=8,
            qpos=qpos), iters=5)
        plain_ms = time_ms(lambda: run_mau_bwd(args, plain=True, **kw),
                           warmup=1, iters=1)
        nbytes, flops = mau_bwd_work(**FLAGSHIP, dtype=dtype,
                                     keys=mau_keys(km))
        bound_ms, bound_by = bound(nbytes, flops, dtype)
        sig = FLAGSHIP["b"] * FLAGSHIP["h"] * FLAGSHIP["tq"] * \
            FLAGSHIP["e"] * FLAGSHIP["dh"]
        floor_ms = special_floor_ms(sig)
        split = kernel_split(lambda: mau_attention_bwd(
            q, k, v, t, km, iv, oh, wd, bd, w, sc, raw, go, gl, causal=False,
            diag_reset=True, dropout_rate=0.1, dropout_seed=sd, num_heads=8,
            qpos=qpos))
        log(f"  mau_attention_bwd {str(dtype):15s} kernel {ms:.4f} ms"
            f" (forward with dropout + residual {ms_fwd_train:.4f} ms)"
            f"  plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by}:"
            f" {nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP)"
            f"  kernel/bound {ms / bound_ms:.1f}x; special-function floor"
            f" {floor_ms:.4f} ms ({sig / 1e6:.1f} M sigmoids, one op each)")
        log("    by kernel: " + ", ".join(f"{n} {t:.4f} ms"
                                          for n, t in split.items()))
        rows[("mau_attention_bwd", dtype)] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, fwd_train_ms=ms_fwd_train,
            special_floor_ms=floor_ms, by_kernel=split)
        h, tb, b, lab, dlse, dll = catalog_inputs(**CATALOG, dtype=dtype,
                                                  seed=300)
        lse, _ = catalog_nll_fwd(h, tb, b, lab)
        gemm_ms = time_ms(lambda: h @ tb.t())
        for name, kern, plain, backward in (
                ("catalog_nll_fwd",
                 lambda: catalog_nll_fwd(h, tb, b, lab),
                 lambda: catalog_nll_reference(h, tb, b, lab), False),
                ("catalog_nll_bwd",
                 lambda: catalog_nll_bwd(h, tb, b, lab, lse, dlse, dll),
                 lambda: catalog_nll_bwd_reference(h, tb, b, lab, lse, dlse,
                                                   dll), True)):
            ms = time_ms(kern, iters=10)
            plain_ms = time_ms(plain, warmup=1, iters=3)
            nbytes, flops = catalog_work(**CATALOG, dtype=dtype,
                                         backward=backward)
            bound_ms, bound_by = bound(nbytes, flops, dtype)
            log(f"  {name:17s} {str(dtype):15s} kernel {ms:.4f} ms  plain"
                f" {plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by}:"
                f" {nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP)"
                f"  kernel/bound {ms / bound_ms:.1f}x; for scale, one"
                f" cuBLAS h @ T^T: {gemm_ms:.4f} ms")
            rows[(name, dtype)] = dict(ms=ms, plain_ms=plain_ms,
                                       bound_ms=bound_ms, bound_by=bound_by,
                                       library_ms=None, gemm_ms=gemm_ms)
    return rows


def sdpa_backend(q, k, v, mask) -> str:
    """The backend ``F.scaled_dot_product_attention`` picks for these
    inputs: the first, in PyTorch's priority order, that takes them alone
    (each backend refuses what it cannot run)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    known = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH]
    order = known
    if hasattr(torch._C, "_get_sdp_priority_order"):
        by_value = {int(b.value): b for b in known}
        order = [by_value[int(i)] for i in torch._C._get_sdp_priority_order()
                 if int(i) in by_value]
    for backend in order:
        try:
            with sdpa_kernel([backend]):
                F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
            return backend.name
        except RuntimeError:
            continue
    return "none"


# the Bochner models' flash calls at L = 2048 (B = 8, H = 1): (tag, q and
# k width, v width, dtype, the un-augmented head the scale is 1/sqrt of)
WIDE_TIMING = (("tgat", 2048, 512, torch.bfloat16, 512),
               ("tgrec", 150, 150, torch.float32, 50))


def phase_wide_flash_timing():
    log("phase 4g: the wide flash kernels at the Bochner models' heads "
        "(B=8, T=2048, H=1, causal, left-padded key mask): TGAT's q and k "
        "2,048 wide with v 512 (bf16), TGREC's 150 (fp32)")
    rows = {}
    for tag, d, dv, dtype, dh in WIDE_TIMING:
        t = 2048
        q, k, v, km, dout = flash_inputs(8, 1, t, t, d, dtype, 960, dv=dv,
                                         qk_std=0.3)
        check(not narrow_kernels(_FWD, q, v), f"{tag}: not the wide kernels")
        sd = torch.tensor(9600, dtype=torch.int64, device="cuda")
        kw0 = dict(causal=True, scale=dh ** -0.5)
        kwd = dict(kw0, dropout_rate=0.1, seed=sd)
        out, lse = flash_attention_fwd(q, k, v, km, **kw0)
        bwd = (q, k, v, km, dout, lse, flash_delta(dout, out))
        runs = {
            "flash_attention_fwd": (
                lambda kw: flash_attention_fwd(q, k, v, km, **kw),
                lambda: flash_fwd_reference(q, k, v, km, **kw0)),
            "flash_attention_bwd": (
                lambda kw: flash_attention_bwd(*bwd, **kw),
                lambda: flash_bwd_reference(*bwd, **kw0))}
        tril = torch.ones((t, t), dtype=torch.bool, device="cuda").tril()
        mask = (km > 0)[:, None, None, :] & tril
        # SDPA scales by 1/sqrt(d): q carries the ratio to 1/sqrt(dh)
        qs = (q.float() * (d / dh) ** 0.5).to(dtype)
        backend = sdpa_backend(qs, k, v, mask)
        sdpa_f, sdpa_b = sdpa_times(qs, k, v, dout, mask)
        del mask
        for name, (kern, plain) in runs.items():
            ms = time_ms(lambda: kern(kw0), warmup=1, iters=5)
            ms_drop = time_ms(lambda: kern(kwd), warmup=1, iters=3)
            plain_ms = time_ms(plain, warmup=1, iters=2)
            nbytes, flops = flash_work(name, km, h=1, t=t, dh=d, dv=dv,
                                       dtype=dtype)
            bound_ms, bound_by = bound(nbytes, flops, dtype)
            lib_ms = sdpa_f if name == "flash_attention_fwd" else sdpa_b
            log(f"  {tag} {name:19s} {str(dtype):15s} kernel {ms:.4f} ms"
                f" (dropout 0.1: {ms_drop:.4f})  plain {plain_ms:.4f} ms"
                f"  SDPA ({backend}) {lib_ms:.4f} ms  bound"
                f" {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB,"
                f" {flops / 1e9:.1f} GFLOP)  kernel/bound"
                f" {ms / bound_ms:.1f}x")
            rows[(tag, name)] = dict(
                ms=ms, ms_dropout_0_1=ms_drop, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
                library_backend=backend, width=d, v_width=dv,
                dtype=str(dtype)[6:])
        del q, k, v, dout, bwd, runs, out, lse, qs
    return rows


def phase_catalog_lc_timing():
    log("phase 4f: catalog_nll forward and backward at the SASREC-LC train"
        " shape (N=B*L=65,536, V=17,771, C=512, bf16): the forward on every"
        " row; the backward with every row live, and with the padded rows of"
        " a SASREC-LC batch (dlse = dll = 0) skipped; then both at the"
        " BERT4REC-LC train shape (N=8,192, V=17,773)")
    rows = {}
    h, tb, b, lab, _, _ = catalog_inputs(**SASREC_LC_CATALOG,
                                         dtype=torch.bfloat16, seed=310)
    ms = time_ms(lambda: catalog_nll_fwd(h, tb, b, lab), warmup=2, iters=10)
    plain_ms = time_ms(lambda: catalog_nll_reference(h, tb, b, lab),
                       warmup=1, iters=1)
    gemm_ms = time_ms(lambda: h @ tb.t(), warmup=1, iters=5)
    nbytes, flops = catalog_work(**SASREC_LC_CATALOG, dtype=torch.bfloat16,
                                 backward=False)
    bound_ms, bound_by = bound(nbytes, flops, torch.bfloat16)
    log(f"  catalog_nll_fwd every row      kernel {ms:.4f} ms  plain"
        f" {plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by}:"
        f" {nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP)  kernel/bound"
        f" {ms / bound_ms:.1f}x, {flops / ms / 1e9:.1f} TFLOP/s; for scale,"
        f" one cuBLAS h @ T^T: {gemm_ms:.4f} ms")
    rows["forward"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, gemm_ms=gemm_ms)
    del h, tb, b, lab
    padded = sasrec_lc_padded_rows()
    for label, dead in (("all_live", None), ("sasrec_lc_padded", padded)):
        h, tb, b, lab, dlse, dll = catalog_inputs(
            **SASREC_LC_CATALOG, dtype=torch.bfloat16, seed=310, dead=dead)
        lse, _ = catalog_nll_fwd(h, tb, b, lab)
        n, v, c = (SASREC_LC_CATALOG[k] for k in "nvc")
        live_rows = int(((dlse != 0) | (dll != 0)).sum())
        tile_rows = int(catalog_live_rows(dlse, dll).sum()) * 64
        ms = time_ms(lambda: catalog_nll_bwd(h, tb, b, lab, lse, dlse, dll),
                     warmup=2, iters=10)
        plain_ms = time_ms(lambda: catalog_nll_bwd_reference(
            h, tb, b, lab, lse, dlse, dll), warmup=1, iters=1)
        nbytes, flops = catalog_work(**SASREC_LC_CATALOG, live=live_rows,
                                     dtype=torch.bfloat16, backward=True)
        bound_ms, bound_by = bound(nbytes, flops, torch.bfloat16)
        log(f"  catalog_nll_bwd {label:16s} kernel {ms:.4f} ms  plain"
            f" {plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by}:"
            f" {nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP over the"
            f" {live_rows} live rows, {live_rows / n:.4f} of N; the live"
            f" 64-row tiles the kernels visit hold {tile_rows / n:.4f} of N)"
            f"  kernel/bound {ms / bound_ms:.1f}x,"
            f" {4 * 2 * tile_rows * v * c / ms / 1e9:.1f} TFLOP/s of"
            f" the four products over the live tiles")
        rows[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, live_share=live_rows / n,
                           live_tile_share=tile_rows / n)
        del h, tb, b, lab, dlse, dll, lse
    rows.update(catalog_bert4rec_lc_timing())
    return rows


def catalog_bert4rec_lc_timing():
    """The catalog forward and backward at the BERT4REC-LC train shape
    (N = B * masklen = 8,192, V = 17,773, C = 512, bf16), the backward with
    the rows whose masked position fell on padding dead."""
    sh, bf16 = BERT4REC_LC_CATALOG, torch.bfloat16
    h, tb, b, lab, dlse, dll = catalog_inputs(
        **sh, dtype=bf16, seed=311, dead=bert4rec_lc_masked_rows())
    live_rows = int(((dlse != 0) | (dll != 0)).sum())
    lse, _ = catalog_nll_fwd(h, tb, b, lab)
    rows = {}
    for label, kern, plain, work in (
            ("bert4rec_lc_forward", lambda: catalog_nll_fwd(h, tb, b, lab),
             lambda: catalog_nll_reference(h, tb, b, lab),
             dict(backward=False)),
            ("bert4rec_lc_masked",
             lambda: catalog_nll_bwd(h, tb, b, lab, lse, dlse, dll),
             lambda: catalog_nll_bwd_reference(h, tb, b, lab, lse, dlse,
                                               dll),
             dict(backward=True, live=live_rows))):
        ms = time_ms(kern, warmup=2, iters=10)
        plain_ms = time_ms(plain, warmup=1, iters=2)
        nbytes, flops = catalog_work(**sh, dtype=bf16, **work)
        bound_ms, bound_by = bound(nbytes, flops, bf16)
        log(f"  BERT4REC-LC {label:20s} kernel {ms:.4f} ms  plain"
            f" {plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by}:"
            f" {nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP; {live_rows}"
            f" live rows of {sh['n']})  kernel/bound {ms / bound_ms:.1f}x")
        rows[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by)
    return rows


def phase_ctsma_kernel_timing():
    log("phase 4 / 4b (CTSMA): mau_attention forward and backward at the"
        " CTSMA train shape (B=512, T=30, H=4, dh=128, E=64, causal, no"
        " diagonal reset, bf16; a CTSMA batch's key mask and spans; dropout"
        " 0.2 in training)")
    sh, bf16 = CTSMA_TRAIN, torch.bfloat16
    args = mau_inputs(**sh, dtype=bf16, gathered=False, seed=210,
                      batch="CTSMA")
    q, k, v, t, km, iv, oh, wd, bd, w, sc, qpos = args
    h = sh["h"]
    keys = mau_keys(km, causal=True, shared_blind=True)
    sd = _seed_tensor(9, 0.2, torch.device("cuda"))
    rows = {}

    def fwd():
        mau_attention(q, k, v, t, km, iv, oh, wd, bd, w, sc, True, False,
                      num_heads=h)

    def fwd_train():
        return _launch_fwd(q, k, v, t, km, iv, oh, wd, bd, w, sc, True,
                           False, h, qpos, sd, 0.2, want_raw=True)

    ms, train_ms = time_ms(fwd), time_ms(fwd_train)
    plain_ms = time_ms(lambda: mau_attention_reference(
        q, k, v, t, km, iv, oh, wd, bd, w, sc, causal=True, diag_reset=False,
        num_heads=h), warmup=1, iters=3)
    nbytes, flops = mau_work(**sh, dtype=bf16, keys=keys)
    bound_ms, bound_by = bound(nbytes, flops, bf16)
    sigmoids = sh["b"] * h * sh["tq"] * sh["e"] * sh["dh"]
    floor_ms = special_floor_ms(2 * sigmoids)
    split = kernel_split(fwd)
    log(f"  mau_attention_fwd kernel {ms:.4f} ms (training forward, dropout"
        f" 0.2 + residual: {train_ms:.4f} ms)  plain {plain_ms:.4f} ms"
        f"  bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB,"
        f" {flops / 1e9:.1f} GFLOP over {keys:.2f} keys a query row)"
        f"  kernel/bound {ms / bound_ms:.1f}x; sigmoid floor at two ops"
        f" {floor_ms:.4f} ms ({sigmoids / 1e6:.1f} M)")
    log("    by kernel: " + ", ".join(f"{n} {x:.4f} ms"
                                      for n, x in split.items()))
    rows["mau_attention_fwd"] = dict(
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        ms_dropout_0_2=train_ms, by_kernel=split)
    _, _, raw = fwd_train()
    go, gl = mau_bwd_args(args, bf16, 7)

    def bwd():
        mau_attention_bwd(q, k, v, t, km, iv, oh, wd, bd, w, sc, raw, go, gl,
                          causal=True, diag_reset=False, dropout_rate=0.2,
                          dropout_seed=sd, num_heads=h)

    ms = time_ms(bwd, iters=5)
    plain_ms = time_ms(lambda: run_mau_bwd(
        args, causal=True, diag=False, h=h, rate=0.2, seed=9, plain=True),
        warmup=1, iters=1)
    # the per-pair dropout mask: every key of a row that sees none
    keys = mau_keys(km, causal=True)
    nbytes, flops = mau_bwd_work(**sh, dtype=bf16, keys=keys)
    bound_ms, bound_by = bound(nbytes, flops, bf16)
    split = kernel_split(bwd)
    log(f"  mau_attention_bwd kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
        f"  bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB,"
        f" {flops / 1e9:.1f} GFLOP)  kernel/bound {ms / bound_ms:.1f}x;"
        f" special-function floor {special_floor_ms(sigmoids):.4f} ms"
        f" ({sigmoids / 1e6:.1f} M sigmoids, one op each)")
    log("    by kernel: " + ", ".join(f"{n} {x:.4f} ms"
                                      for n, x in split.items()))
    # the tensor-core path: kPre, the wgmma intensity head, kPost; neither
    # kFull (mode 0) nor mau_bwd_weights
    check(any(n.startswith("mau_bwd_int_tc<128") for n in split)
          and {m for n in split for m in re.findall(
              r"^mau_bwd_attn<.*, (\d)>$", n)} == {"1", "2"}
          and not any("mau_bwd_weights" in n for n in split),
          f"CTSMA backward: not the tensor-core path ({', '.join(split)})")
    rows["mau_attention_bwd"] = dict(ms=ms, plain_ms=plain_ms,
                                     bound_ms=bound_ms, bound_by=bound_by,
                                     by_kernel=split)
    return rows


# ---------------------------------------------------------------- slice


def phase_slice():
    log("phase 5: EasyDGL eval + serving at full width on the card")
    cfg = preset("EasyDGL", num_events=64, compute_dtype="bfloat16")
    bs = cfg.batch_size
    params = random_flax_params(cfg, seed=0)
    model = build_model(cfg, device="cuda", params=params)
    table = synthetic_mark_table(cfg.num_items, cfg.num_events, seed=0)
    split = synthetic_split_vectorized(num_rows=4 * bs,
                                       num_items=cfg.num_items,
                                       seqslen=cfg.seqslen, seed=0)
    loader = BatchLoader(split, data_mode=model.data_mode, batch_size=bs,
                         masklen=cfg.masklen, is_training=False)
    batches = list(loader.epoch(0))
    requests = synthetic_split_vectorized(num_rows=3 * bs,
                                          num_items=cfg.num_items,
                                          seqslen=cfg.seqslen, seed=1)
    req_batches = [{k: v[i * bs:(i + 1) * bs]
                    for k, v in requests.arrays.items()} for i in range(3)]
    step = build_eval_step(model, mark_table=table)
    rec = Recommender(cfg, model, table)

    # warm-up (cuBLAS handles, allocator), not counted
    MetricAccumulator().update(step(model, *batches[0]))
    rec.recommend(req_batches[0], k=50)
    torch.cuda.synchronize()

    mau_attention.launches = 0
    acc = MetricAccumulator()
    t0 = time.perf_counter()
    for features, labels, valid in batches:
        acc.update(step(model, features, labels, valid))
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_launches = mau_attention.launches
    latencies, answers = [], []
    for arrays in req_batches:
        before = mau_attention.launches
        t0 = time.perf_counter()
        ids, scores = rec.recommend(arrays, k=50)
        latencies.append(time.perf_counter() - t0)
        check(mau_attention.launches - before == cfg.num_blocks,
              "recommend: kernel launches per forward != num_blocks")
        answers.append((arrays, ids, scores))
    launches = mau_attention.launches

    check(eval_launches == len(batches) * cfg.num_blocks,
          f"eval: {eval_launches} launches for {len(batches)} forwards")
    metrics = acc.result()
    log(f"  eval over {int(acc.count)} rows: " + json.dumps(metrics))
    for key, val in metrics.items():
        check(math.isfinite(val) and 0.0 <= val <= 1.0, f"metric {key}={val}")
    for arrays, ids, scores in answers:
        check(ids.shape == (bs, 50) and scores.shape == (bs, 50),
              "recommend shapes")
        check(bool(np.isfinite(scores).all()), "recommend: scores not finite")
        check(bool((scores[:, :-1] >= scores[:, 1:]).all()),
              "recommend: scores not sorted descending")
        check(bool((ids != 0).all()), "recommend: padding id 0 returned")
        seen = rec.protocol(arrays, False, None)[0]["seqs_i"]
        check(not any(set(ids[r].tolist()) & set(seen[r].tolist())
                      for r in range(bs)), "recommend: a seen id returned")
    seqs_per_s = len(batches) * bs / eval_s
    log(f"  eval: {len(batches)} batches x {bs} rows in {eval_s:.4f} s ="
        f" {seqs_per_s:.1f} seqs/s (synchronised, mark lookup on device)")
    log(f"  recommend k=50, B={bs}: latency per batch "
        + ", ".join(f"{x * 1e3:.3f} ms" for x in latencies))
    log(f"  mau_attention launches on the served path: {launches} "
        f"({len(batches)} eval + {len(req_batches)} recommend forwards,"
        f" {cfg.num_blocks} block each)")
    return launches, batches[0], table


def phase_slice_cpu_vs_card(batch, table):
    log("phase 6: full-width fp32 model, card (kernel) vs CPU (plain), "
        "8 rows")
    cfg = preset("EasyDGL", num_events=64)
    params = random_flax_params(cfg, seed=0)
    features, _, _ = batch
    features = {k: v[:8] for k, v in features.items()}
    ids = features["seqs_i"]
    features["seqs_marks"] = table[np.where(ids >= table.shape[0], 0, ids)
                                   ].astype(np.float32)
    logits = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, device=dev, params=params)
        with torch.no_grad():
            out, _ = model(to_device(features, dev), is_training=False)
        logits[dev] = out.cpu()
    err = (logits["cuda"] - logits["cpu"]).abs()
    atol, rtol = SLICE_TOL
    ratio = float((err / (atol + rtol * logits["cpu"].abs())).max())
    log(f"  logits (8, {logits['cpu'].shape[1]}):"
        f" max_abs={float(err.max()):.3e}"
        f" tol(atol={atol:g}, rtol={rtol:g}) worst/tol={ratio:.3f}")
    check(ratio <= 1.0, "card vs CPU logits outside tolerance")


def phase_lc_slice():
    log("phase 5b: EasyDGL-LC eval + serving at full width on the card "
        "(B=8, L+1=2048, C=512, H=8, E=64, bf16, streamed kernels)")
    cfg = preset("EasyDGL-LC", num_events=64)
    bs = cfg.batch_size
    model = build_model(cfg, device="cuda",
                        params=random_flax_params(cfg, seed=0))
    table = synthetic_mark_table(cfg.num_items, cfg.num_events, seed=0)
    split = synthetic_split_vectorized(num_rows=4 * bs,
                                       num_items=cfg.num_items,
                                       seqslen=cfg.seqslen, seed=4)
    batches = list(BatchLoader(split, data_mode=model.data_mode,
                               batch_size=bs, masklen=cfg.masklen,
                               is_training=False).epoch(0))
    requests = synthetic_split_vectorized(num_rows=3 * bs,
                                          num_items=cfg.num_items,
                                          seqslen=cfg.seqslen, seed=5)
    req_batches = [{k: v[i * bs:(i + 1) * bs]
                    for k, v in requests.arrays.items()} for i in range(3)]
    step = build_eval_step(model, mark_table=table)
    rec = Recommender(cfg, model, table)
    MetricAccumulator().update(step(model, *batches[0]))  # warm-up
    rec.recommend(req_batches[0], k=50)
    torch.cuda.synchronize()

    counters = STREAMED + (mau_attention,)
    for fn in counters:
        fn.launches = 0
    acc = MetricAccumulator()
    t0 = time.perf_counter()
    for features, labels, valid in batches:
        acc.update(step(model, features, labels, valid))
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    latencies, answers = [], []
    for arrays in req_batches:
        t0 = time.perf_counter()
        ids, scores = rec.recommend(arrays, k=50)
        latencies.append(time.perf_counter() - t0)
        answers.append((arrays, ids, scores))
    launches = {fn.__name__: fn.launches for fn in counters}
    forwards = (len(batches) + len(req_batches)) * cfg.num_blocks
    for fn in STREAMED:
        check(launches[fn.__name__] == forwards,
              f"LC serving: {fn.__name__} launched {launches[fn.__name__]}"
              f" times for {forwards} forwards")
    check(launches["mau_attention"] == 0,
          "LC serving: the fused kernel was launched")
    metrics = acc.result()
    log(f"  eval over {int(acc.count)} rows: " + json.dumps(metrics))
    for key, val in metrics.items():
        check(math.isfinite(val) and 0.0 <= val <= 1.0, f"metric {key}={val}")
    for arrays, ids, scores in answers:
        check(ids.shape == (bs, 50) and scores.shape == (bs, 50),
              "LC recommend shapes")
        check(bool(np.isfinite(scores).all()), "LC recommend: not finite")
        check(bool((scores[:, :-1] >= scores[:, 1:]).all()),
              "LC recommend: scores not sorted descending")
        check(bool((ids != 0).all()), "LC recommend: padding id 0 returned")
        seen = rec.protocol(arrays, False, None)[0]["seqs_i"]
        check(not any(set(ids[r].tolist()) & set(seen[r].tolist())
                      for r in range(bs)), "LC recommend: a seen id returned")
    seqs_per_s = len(batches) * bs / eval_s
    log(f"  eval: {len(batches)} batches x {bs} rows in {eval_s:.4f} s ="
        f" {seqs_per_s:.1f} seqs/s (synchronised, mark lookup on device)")
    log(f"  recommend k=50, B={bs}: latency per batch "
        + ", ".join(f"{x * 1e3:.3f} ms" for x in latencies))
    log(f"  launches on the LC served path ({len(batches)} eval +"
        f" {len(req_batches)} recommend forwards): " + json.dumps(launches))
    return launches, batches[0], table, seqs_per_s, latencies


def phase_lc_cpu_vs_card(batch, table):
    log("phase 6b: full-width fp32 EasyDGL-LC, card (streamed kernels) vs "
        "CPU (blocked plain version), 2 rows")
    cfg = preset("EasyDGL-LC", num_events=64, compute_dtype="float32")
    params = random_flax_params(cfg, seed=0)
    features, _, _ = batch
    features = {k: v[:2] for k, v in features.items()}
    ids = features["seqs_i"]
    features["seqs_marks"] = table[np.where(ids >= table.shape[0], 0, ids)
                                   ].astype(np.float32)
    logits = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, device=dev, params=params)
        with torch.no_grad():
            out, _ = model(to_device(features, dev), is_training=False)
        logits[dev] = out.cpu()
        del model
    err = (logits["cuda"] - logits["cpu"]).abs()
    atol, rtol = SLICE_TOL
    ratio = float((err / (atol + rtol * logits["cpu"].abs())).max())
    log(f"  logits (2, {logits['cpu'].shape[1]}):"
        f" max_abs={float(err.max()):.3e}"
        f" tol(atol={atol:g}, rtol={rtol:g}) worst/tol={ratio:.3f}")
    check(ratio <= 1.0, "LC card vs CPU logits outside tolerance")


def phase_train():
    log("phase 7: EasyDGL faithful train steps at full width on the card "
        "(dropout 0.1 / 0.1, TPP + L2, TF-Adam, marks looked up on device)")
    cfg = preset("EasyDGL", num_events=64, compute_dtype="bfloat16")
    bs = cfg.batch_size
    model = build_model(cfg, device="cuda",
                        params=random_flax_params(cfg, seed=0))
    table = synthetic_mark_table(cfg.num_items, cfg.num_events, seed=0)
    split = synthetic_split_vectorized(num_rows=4 * bs,
                                       num_items=cfg.num_items,
                                       seqslen=cfg.seqslen, seed=2)
    loader = BatchLoader(split, data_mode=model.data_mode, batch_size=bs,
                         masklen=cfg.masklen, is_training=True)
    # on the device before the timed loop, as bench.py puts its batches: a
    # copy from pageable host memory would wait for the card every step
    batches = [(to_device(f, "cuda"), torch.as_tensor(lab, device="cuda"))
               for f, lab, _ in loader.epoch(0)]
    step = build_train_step(model, mark_table=table)
    state = init_state(model)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for features, labels in batches[:2]:  # warm-up, not counted
        state, _ = step(state, features, labels, gen)
    torch.cuda.synchronize()

    counters = (mau_attention, mau_attention_bwd, catalog_nll_fwd,
                catalog_nll_bwd)
    for fn in counters:
        fn.launches = 0
    losses = []
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        features, labels = batches[i % len(batches)]
        state, loss = step(state, features, labels, gen)
        losses.append(loss)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    repeated = []
    for _ in range(REPEAT_STEPS):
        state, loss = step(state, *batches[0], gen)
        repeated.append(loss)
    losses = [float(x) for x in losses]
    repeated = [float(x) for x in repeated]
    check(all(math.isfinite(x) for x in losses + repeated),
          "train: a loss is not finite")
    check(repeated[-1] < repeated[0],
          f"train: loss on a repeated batch did not fall ({repeated})")
    per_step = {"mau_attention": cfg.num_blocks,
                "mau_attention_bwd": cfg.num_blocks,
                "catalog_nll_fwd": 1, "catalog_nll_bwd": 1}
    for name, n in per_step.items():
        check(launches[name] == n * TRAIN_STEPS,
              f"train: {name} launched {launches[name]} times in "
              f"{TRAIN_STEPS} steps, expected {n} per step")
    ms_step = elapsed / TRAIN_STEPS * 1e3
    ex_s = TRAIN_STEPS * bs / elapsed
    log(f"  losses: first {losses[0]:.5f}, last {losses[-1]:.5f}; "
        f"repeated batch {repeated[0]:.5f} -> {repeated[-1]:.5f}")
    log(f"  train: {TRAIN_STEPS} steps x {bs} rows in {elapsed:.4f} s ="
        f" {ms_step:.4f} ms/step, {ex_s:.1f} train ex/s (host clock,"
        f" synchronised, batches on the device, after 2 warm-up steps)")
    log(f"  launches in the {TRAIN_STEPS} steps: " + json.dumps(launches))
    return launches, ms_step, ex_s


def phase_lc_train():
    log("phase 7b: EasyDGL-LC faithful train steps at full width on the card "
        "(B=8, L+1=2048, masklen 256, C=512, H=8, E=64, bf16, dropout "
        "0.1 / 0.1, TPP + L2, TF-Adam, streamed kernels)")
    cfg = preset("EasyDGL-LC", num_events=64)
    bs = cfg.batch_size
    model = build_model(cfg, device="cuda",
                        params=random_flax_params(cfg, seed=0))
    table = synthetic_mark_table(cfg.num_items, cfg.num_events, seed=0)
    split = synthetic_split_vectorized(num_rows=4 * bs,
                                       num_items=cfg.num_items,
                                       seqslen=cfg.seqslen, seed=6)
    loader = BatchLoader(split, data_mode=model.data_mode, batch_size=bs,
                         masklen=cfg.masklen, is_training=True)
    batches = [(to_device(f, "cuda"), torch.as_tensor(lab, device="cuda"))
               for f, lab, _ in loader.epoch(0)]
    step = build_train_step(model, mark_table=table)
    state = init_state(model)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for features, labels in batches[:2]:  # warm-up, not counted
        state, _ = step(state, features, labels, gen)
    torch.cuda.synchronize()

    counters = STREAMED_KERNELS + (mau_attention, mau_attention_bwd,
                                   catalog_nll_fwd, catalog_nll_bwd)
    for fn in counters:
        fn.launches = 0
    losses = []
    t0 = time.perf_counter()
    for i in range(LC_TRAIN_STEPS):
        features, labels = batches[i % len(batches)]
        state, loss = step(state, features, labels, gen)
        losses.append(loss)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    repeated = []
    for _ in range(LC_REPEAT_STEPS):
        state, loss = step(state, *batches[0], gen)
        repeated.append(loss)
    losses = [float(x) for x in losses]
    repeated = [float(x) for x in repeated]
    check(all(math.isfinite(x) for x in losses + repeated),
          "LC train: a loss is not finite")
    check(repeated[-1] < repeated[0],
          f"LC train: loss on a repeated batch did not fall ({repeated})")
    per_step = {fn.__name__: cfg.num_blocks for fn in STREAMED_KERNELS}
    per_step.update(mau_attention=0, mau_attention_bwd=0, catalog_nll_fwd=1,
                    catalog_nll_bwd=1)
    for name, n in per_step.items():
        check(launches[name] == n * LC_TRAIN_STEPS,
              f"LC train: {name} launched {launches[name]} times in "
              f"{LC_TRAIN_STEPS} steps, expected {n} per step")
    ms_step = elapsed / LC_TRAIN_STEPS * 1e3
    ex_s = LC_TRAIN_STEPS * bs / elapsed
    log(f"  losses: first {losses[0]:.5f}, last {losses[-1]:.5f}; "
        f"repeated batch {repeated[0]:.5f} -> {repeated[-1]:.5f}")
    log(f"  LC train: {LC_TRAIN_STEPS} steps x {bs} rows in {elapsed:.4f} s"
        f" = {ms_step:.4f} ms/step, {ex_s:.1f} train ex/s (host clock,"
        f" synchronised, batches on the device, after 2 warm-up steps)")
    log(f"  launches in the {LC_TRAIN_STEPS} steps: " + json.dumps(launches))
    return launches, ms_step, ex_s


def path_kernels(cfg, training: bool):
    """The attention kernels a forward (and in training its backward) of
    ``cfg``'s model launches once a block: a self-modulating model's MAU
    (the fused kernels, or the streamed ones under ``"flash"``), another
    model's flash kernels under ``"flash"``, else none."""
    if MODELS[cfg.model].uses_tpp:
        if cfg.attention_impl == "flash":
            return STREAMED + (STREAMED_BWD if training else ())
        return (mau_attention,) + ((mau_attention_bwd,) if training else ())
    if cfg.attention_impl == "flash":
        return FLASH_KERNELS if training else (flash_attention_fwd,)
    return ()


def kernel_layers(cfg) -> int:
    """The layers of ``cfg``'s model that launch ``path_kernels``' kernels
    in a forward: TimelyREC's one user-tower attention whatever
    ``num_blocks`` says; a self-modulating model's blocks under
    ``"flash"``, less the last under ``gather_queries``, whose gathered
    rows take the materialised chain (``nn.temporal.mau_dense``, no
    kernel), as in JAX; else one a block."""
    if cfg.model == "TimelyREC":
        return 1
    if (MODELS[cfg.model].uses_tpp and cfg.gather_queries
            and cfg.attention_impl == "flash"):
        return cfg.num_blocks - 1
    return cfg.num_blocks


def mark_table_of(cfg):
    """A seeded mark table where the model reads marks, else None."""
    return (synthetic_mark_table(cfg.num_items, cfg.num_events, seed=0)
            if MODELS[cfg.model].uses_tpp else None)


def phase_model_slice(name, seed, **overrides):
    """Eval batches and ``recommend`` requests of preset ``name`` (with
    ``overrides``) at full width (random weights from seed 0) over
    synthetic data from ``seed`` and ``seed + 1``, marks looked up on the
    device where the model reads them; each kernel of ``path_kernels``
    launched once a layer (``kernel_layers``) a forward, no other kernel.
    Returns (launches, the first eval batch, seqs/s, latencies)."""
    cfg = preset(name, **overrides)
    bs = cfg.batch_size
    model = build_model(cfg, device="cuda",
                        params=random_flax_params(cfg, seed=0))
    table = mark_table_of(cfg)
    split = synthetic_split_vectorized(num_rows=4 * bs,
                                       num_items=cfg.num_items,
                                       seqslen=cfg.seqslen, seed=seed,
                                       with_datetime=True)
    batches = list(BatchLoader(split, data_mode=model.data_mode,
                               batch_size=bs, masklen=cfg.masklen,
                               is_training=False).epoch(0))
    requests = synthetic_split_vectorized(num_rows=3 * bs,
                                          num_items=cfg.num_items,
                                          seqslen=cfg.seqslen, seed=seed + 1,
                                          with_datetime=True)
    req_batches = [{k: v[i * bs:(i + 1) * bs]
                    for k, v in requests.arrays.items()} for i in range(3)]
    step = build_eval_step(model, mark_table=table)
    rec = Recommender(cfg, model, table)
    MetricAccumulator().update(step(model, *batches[0]))  # warm-up
    rec.recommend(req_batches[0], k=50)
    torch.cuda.synchronize()

    counters = FLASH_KERNELS + STREAMED_KERNELS + (mau_attention,)
    for fn in counters:
        fn.launches = 0
    acc = MetricAccumulator()
    t0 = time.perf_counter()
    for features, labels, valid in batches:
        acc.update(step(model, features, labels, valid))
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    latencies, answers = [], []
    for arrays in req_batches:
        t0 = time.perf_counter()
        ids, scores = rec.recommend(arrays, k=50)
        latencies.append(time.perf_counter() - t0)
        answers.append((arrays, ids, scores))
    launches = {fn.__name__: fn.launches for fn in counters}
    forwards = (len(batches) + len(req_batches)) * kernel_layers(cfg)
    on_path = {fn.__name__ for fn in path_kernels(cfg, False)}
    for kernel, n in launches.items():
        want = forwards if kernel in on_path else 0
        check(n == want, f"{name} serving: {kernel} launched {n} times,"
              f" expected {want} ({forwards} attention forwards)")
    metrics = acc.result()
    log(f"  eval over {int(acc.count)} rows: " + json.dumps(metrics))
    for key, val in metrics.items():
        check(math.isfinite(val) and 0.0 <= val <= 1.0, f"metric {key}={val}")
    for arrays, ids, scores in answers:
        check(ids.shape == (bs, 50) and scores.shape == (bs, 50),
              f"{name} recommend shapes")
        check(bool(np.isfinite(scores).all()),
              f"{name} recommend: not finite")
        check(bool((scores[:, :-1] >= scores[:, 1:]).all()),
              f"{name} recommend: scores not sorted descending")
        check(bool((ids != 0).all()), f"{name} recommend: padding id 0")
        check(name != "GREC" or bool((ids != cfg.num_items + 1).all()),
              f"{name} recommend: the last id (a -1000 column)")
        seen = rec.protocol(arrays, False, None)[0]["seqs_i"]
        check(not any(set(ids[r].tolist()) & set(seen[r].tolist())
                      for r in range(bs)),
              f"{name} recommend: a seen id returned")
    seqs_per_s = len(batches) * bs / eval_s
    log(f"  eval: {len(batches)} batches x {bs} rows in {eval_s:.4f} s ="
        f" {seqs_per_s:.1f} seqs/s (synchronised)")
    log(f"  recommend k=50, B={bs}: latency per batch "
        + ", ".join(f"{x * 1e3:.3f} ms" for x in latencies))
    log(f"  launches on the {name} served path ({len(batches)} eval +"
        f" {len(req_batches)} recommend forwards, {kernel_layers(cfg)}"
        f" layers with kernels): " + json.dumps(launches))
    return launches, batches[0], seqs_per_s, latencies


def phase_model_cpu_vs_card(name, batch, rows=2, sides=None, **overrides):
    """fp32 logits of preset ``name`` (with ``overrides``) on ``rows`` rows
    of ``batch``, one eval forward a side at dropout 0; the marks from
    ``mark_table_of`` where the model reads them. ``sides``: two (device,
    config overrides) pairs, the second the reference; by default the card
    (kernels) against the CPU (plain versions)."""
    sides = sides or (("cuda", {}), ("cpu", {}))
    cfg = preset(name, compute_dtype="float32", **overrides)
    params = random_flax_params(cfg, seed=0)
    features = {k: v[:rows] for k, v in batch[0].items()}
    table = mark_table_of(cfg)
    if table is not None:
        ids = features["seqs_i"]
        features["seqs_marks"] = table[np.where(ids >= table.shape[0], 0,
                                                ids)].astype(np.float32)
    logits = []
    for dev, kw in sides:
        model = build_model(cfg.replace(**kw), device=dev, params=params)
        with torch.no_grad():
            out, _ = model(to_device(features, dev), is_training=False)
        logits.append(out.cpu())
        del model
    got, want = logits
    err = (got - want).abs()
    atol, rtol = SLICE_TOL
    ratio = float((err / (atol + rtol * want.abs())).max())
    what = " vs ".join(" ".join([dev] + [f"{k}={v}" for k, v in kw.items()])
                       for dev, kw in sides)
    log(f"  logits {tuple(want.shape)}, {what}:"
        f" max_abs={float(err.max()):.3e}"
        f" tol(atol={atol:g}, rtol={rtol:g}) worst/tol={ratio:.3f}")
    check(ratio <= 1.0, f"{name} logits {what} outside tolerance")


def phase_model_train(name, seed, steps, repeat, **overrides):
    """``steps`` faithful train steps of preset ``name`` (with
    ``overrides``) at full width (the preset's dropout, loss, TPP and L2
    terms and TF-Adam; marks looked up on the device where the model reads
    them) after 2 warm-up steps, then ``repeat`` on one repeated batch,
    whose loss must fall; each kernel of ``path_kernels`` launched once a
    layer (``kernel_layers``) a step, the catalog kernels once a step, no
    other kernel.
    Returns (launches, ms/step, ex/s)."""
    cfg = preset(name, **overrides)
    bs = cfg.batch_size
    model = build_model(cfg, device="cuda",
                        params=random_flax_params(cfg, seed=0))
    split = synthetic_split_vectorized(num_rows=4 * bs,
                                       num_items=cfg.num_items,
                                       seqslen=cfg.seqslen, seed=seed,
                                       with_datetime=True)
    loader = BatchLoader(split, data_mode=model.data_mode, batch_size=bs,
                         masklen=cfg.masklen, is_training=True)
    batches = [(to_device(f, "cuda"), torch.as_tensor(lab, device="cuda"))
               for f, lab, _ in loader.epoch(0)]
    step = build_train_step(model, mark_table=mark_table_of(cfg))
    state = init_state(model)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for features, labels in batches[:2]:  # warm-up, not counted
        state, _ = step(state, features, labels, gen)
    torch.cuda.synchronize()

    counters = FLASH_KERNELS + (catalog_nll_fwd, catalog_nll_bwd) \
        + STREAMED_KERNELS + (mau_attention, mau_attention_bwd)
    for fn in counters:
        fn.launches = 0
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        features, labels = batches[i % len(batches)]
        state, loss = step(state, features, labels, gen)
        losses.append(loss)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    repeated = []
    for _ in range(repeat):
        state, loss = step(state, *batches[0], gen)
        repeated.append(loss)
    losses = [float(x) for x in losses]
    repeated = [float(x) for x in repeated]
    check(all(math.isfinite(x) for x in losses + repeated),
          f"{name} train: a loss is not finite")
    check(repeated[-1] < repeated[0],
          f"{name} train: loss on a repeated batch did not fall "
          f"({repeated})")
    per_step = {fn.__name__: 0 for fn in counters}
    per_step.update({fn.__name__: kernel_layers(cfg)
                     for fn in path_kernels(cfg, True)})
    per_step.update(catalog_nll_fwd=1, catalog_nll_bwd=1)
    for kernel, n in per_step.items():
        check(launches[kernel] == n * steps,
              f"{name} train: {kernel} launched {launches[kernel]} times in"
              f" {steps} steps, expected {n} per step")
    ms_step = elapsed / steps * 1e3
    ex_s = steps * bs / elapsed
    log(f"  losses: first {losses[0]:.5f}, last {losses[-1]:.5f}; "
        f"repeated batch {repeated[0]:.5f} -> {repeated[-1]:.5f}")
    log(f"  {name} train: {steps} steps x {bs} rows in"
        f" {elapsed:.4f} s = {ms_step:.4f} ms/step, {ex_s:.1f} train ex/s"
        f" (host clock, synchronised, batches on the device, after 2"
        f" warm-up steps)")
    log(f"  launches in the {steps} steps: " + json.dumps(launches))
    return launches, ms_step, ex_s


@contextlib.contextmanager
def plain_engine(model_cls):
    """The model's long-context attention engine (``long_context_engine``)
    with its plain version in place of its kernels, on any device: for
    EasyDGL the streamed MAU's (``mau_blocked`` and its custom backward),
    for SASREC flash attention's (the plain forward, differentiated by
    autograd)."""
    module, name, plain = model_cls.long_context_engine
    saved = getattr(module, name)
    setattr(module, name, plain)
    try:
        yield
    finally:
        setattr(module, name, saved)


def pad_free(features):
    """A regressive batch with every padded position made real: id 1, and
    the stamp of the row's first real event (every row then sees a key at
    every position, and no span reaches back to a stamp of 0)."""
    out = dict(features)
    ids, ts = features["seqs_i"].copy(), features["seqs_t"].copy()
    ids[ids == 0] = 1
    for r in range(ts.shape[0]):
        real = ts[r][ts[r] > 0]
        ts[r][ts[r] == 0] = real[0] if len(real) else 1.0
    out["seqs_i"], out["seqs_t"] = ids, ts
    return out


def phase_train_cpu_vs_card(name="EasyDGL", rows=8, device_floor=False,
                            sides=(("cuda", {}), ("cpu", {})),
                            no_padding=False, **overrides):
    """One full-width fp32 train step of a preset at dropout 0, card
    (kernels) vs CPU (plain versions): loss, every gradient and the
    parameters after the TF-Adam update. ``sides``: two (device, config
    overrides) pairs, the second the reference; ``no_padding``: the batch
    made ``pad_free``.

    With ``device_floor`` the step's gradients are also taken on the card
    with the long-context engine's plain version (``plain_engine``). Every
    leaf is then held to 1e-4 of its scale against those (the kernels
    against their plain version on one device), and against the CPU unless
    the plain version on the card misses the CPU by more than that itself:
    such a leaf's card-vs-CPU gap is the two devices' fp32 floor for this
    step (other reductions, other exp and sigmoid roundings), not the
    kernels'."""
    cfg = preset(name, num_events=64, batch_size=rows,
                 hidden_dropout_rate=0.0, attention_probs_dropout_rate=0.0,
                 **overrides)
    params = random_flax_params(cfg, seed=0)
    model_cls = MODELS[cfg.model]
    table = mark_table_of(cfg)
    split = synthetic_split_vectorized(num_rows=rows,
                                       num_items=cfg.num_items,
                                       seqslen=cfg.seqslen, seed=3,
                                       with_datetime=True)
    features, labels, _ = next(BatchLoader(
        split, data_mode=model_cls.data_mode, batch_size=rows,
        masklen=cfg.masklen, is_training=True).epoch(0))
    if no_padding:
        features = pad_free(features)

    def grads_on(dev, kw=None):
        model = build_model(cfg.replace(**(kw or {})), device=dev,
                            params=params)
        lab = torch.as_tensor(labels, device=dev)
        feats = to_device(features, dev)
        if table is not None:
            feats = device_marks(feats, lab, torch.as_tensor(
                table, dtype=torch.float32, device=dev), is_training=True)
        grads = loss_and_grads(model, feats, lab)[1]
        return model, {k: g.cpu() for k, g in grads.items()}

    res = []
    for dev, kw in sides:
        model, grads = grads_on(dev, kw)
        state, loss = build_train_step(model, mark_table=table)(
            init_state(model), features, labels, torch.Generator(device=dev))
        res.append((float(loss), grads,
                    {k: p.detach().cpu() for k, p in state.params.items()}))
        del model, state, grads
    grads_plain = None
    if device_floor:
        with plain_engine(model_cls):
            grads_plain = grads_on("cuda")[1]
    (loss_c, grads_c, params_c), (loss_p, grads_p, params_p) = res
    what = " vs ".join(" ".join([dev] + [f"{k}={v}" for k, v in kw.items()])
                       for dev, kw in sides)
    log(f"  loss {what}: {loss_c:.7f}, {loss_p:.7f}")
    check(abs(loss_c - loss_p) <= 1e-5 * abs(loss_p), f"train loss {what}")
    # gradients: 1e-4 of each leaf's largest entry (fp32 sums reassociated,
    # atomics on the card); a key bias (ZERO_GRAD_LEAF) to 1e-4 of its key
    # weight's. Parameters: TF-Adam's first step is
    # u(g) = -lr g / (|g| + e'), e' = eps / sqrt(1 - b2), so a gradient
    # known to within d moves it by up to lr e' d / (|g| - d)^2 where
    # |g| > 2d, and by up to 2 lr where |g| <= 2d.
    lr, eps_t1 = cfg.optim.learning_rate, cfg.optim.eps / math.sqrt(
        1 - cfg.optim.beta2)
    worst_g = worst_p = worst_k = 0.0
    ratios, floored = {}, []
    for name, want in grads_p.items():
        scale = (grads_p[name[:-len("bias")] + "weight"]
                 if ZERO_GRAD_LEAF.search(name) else want)
        d = 1e-4 * float(scale.abs().max()) + 1e-12
        ratios[name] = float((grads_c[name] - want).abs().max()) / d
        held = ratios[name]
        if grads_plain is not None:
            kern = float((grads_c[name] - grads_plain[name]).abs().max()) / d
            worst_k = max(worst_k, kern)
            plain = float((grads_plain[name] - want).abs().max()) / d
            if plain > 1.0:
                floored.append(f"{name} (card vs CPU {ratios[name]:.3f}, "
                               f"plain on the card vs CPU {plain:.3f})")
                held = kern
        worst_g = max(worst_g, held)
        g = want.abs()
        bnd = torch.where(g > 2 * d, 1e-6 + 1e-5 * params_p[name].abs()
                          + lr * eps_t1 * d / (g - d).clamp_min(d) ** 2,
                          torch.tensor(2 * lr))
        perr = (params_c[name] - params_p[name]).abs()
        worst_p = max(worst_p, float((perr / bnd).max()))
    log(f"  {len(grads_p)} gradient leaves ({what}): worst |first - second|"
        f" / (1e-4 * max|second|) = {max(ratios.values()):.3f}; parameters"
        f" after the"
        f" update: worst error / bound = {worst_p:.3f}")
    log("  largest gradient ratios: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(ratios.items(),
                                         key=lambda kv: -kv[1])[:4]))
    if grads_plain is not None:
        log(f"  kernels vs the plain version on the card: worst |kernels -"
            f" plain| / (1e-4 * max|CPU|) = {worst_k:.3f}")
        log("  held against the plain version on the card (its own gap to"
            " the CPU is above 1e-4): " + (", ".join(floored) or "none"))
        check(worst_k <= 1.0,
              "train gradients kernels vs plain on the card outside tolerance")
    check(worst_g <= 1.0, f"train gradients {what} outside tolerance")
    check(worst_p <= 1.0, f"updated parameters {what} outside tolerance")


def phase_day_boundary_buckets(rows=8):
    """TiSASREC's interval buckets at its preset's shape (B = 512, L = 30,
    timelen 256) of whole-day stamps up to 300 days apart
    (``day_boundary_stamps``, where a span's bucket depends on the order of
    the fp32 operations), on the card equal to the CPU's and to numpy's
    fp32 ones, the JAX source's order; the count of pairs that dividing by
    a Python float (on the card a product with the fp32 reciprocal) would
    move. Returns ``rows`` rows of the stamps with ids, as a batch."""
    cfg = preset("TiSASREC")
    bs, length = cfg.batch_size, cfg.seqslen + 1
    rng = np.random.default_rng(39)
    stamps = day_boundary_stamps(rng, bs, length, max_days=300,
                                 day=cfg.time_scale)
    ids = rng.integers(1, cfg.num_items, (bs, cfg.seqslen)).astype(np.int32)
    ids[0, :2] = 0
    want = interval_buckets_numpy(stamps, cfg.time_scale, cfg.timelen)
    on_card = torch.as_tensor(stamps, device="cuda")
    got = {dev: interval_buckets(t, cfg.time_scale, cfg.timelen).cpu()
           .numpy() for dev, t in (("card", on_card),
                                   ("CPU", torch.as_tensor(stamps)))}
    ts = on_card / cfg.time_scale
    by_reciprocal = (ts[:, 1:, None] - ts[:, None, :-1]).clamp(
        0.0, float(cfg.timelen)).to(torch.int32).cpu().numpy()
    moved = {dev: int((b != want).sum()) for dev, b in got.items()}
    log(f"  {want.size} pairs ({int((want == cfg.timelen).sum())} in the "
        f"edge bucket): differing from numpy's fp32 buckets on the card "
        f"{moved['card']}, on the CPU {moved['CPU']}; divided by a Python "
        f"float on the card {int((by_reciprocal != want).sum())}")
    check(moved["card"] == 0 and moved["CPU"] == 0,
          "TiSASREC interval buckets of whole-day stamps differ from the "
          "fp32 division-first order")
    return ({"seqs_i": ids[:rows], "seqs_t": stamps[:rows]},)


def phase_timelyrec_flash(first):
    """TimelyREC's ``"flash"`` form at its preset: against its ``"xla"``
    form on the card (fp32, dropout 0: the logits of ``first``, a whole
    eval batch, and one train step on 8 rows), then in bf16 eval batches
    and ``recommend`` requests through the flash forward (dh = 128) and
    faithful train steps through the flash kernels and the catalog
    kernels. Returns the launches and rates of its paths."""
    log("phase 6n': TimelyREC's flash form against its xla form on the "
        "card at the preset (fp32, dropout 0): the eval logits of a whole "
        "batch, and one train step on 8 rows")
    flash = dict(attention_impl="flash")
    phase_model_cpu_vs_card("TimelyREC", first,
                            rows=first[0]["seqs_i"].shape[0],
                            sides=(("cuda", flash), ("cuda", {})))
    phase_train_cpu_vs_card("TimelyREC", rows=8,
                            sides=(("cuda", flash), ("cuda", {})))
    log("phase 5n2: TimelyREC flash at the preset (B=512, L=30, H=4, "
        "dh=128, bf16): eval + recommend through the flash forward")
    serve, _, seqs_s, lat = phase_model_slice(
        "TimelyREC", 55, compute_dtype="bfloat16", **flash)
    log("phase 7n2: TimelyREC flash faithful train steps (dropout 0.1 / "
        "0.1) through the flash kernels (the dh = 128 backward on "
        "flash_wide.cu) and the catalog kernels at N=15,360")
    train, ms, ex_s = phase_model_train(
        "TimelyREC", 57, FLASH_TRAIN_STEPS, FLASH_REPEAT_STEPS,
        compute_dtype="bfloat16", **flash)
    return dict(serve_launches=serve, launches=train, seqs_s=seqs_s,
                lat=lat, ms_step=ms, ex_s=ex_s, bs=512)


def phase_bochner(name, tag, seed, what):
    """Phases 5-8 of a Bochner time model (TGAT, TGREC) at its preset,
    its flash and factored forms against its dense form (6'), and its flash
    form at L = 2048, B = 8 (5?2, 7?2). Returns the launches and rates of
    its paths."""
    log(f"phase 5{tag}: {name} eval + serving at full width on the card "
        f"(PRESETS[\"{name}\"]: {what}, bf16; no kernel on the served "
        f"path)")
    _, first, seqs_s, lat = phase_model_slice(
        name, seed, compute_dtype="bfloat16")
    log(f"phase 6{tag}: full-width fp32 {name}, card vs CPU, 8 rows")
    phase_model_cpu_vs_card(name, first, rows=8)
    log(f"phase 6{tag}': {name}'s flash and factored forms against its "
        f"dense form on the card at the preset (fp32, dropout 0): the "
        f"eval logits of a whole batch, and one train step on 8 rows "
        f"with the padding made real (pad_free: every row live)")
    for impl in ("flash", "factored"):
        phase_model_cpu_vs_card(
            name, first, rows=first[0]["seqs_i"].shape[0],
            sides=(("cuda", dict(attention_impl=impl)),
                   ("cuda", dict(attention_impl="xla"))))
        phase_train_cpu_vs_card(
            name, rows=8, no_padding=True,
            sides=(("cuda", dict(attention_impl=impl)), ("cuda", {})))
    log(f"phase 7{tag}: {name} faithful train steps at full width on the"
        f" card ({what.split(', 3 blocks')[0]}, bf16, the preset's "
        f"dropout, softmax-eps over every position, TF-Adam, the catalog"
        f" kernels)")
    model_launches, model_ms, model_ex_s = phase_model_train(
        name, seed + 2, TRAIN_STEPS, REPEAT_STEPS,
        compute_dtype="bfloat16")
    log(f"phase 8{tag}: full-width fp32 {name} train step, card (catalog"
        f" kernels) vs CPU (plain), 8 rows, dropout 0")
    phase_train_cpu_vs_card(name, rows=8)
    log(f"phase 5{tag}2: {name} with attention_impl=\"flash\" at L=2048,"
        f" B=8 (the preset's widths, bf16): eval + recommend through the"
        f" wide flash forward")
    lc_launches_b, _, lc_seqs_b, lc_lat_b = phase_model_slice(
        name, seed + 4, compute_dtype="bfloat16", **BOCHNER_LC)
    log(f"phase 7{tag}2: {name} flash at L=2048, B=8: faithful train "
        f"steps through the wide flash kernels and the catalog kernels "
        f"at N=16,384")
    lc_train_b, lc_ms_b, lc_ex_b = phase_model_train(
        name, seed + 6, FLASH_TRAIN_STEPS, FLASH_REPEAT_STEPS,
        compute_dtype="bfloat16", **BOCHNER_LC)
    return dict(launches=model_launches, seqs_s=seqs_s, lat=lat,
                ms_step=model_ms, ex_s=model_ex_s, lc_launches=lc_launches_b,
                lc_train_launches=lc_train_b, lc_seqs_s=lc_seqs_b,
                lc_lat=lc_lat_b, lc_ms_step=lc_ms_b, lc_ex_s=lc_ex_b)


HARNESS_ROWS = 4096   # cli.train's synthetic rule: 8 steps an epoch at B=512
# rows 1-4's wrappers by their kernels-line names
HARNESS_KERNELS = {"mau_attention_fwd": mau_attention,
                   "mau_attention_bwd": mau_attention_bwd,
                   "catalog_nll_fwd": catalog_nll_fwd,
                   "catalog_nll_bwd": catalog_nll_bwd}


@contextlib.contextmanager
def patched(obj, name, value):
    """``obj.name = value`` for the span."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


class LoopRecords(logging.Handler):
    """The train loop's epoch lines (epoch, loss, seconds, train ex/s) and
    the step it resumed from, as logged."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.epochs, self.resumed = [], []

    def emit(self, record):
        if not isinstance(record.msg, str):
            return
        if record.msg.startswith("%03d: Loss"):
            self.epochs.append(record.args)
        elif record.msg.startswith("resumed from step"):
            self.resumed.append(record.args[0])


def template_ints(key: str, base: str):
    """The integer (and bool, as 0 / 1) template arguments of kernel
    ``base`` in a profiler key, which is demangled (``void
    base<__nv_bfloat16, 64, 1>(...)``, ``base<64, true>``, ``base(...)``);
    None where ``base`` is not the key's kernel."""
    m = re.search(rf"(?<!\w){re.escape(base)}(<[^()]*>)?(\(|$)", key)
    if not m:
        return None
    return [int(x) if x.isdigit() else int(x == "true")
            for x in re.findall(r"\b(\d+|true|false)\b", m.group(1) or "")]


def profiler_launches(prof, names):
    """Launches of each CUDA kernel of ``names`` (``base<ints>`` as in
    ``CUDA_KERNELS``, the type arguments left out) in a profile of the
    card."""
    counts = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for name in names:
            base, _, args = name.partition("<")
            want = [int(x) for x in re.findall(r"\b\d+\b", args)]
            if template_ints(e.key, base) == want:
                counts[name] = counts.get(name, 0) + e.count
    return counts


def run_harness(cfg, flags, device, rows):
    """``cli.train`` for two epochs and one more with ``--resume``,
    ``cli.analytics`` on the checkpoint, ``Recommender.from_checkpoint``,
    in the current directory. Returns the numbers the checks and the
    report read; the kernels' launch counts are the caller's."""
    from easydgl_tpu_torch.cli import analytics as analytics_cli
    from easydgl_tpu_torch.cli import train as train_cli
    from easydgl_tpu_torch.data.synthetic import synthetic_split
    from easydgl_tpu_torch.train import loop
    from easydgl_tpu_torch.train.checkpoint import Checkpointer

    saves, finals = [], []

    class RecordingCheckpointer(Checkpointer):
        """Times each save, and keeps the weights it saved."""

        def save(self, state, step=None):
            t0 = time.perf_counter()
            super().save(state, step)
            step = int(state.step) if step is None else step
            saves.append(dict(step=step,
                              seconds=time.perf_counter() - t0,
                              bytes=os.path.getsize(self.path(step)),
                              params={k: v.detach().clone()
                                      for k, v in state.params.items()}))

    def recording_train_model(*args, **kwargs):
        state, summary = loop.train_model(*args, **kwargs)
        finals.append(state.step)
        return state, summary

    records = LoopRecords()
    loop_log = logging.getLogger(loop.__name__)
    old_level = loop_log.level
    loop_log.addHandler(records)
    loop_log.setLevel(logging.INFO)
    argv = ["--model", cfg.model, "--synthetic", "--synthetic_rows",
            str(rows), "--ckpt_dir", "ckpt", "--device", device, *flags]
    try:
        with patched(loop, "Checkpointer", RecordingCheckpointer), \
                patched(train_cli, "train_model", recording_train_model):
            summary2 = train_cli.main(argv + ["--num_epochs", "2"])
            first_saves = len(saves)
            steps_per_epoch = -(-rows // cfg.batch_size)
            prof_acts = ([torch.profiler.ProfilerActivity.CUDA]
                         if device == "cuda" else
                         [torch.profiler.ProfilerActivity.CPU])
            with torch.profiler.profile(activities=prof_acts) as prof:
                summary3 = train_cli.main(argv + ["--num_epochs", "3",
                                                  "--resume"])
                if device == "cuda":
                    torch.cuda.synchronize()
    finally:
        loop_log.removeHandler(records)
        loop_log.setLevel(old_level)
    synthetic_split(num_rows=rows // 8, seed=3, num_items=cfg.num_items,
                    seqslen=cfg.seqslen, with_datetime=True).save("test.npz")
    table = synthetic_mark_table(cfg.num_items, cfg.num_events, seed=4)
    np.save("mark.npy", table)
    res = analytics_cli.main([
        "--ckpt", "ckpt", "--model", cfg.model, "--data_dir", ".",
        "--mark", "mark.npy", "--out", "res", "--device", device,
        *flags])
    head = {k: v[:cfg.batch_size]
            for k, v in PackedDataset.load("test.npz").arrays.items()}
    ids, scores = Recommender.from_checkpoint(
        cfg, "ckpt", head, table, device=device).recommend(head, k=50)
    return dict(summary2=summary2, summary3=summary3, res=res,
                finals=finals, saves=saves, first_saves=first_saves,
                epochs=records.epochs, resumed=records.resumed,
                steps_per_epoch=steps_per_epoch, prof=prof, head=head,
                table=table, ids=ids, scores=scores,
                latest=Checkpointer("ckpt").latest_step(),
                pickled=os.path.getsize("res"))


def check_harness(cfg, out, device):
    """The harness run's checks: the step count continues across the
    resume, analytics reproduces the summary's H100, and the checkpoint
    serves what the weights it saved serve."""
    spe = out["steps_per_epoch"]
    resumed_from = out["saves"][out["first_saves"] - 1]["step"]
    check(out["finals"] == [2 * spe, 3 * spe],
          f"harness: final steps {out['finals']}, expected "
          f"{[2 * spe, 3 * spe]}")
    check(out["resumed"] == [resumed_from],
          f"harness: resumed from {out['resumed']}, the checkpoint held "
          f"step {resumed_from}")
    epochs = [a[0] for a in out["epochs"]]
    check(epochs == [0, 1] + list(range(resumed_from // spe, 3)),
          f"harness: epochs run {epochs}")
    check(all(math.isfinite(a[1]) for a in out["epochs"]),
          "harness: an epoch's loss is not finite")
    check(out["latest"] == out["saves"][-1]["step"],
          "harness: the latest checkpoint is not the last saved")
    got, want = out["res"]["H100"], out["summary3"]["H100"]
    check(abs(got - want) <= 1e-6 * abs(want),
          f"harness: analytics H100 {got} != the summary's {want}")
    for key, val in out["res"].items():
        check(math.isfinite(val) and 0.0 <= val <= 1.0,
              f"harness: analytics {key}={val}")
    model = build_model(cfg, device=device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(out["saves"][-1]["params"][name])
    ids, scores = Recommender(cfg, model, out["table"]).recommend(
        out["head"], k=50)
    check(np.array_equal(ids, out["ids"]),
          "harness: from_checkpoint recommends other ids than the weights"
          " the checkpoint saved")
    check(np.array_equal(scores, out["scores"]),
          "harness: from_checkpoint scores differ from the saved weights'")
    check(bool((out["ids"] != 0).all())
          and bool((out["scores"][:, :-1] >= out["scores"][:, 1:]).all()),
          "harness: recommend ids or order")


def phase_harness(card, step_ex_s):
    log("phase 9: the training harness at full width on the card: "
        "cli.train --synthetic (PRESETS[\"EasyDGL\"], 64 marks, bf16; "
        f"{HARNESS_ROWS:,} train rows, 8 steps an epoch; 512 validation and"
        " 512 test rows) for 2 epochs, then 1 more with --resume under "
        "torch.profiler; cli.analytics and Recommender.from_checkpoint on "
        "its checkpoint")
    cfg = preset("EasyDGL", num_events=64, compute_dtype="bfloat16")
    flags = ["--num_events", "64", "--compute_dtype", "bfloat16"]
    cwd, root_handlers = os.getcwd(), list(logging.getLogger().handlers)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_harness_")
    t0 = time.perf_counter()
    try:
        os.chdir(tmp)
        for fn in HARNESS_KERNELS.values():
            fn.launches = 0
        out = run_harness(cfg, flags, "cuda", HARNESS_ROWS)
        launches = {name: fn.launches
                    for name, fn in HARNESS_KERNELS.items()}
        check_harness(cfg, out, "cuda")
    finally:
        os.chdir(cwd)
        for h in logging.getLogger().handlers:
            if h not in root_handlers:
                logging.getLogger().removeHandler(h)
                h.close()
        shutil.rmtree(tmp, ignore_errors=True)
    seconds = time.perf_counter() - t0
    prof = profiler_launches(out["prof"], [
        k for name in HARNESS_KERNELS for k in CUDA_KERNELS[name]])
    for name in HARNESS_KERNELS:
        check(launches[name] > 0, f"harness: {name} was not launched")
        check(sum(prof.get(k, 0) for k in CUDA_KERNELS[name]) > 0,
              f"harness: the profile shows no kernel of {name}")
    ex_s = out["epochs"][1][3]
    save = out["saves"][-1]
    log(f"  epochs (epoch, loss, s, train ex/s with the loader): "
        + "; ".join(f"{a[0]}: {a[1]:.5f}, {a[2]:.4f} s, {a[3]:.1f}"
                    for a in out["epochs"])
        + " (epoch 2 of the resumed run under the profiler)")
    log(f"  resumed from step {out['resumed'][0]}, final steps "
        f"{out['finals']}; summary after resume: "
        + json.dumps(out["summary3"]))
    log(f"  analytics on the checkpoint: " + json.dumps(out["res"])
        + f"; logits pickle {out['pickled']:,} bytes")
    log(f"  checkpoint saves: "
        + ", ".join(f"step {x['step']} {x['seconds']:.4f} s"
                    for x in out["saves"])
        + f"; size {save['bytes']:,} bytes")
    log(f"  launches on the harness path: " + json.dumps(launches)
        + "; in the profile of the resumed run: " + json.dumps(prof))
    log(f"  harness: {ex_s:.1f} train ex/s through cli.train, loader "
        f"included (epoch 1, StepTimer), beside phase 7's {step_ex_s:.1f}"
        f" (batches on the device); {out['epochs'][1][2]:.4f} s an epoch; "
        f"phase {seconds:.1f} s on {card}")
    return dict(launches=launches, profiler=prof, ex_s=ex_s,
                epoch_s=out["epochs"][1][2], save_s=save["seconds"],
                save_bytes=save["bytes"])


# ---------------------------------------------------------------- phase 10
# The distributed layer (kernels/spmd.py, train/sharded.py): every shard's
# step of each SPMD wrapper on this one card against the unsharded kernel,
# then the sharded train step, the distributed eval and cli.train under a
# real NCCL process group of one rank on a (1, 1) mesh.

SHARD_MPS = (2, 4)
SHARD_KERNELS = (mau_attention, mau_attention_bwd, catalog_nll_fwd,
                 catalog_nll_bwd, flash_attention_fwd, flash_attention_bwd)
SHARD_ROWS = 2048     # cli.train --synthetic rows: 4 steps an epoch at B=512


def stacked(reduce):
    """A reduction over a stacked leading (shard) dim, broadcast back to
    every shard: the one-card stand-in for the merge's collective over the
    model axis."""
    return lambda x: reduce(x).expand_as(x)


def shard_tag(dtype) -> str:
    return "bf16" if dtype == torch.bfloat16 else "fp32"


def check_errs(name, errs):
    for label, (_, ratio) in errs.items():
        check(ratio <= 1.0, f"{name}: {label} outside tolerance")
    return max(err for err, _ in errs.values())


def sharded_catalog_case(mp, dtype, seed):
    """catalog_nll_spmd's shard-local step on each of mp vocab slices of
    the flagship's catalog (N = 3,072, V = 17,772: 8,886 or 4,443 ids a
    slice, labels outside a slice at -1) and its merge, forward and (by
    autograd through the kernels' backward) backward, against the
    unsharded kernels at the same cotangents. Returns (max abs err, the
    slice's inputs for timing)."""
    h, t, b, lab, dlse, dll = catalog_inputs(**CATALOG, dtype=dtype,
                                             seed=seed)
    vl = CATALOG["v"] // mp
    mine = [x.detach().clone().requires_grad_() for x in (h, t, b)]
    parts = [catalog_nll_local(mine[0], mine[1][m * vl:(m + 1) * vl],
                               mine[2][m * vl:(m + 1) * vl], lab, m * vl)
             for m in range(mp)]
    lse, ll = catalog_merge(
        torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts]),
        stacked(lambda x: x.amax(0, keepdim=True)),
        stacked(lambda x: x.sum(0, keepdim=True)))
    torch.autograd.backward((lse[0], ll[0]), (dlse, dll))
    ref = [x.detach().clone().requires_grad_() for x in (h, t, b)]
    rlse, rll = catalog_nll(*ref, lab)
    torch.autograd.backward((rlse, rll), (dlse, dll))
    torch.cuda.synchronize()
    name = f"catalog_mp{mp}_{shard_tag(dtype)}"
    inside = [int(((lab >= m * vl) & (lab < (m + 1) * vl)).sum())
              for m in range(mp)]
    check(all(0 < n < CATALOG["n"] for n in inside),
          f"{name}: a slice holds every label or none ({inside})")
    errs = {label: scale_err(name, label, a.detach(), w.detach(),
                             torch.float32)
            for label, a, w in (("lse", lse[0], rlse), ("ll", ll[0], rll))}
    for label, a, w in zip(CATALOG_BWD, mine, ref):
        errs[label] = scale_err(name, label, a.grad, w.grad, dtype)
    lab0 = shard_labels(lab, 0, vl)
    return check_errs(name, errs), (h, t[:vl], b[:vl], lab0, dlse, dll)


def mau_shard_run(leaves, args, go, gl, mp, rate, sd, fn):
    """Every shard's step (``fn``: mau_attention_local, or its plain
    version) on its heads' channel blocks of the leaves, the outputs
    concatenated, and the gradients of (out, lam) at (go, gl)."""
    km, iv, oh = args[4:7]
    h = FLAGSHIP["h"]
    outs, lams = [], []
    for m in range(mp):
        blk = [head_block(x, m, mp, -1) for x in leaves[:4]]
        o, lam = fn(*blk, km, iv, oh, *leaves[4:], sd, False, True, rate, h,
                    None, mi=m, mp=mp)
        outs.append(o)
        lams.append(lam)
    out, lam = torch.cat(outs, -1), torch.cat(lams, 1)
    grads = torch.autograd.grad((out, lam), leaves, (go, gl))
    return out.detach(), lam.detach(), grads


def sharded_mau_case(mp, rate, seed):
    """mau_attention_spmd's shard-local step on each of mp head groups at
    the flagship shape (B = 512, T = 31, H = 8: 4 or 2 heads a shard,
    BiMAU, bf16), the outputs gathered, forward and backward. At dropout 0
    against the unsharded kernels; at 0.1 (each shard its own seed)
    against the plain version of every shard's step, with each shard's
    keep rate within 0.002 of 0.9 and no two shards' masks alike."""
    dtype = torch.bfloat16
    args = mau_inputs(**FLAGSHIP, dtype=dtype, gathered=False, seed=seed)
    go, gl = mau_bwd_args(args, dtype, seed)
    sd = (torch.tensor(seed, dtype=torch.int64, device="cuda") if rate
          else None)
    pick = lambda: [x.detach().clone().requires_grad_()  # noqa: E731
                    for x in args[:4] + args[7:11]]
    out, lam, grads = mau_shard_run(pick(), args, go, gl, mp, rate, sd,
                                    mau_attention_local)
    name = f"mau_mp{mp}_bf16" + ("_drop" if rate else "")
    if rate == 0.0:
        ref = pick()
        rout, rlam = mau_attention(*ref[:4], *args[4:7], *ref[4:], False,
                                   True, 0.0, num_heads=FLAGSHIP["h"])
        rgrads = torch.autograd.grad((rout, rlam), ref, (go, gl))
        rout, rlam = rout.detach(), rlam.detach()
    else:   # each shard's plain forward and written-out backward
        parts = []
        for m in range(mp):
            blk = [head_block(x, m, mp, -1) for x in args[:4]]
            kw = dict(causal=False, diag_reset=True, dropout_rate=rate,
                      dropout_seed=shard_seed(sd, mi=m, mp=mp),
                      num_heads=FLAGSHIP["h"] // mp)
            parts.append(mau_attention_reference(
                *blk, *args[4:11], **kw) + mau_attention_bwd_reference(
                *blk, *args[4:11], head_block(go, m, mp, -1),
                head_block(gl, m, mp, 1), **kw))
        rout = torch.cat([p[0] for p in parts], -1)
        rlam = torch.cat([p[1] for p in parts], 1)
        rgrads = ([torch.cat([p[2 + i] for p in parts], -1)
                   for i in range(4)]
                  + [sum(p[6 + i] for p in parts) for i in range(4)])
    torch.cuda.synchronize()
    errs = {label: scale_err(name, label, a, w, dtype)
            for label, a, w in (("out", out, rout), ("lam", lam, rlam))}
    for label, a, w in zip(MAU_GRADS, grads, rgrads):
        errs[label] = scale_err(name, label, a, w, dtype)
    keep = {}
    if rate:
        b, t, hl = FLAGSHIP["b"], FLAGSHIP["tq"], FLAGSHIP["h"] // mp
        masks = [dropout_factor(shard_seed(sd, mi=m, mp=mp),
                                (b, hl, t, t), rate, "cuda") > 0
                 for m in range(mp)]
        keep = {m: float(x.float().mean()) for m, x in enumerate(masks)}
        alike = max(float((masks[i] == masks[j]).float().mean())
                    for i in range(mp) for j in range(i + 1, mp))
        log(f"  {name}: keep rate by shard "
            + ", ".join(f"{m}: {r:.5f}" for m, r in keep.items())
            + f"; two shards' masks agree on at most {alike:.4f} of the "
            f"entries (independent masks: {0.9 ** 2 + 0.1 ** 2:.2f})")
        check(all(abs(r - (1 - rate)) < 0.002 for r in keep.values()),
              f"{name}: a shard's keep rate is off 0.9")
        check(alike < 0.9, f"{name}: two shards draw alike masks")
    return check_errs(name, errs)


def sharded_flash_case(mp, seed):
    """flash_attention_spmd's shard-local step on each of mp head groups
    at SASREC-LC's shape (B = 32, T = 2048, H = 8: 4 or 2 heads a shard,
    causal, bf16), the outputs gathered, forward and backward, against the
    unsharded kernels."""
    sh = SASREC_LC_ATTN
    q, k, v, km, dout = flash_inputs(sh["b"], sh["h"], sh["t"], sh["t"],
                                     sh["dh"], torch.bfloat16, seed)
    pick = lambda: [x.detach().clone().requires_grad_()  # noqa: E731
                    for x in (q, k, v)]
    mine = pick()
    out = torch.cat([flash_attention_local(
        *(head_block(x, m, mp, 1) for x in mine), km, None, causal=True,
        mi=m, mp=mp) for m in range(mp)], 1)
    grads = torch.autograd.grad(out, mine, dout)
    ref = pick()
    rout = flash_attention(*ref, km, causal=True)
    rgrads = torch.autograd.grad(rout, ref, dout)
    torch.cuda.synchronize()
    name = f"flash_mp{mp}_causal_bf16"
    errs = {"out": scale_err(name, "out", out.detach(), rout.detach(),
                             torch.bfloat16)}
    for label, a, w in zip(FLASH_GRADS, grads, rgrads):
        errs[label] = scale_err(name, label, a, w, torch.bfloat16)
    same = bool(torch.equal(out, rout)) and all(
        torch.equal(a, w) for a, w in zip(grads, rgrads))
    log(f"  {name}: sharded equals unsharded bit for bit: {same}")
    return check_errs(name, errs), (q, k, v, km, dout)


def shard_timing(mp, cat_in, flash_in):
    """One shard's kernels at its shape, beside the bound of that shape:
    the catalog forward and backward on a slice of V / mp ids (bf16), the
    MAU forward and backward on H / mp heads (bf16, dropout 0.1 in the
    backward), flash forward and backward on H / mp heads (bf16)."""
    bf16 = torch.bfloat16
    rows = {}
    h, t, b, lab, dlse, dll = cat_in
    vl = t.shape[0]
    lse, _ = catalog_nll_fwd(h, t, b, lab)
    for name, fn in (
            ("catalog_nll_fwd", lambda: catalog_nll_fwd(h, t, b, lab)),
            ("catalog_nll_bwd", lambda: catalog_nll_bwd(
                h, t, b, lab, lse, dlse, dll))):
        nbytes, flops = catalog_work(n=CATALOG["n"], v=vl, c=CATALOG["c"],
                                     dtype=bf16,
                                     backward=name.endswith("bwd"))
        rows[name] = (time_ms(fn), *bound(nbytes, flops, bf16))
    sh = dict(FLAGSHIP, h=FLAGSHIP["h"] // mp)
    args = mau_inputs(**sh, dtype=bf16, gathered=False, seed=900 + mp)
    (q, k, v, tt, km, iv, oh, wd, bd, w, sc, _) = args
    go, gl = mau_bwd_args(args, bf16, 7)
    sd = torch.tensor(11, dtype=torch.int64, device="cuda")
    _, _, raw = _launch_fwd(q, k, v, tt, km, iv, oh, wd, bd, w, sc, False,
                            True, sh["h"], None, sd, 0.1, want_raw=True)
    for name, fn, work in (
            ("mau_attention_fwd", lambda: run_pair(
                mau_attention, args, causal=False, diag=True, h=sh["h"]),
             mau_work(**sh, dtype=bf16,
                      keys=mau_keys(km, shared_blind=True))),
            ("mau_attention_bwd", lambda: mau_attention_bwd(
                q, k, v, tt, km, iv, oh, wd, bd, w, sc, raw, go, gl,
                causal=False, diag_reset=True, dropout_rate=0.1,
                dropout_seed=sd, num_heads=sh["h"]),
             mau_bwd_work(**sh, dtype=bf16, keys=mau_keys(km)))):
        rows[name] = (time_ms(fn), *bound(*work, bf16))
    q, k, v, km, dout = (head_block(x, 0, mp, 1).contiguous()
                         if x.dim() == 4 else x for x in flash_in)
    fa = SASREC_LC_ATTN
    out, lse = flash_attention_fwd(q, k, v, km, causal=True)
    delta = flash_delta(dout, out)
    for name, fn in (
            ("flash_attention_fwd", lambda: flash_attention_fwd(
                q, k, v, km, causal=True)),
            ("flash_attention_bwd", lambda: flash_attention_bwd(
                q, k, v, km, dout, lse, delta, causal=True))):
        nbytes, flops = flash_work(name, km, h=fa["h"] // mp, t=fa["t"],
                                   dh=fa["dh"], dtype=bf16)
        rows[name] = (time_ms(fn), *bound(nbytes, flops, bf16))
    for name, (ms, bound_ms, by) in rows.items():
        log(f"  mp={mp} shard {name:20s} {ms:.4f} ms  bound "
            f"{bound_ms:.4f} ms ({by})  kernel/bound {ms / bound_ms:.1f}x")
    return {name: dict(ms=ms, bound_ms=bound_ms, bound_by=by)
            for name, (ms, bound_ms, by) in rows.items()}


def phase_shard_checks():
    log("phase 10a: the SPMD wrappers' shard-local steps on this card, every"
        " shard at mp = 2 and 4, merged by the wrappers' merges, against "
        "the unsharded kernels (catalog N=3,072 x V=17,772 bf16 and fp32; "
        "MAU at the flagship shape, BiMAU, dropout 0 and 0.1; flash at the "
        "SASREC-LC shape, causal), forward and backward; each shard's "
        "kernels timed at its shape beside its bound")
    errs, timing = {}, {}
    for mp in SHARD_MPS:
        cat_in = None
        for dtype, seed in ((torch.bfloat16, 1100 + mp),
                            (torch.float32, 1110 + mp)):
            err, slice_in = sharded_catalog_case(mp, dtype, seed)
            errs[f"catalog_mp{mp}_{shard_tag(dtype)}"] = err
            cat_in = slice_in if dtype == torch.bfloat16 else cat_in
        for rate in (0.0, 0.1):
            errs[f"mau_mp{mp}_bf16{'_drop' if rate else ''}"] = \
                sharded_mau_case(mp, rate, 1120 + mp)
        err, flash_in = sharded_flash_case(mp, 1130 + mp)
        errs[f"flash_mp{mp}_causal_bf16"] = err
        timing[mp] = shard_timing(mp, cat_in, flash_in)
    return errs, timing


def adam_bound_check(name, cfg, grads_ref, got, want, known):
    """Parameters after one TF-Adam step from gradients known to within
    ``known[leaf]`` (phase 8's bound): u(g) = -lr g / (|g| + e'),
    e' = eps / sqrt(1 - b2), so within lr e' d / (|g| - d)^2 + 1e-7 +
    1e-5 |p| where |g| > 2d, and 2 lr elsewhere."""
    lr = cfg.optim.learning_rate
    eps_t1 = cfg.optim.eps / math.sqrt(1 - cfg.optim.beta2)
    for leaf, w in want.items():
        g = grads_ref[leaf].abs()
        d = known[leaf] + 1e-12
        limit = torch.where(g > 2 * d, 1e-7 + 1e-5 * w.abs()
                            + lr * eps_t1 * d / (g - d).clamp_min(d) ** 2,
                            torch.full_like(g, 2 * lr))
        check(bool(((got[leaf] - w).abs() <= limit).all()),
              f"{name}: parameter {leaf} after the step")


def flagship_batches(cfg, rows, seed, training):
    model_cls = MODELS[cfg.model]
    split = synthetic_split_vectorized(num_rows=rows,
                                       num_items=cfg.num_items,
                                       seqslen=cfg.seqslen, seed=seed)
    return list(BatchLoader(split, data_mode=model_cls.data_mode,
                            batch_size=cfg.batch_size, masklen=cfg.masklen,
                            is_training=training).epoch(0))


def sharded_fp32_step_check(mesh):
    """One fp32 flagship step (the preset's dropout, the same generator
    seed on both sides) through build_sharded_train_step on the (1, 1)
    mesh against build_train_step: the loss and every gradient to 1e-6 of
    its scale, the parameters after the step within the TF-Adam bound of
    gradients known to that. The kernels' atomics (the catalog backward's
    d_table, the lookups' index_add) make two single-device runs differ
    too: where a leaf's gap between them (its floor) exceeds half that
    tolerance, the leaf is held to twice its floor instead, and the
    floor is logged."""
    cfg = preset("EasyDGL", num_events=64)
    params = random_flax_params(cfg, seed=0)
    table = torch.as_tensor(synthetic_mark_table(cfg.num_items, 64, seed=0),
                            device="cuda")
    features, labels, _ = flagship_batches(cfg, cfg.batch_size, 12, True)[0]
    feats = to_device(features, "cuda")
    lab = torch.as_tensor(labels, device="cuda")
    # marks looked up once here: the steps below find them in the batch
    feats = device_marks(feats, lab, table, is_training=True)
    gen = lambda: dropout_generator(cfg.seed, 0, "cuda")  # noqa: E731
    single = build_model(cfg, device="cuda", params=params)
    loss_s, grads_s = loss_and_grads(single, feats, lab, gen())
    _, grads_again = loss_and_grads(single, feats, lab, gen())
    state, _ = build_train_step(single)(init_state(single), feats, lab,
                                        gen())
    sharded = build_model(cfg, device="cuda", params=params)
    st = shard_state(init_state(sharded), sharded, mesh)
    with use_spmd_mesh(mesh):
        loss_m, grads_m = loss_and_grads(sharded, feats, lab, gen())
    st, loss_step = build_sharded_train_step(sharded, mesh)(
        st, feats, lab, gen())
    loss_s, loss_m = float(loss_s), float(loss_m)
    log(f"  fp32 loss single {loss_s:.8f}, sharded (1, 1) {loss_m:.8f}, "
        f"its step's {float(loss_step):.8f}")
    check(abs(loss_m - loss_s) <= 1e-6 * abs(loss_s)
          and abs(float(loss_step) - loss_s) <= 1e-6 * abs(loss_s),
          "sharded (1, 1) fp32 loss")
    worst, known, floored = (0.0, ""), {}, []
    for leaf, want in grads_s.items():
        scale = float(want.abs().max()) + 1e-30
        err = float((grads_m[leaf] - want).abs().max())
        floor = float((grads_again[leaf] - want).abs().max())
        known[leaf] = max(1e-6 * scale, 2 * floor)
        if 2 * floor > 1e-6 * scale:
            floored.append(f"{leaf} {floor / scale:.3e}")
        worst = max(worst, (err / scale, leaf))
        check(err <= known[leaf], f"sharded (1, 1) fp32 gradient {leaf}: "
              f"{err / scale:.3e} of its scale, floor {floor / scale:.3e}")
    adam_bound_check("sharded (1, 1) fp32 step", cfg, grads_s,
                     {k: p.detach() for k, p in st.params.items()},
                     {k: p.detach() for k, p in state.params.items()}, known)
    same = all(torch.equal(st.params[k], state.params[k])
               for k in state.params)
    log(f"  fp32 gradients: worst |sharded - single| / leaf scale "
        f"{worst[0]:.3e} ({worst[1]}) over {len(grads_s)} leaves (tol "
        f"1e-6; two single-device runs' floor above half of it: "
        f"{', '.join(floored) or 'none'}); parameters after the step equal "
        f"bit for bit: {same}")
    return worst[0]


def sharded_eval_check(mesh):
    """build_distributed_eval_step at (1, 1) (the whole catalog one
    rank's slice, the distributed top-k over one rank) against
    build_eval_step, fp32, two B=512 batches: the hit sums equal, the NDCG
    sums to 1e-6 relative. Returns the launches of the distributed
    eval's forwards."""
    cfg = preset("EasyDGL", num_events=64, mask_seen=True)
    params = random_flax_params(cfg, seed=0)
    table = synthetic_mark_table(cfg.num_items, 64, seed=0)
    batches = flagship_batches(cfg, 2 * cfg.batch_size, 13, False)
    single = build_model(cfg, device="cuda", params=params)
    want = MetricAccumulator()
    step = build_eval_step(single, mark_table=table)
    for b in batches:
        want.update(step(single, *b))
    sharded = build_model(cfg, device="cuda", params=params)
    shard_state(init_state(sharded), sharded, mesh)
    dstep = build_distributed_eval_step(sharded, mesh, mark_table=table)
    mau_attention.launches = 0
    got = MetricAccumulator()
    for b in batches:
        got.update(dstep(sharded, *b))
    launches = mau_attention.launches
    check(launches == len(batches) * cfg.num_blocks,
          f"distributed eval: {launches} MAU launches")
    for key, w in want.sums.items():
        g = got.sums[key]
        exact = key.startswith("H")
        check(g == w if exact else abs(g - w) <= 1e-6 * abs(w),
              f"distributed eval {key}: {g} against {w}")
    check(got.count == want.count, "distributed eval row count")
    log("  distributed eval (1, 1) fp32 sums " + json.dumps(got.sums)
        + " against build_eval_step's " + json.dumps(want.sums))
    return launches


def timed_steps(step, state, batches, gen, n):
    """(state, losses, ms/step) of n steps, host clock, synchronised."""
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        state, loss = step(state, *batches[i % len(batches)], gen)
        losses.append(loss)
    torch.cuda.synchronize()
    return state, losses, (time.perf_counter() - t0) / n * 1e3


def sharded_train_timing(mesh, step_ms):
    """20 faithful bf16 flagship steps through build_sharded_train_step at
    (1, 1), batches on the device and 2 warm-up steps as phase 7; besides,
    the single-device step on a copy of the model in turns with it
    (single, sharded, sharded, single; 10 steps each), since the host
    clock spreads more between phases than within one. Returns the
    launches of the 20 steps, their ms/step and the turns' ms/step."""
    cfg = preset("EasyDGL", num_events=64, compute_dtype="bfloat16")
    params = random_flax_params(cfg, seed=0)
    model = build_model(cfg, device="cuda", params=params)
    plain = build_model(cfg, device="cuda", params=params)
    table = synthetic_mark_table(cfg.num_items, cfg.num_events, seed=0)
    batches = [(to_device(f, "cuda"), torch.as_tensor(lab, device="cuda"))
               for f, lab, _ in flagship_batches(cfg, 4 * cfg.batch_size,
                                                 2, True)]
    state = shard_state(init_state(model), model, mesh)
    step = build_sharded_train_step(model, mesh, mark_table=table)
    plain_state = init_state(plain)
    plain_step = build_train_step(plain, mark_table=table)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for features, labels in batches[:2]:
        state, _ = step(state, features, labels, gen)
        plain_state, _ = plain_step(plain_state, features, labels, gen)
    for fn in SHARD_KERNELS:
        fn.launches = 0
    state, losses, ms = timed_steps(step, state, batches, gen, TRAIN_STEPS)
    launches = {fn.__name__: fn.launches for fn in SHARD_KERNELS}
    turns = {"single": [], "sharded": []}
    for name in ("single", "sharded", "sharded", "single"):
        if name == "single":
            plain_state, _, t = timed_steps(plain_step, plain_state, batches,
                                            gen, TRAIN_STEPS // 2)
        else:
            state, _, t = timed_steps(step, state, batches, gen,
                                      TRAIN_STEPS // 2)
        turns[name].append(t)
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses),
          "sharded train: a loss is not finite")
    for name in ("mau_attention", "mau_attention_bwd", "catalog_nll_fwd",
                 "catalog_nll_bwd"):
        check(launches[name] == TRAIN_STEPS,
              f"sharded train: {name} launched {launches[name]} times")
    log(f"  sharded (1, 1) bf16 train: {TRAIN_STEPS} steps x "
        f"{cfg.batch_size} rows = {ms:.4f} ms/step, "
        f"{cfg.batch_size / ms * 1e3:.1f} ex/s, beside phase 7's "
        f"{step_ms:.4f} ms/step single-device in this run; in turns "
        f"(10 steps each) single {turns['single'][0]:.4f}, sharded "
        f"{turns['sharded'][0]:.4f}, {turns['sharded'][1]:.4f}, single "
        f"{turns['single'][1]:.4f} ms/step; losses {losses[0]:.5f} -> "
        f"{losses[-1]:.5f}; launches " + json.dumps(launches))
    return launches, ms, turns


def sharded_cli_run():
    """cli.train --synthetic --dp 1 --mp 1 (the flagship, bf16, 64 marks,
    2,048 rows: 4 steps) for one epoch under the process group, in a
    temporary directory; Recommender.from_checkpoint on its checkpoint.
    Returns the launches of rows 1-4 in the run."""
    from easydgl_tpu_torch.cli import train as train_cli
    cfg = preset("EasyDGL", num_events=64, compute_dtype="bfloat16")
    cwd, root_handlers = os.getcwd(), list(logging.getLogger().handlers)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sharded_cli_")
    try:
        os.chdir(tmp)
        for fn in HARNESS_KERNELS.values():
            fn.launches = 0
        summary = train_cli.main([
            "--model", "EasyDGL", "--synthetic", "--synthetic_rows",
            str(SHARD_ROWS), "--ckpt_dir", "ckpt", "--device", "cuda",
            "--num_events", "64", "--compute_dtype", "bfloat16",
            "--num_epochs", "1", "--dp", "1", "--mp", "1"])
        launches = {name: fn.launches
                    for name, fn in HARNESS_KERNELS.items()}
        from easydgl_tpu_torch.data.synthetic import synthetic_split
        head = synthetic_split(num_rows=16, seed=3, num_items=cfg.num_items,
                               seqslen=cfg.seqslen,
                               with_datetime=True).arrays
        table = synthetic_mark_table(cfg.num_items, 64, seed=4)
        ids, scores = Recommender.from_checkpoint(
            cfg, "ckpt", head, table, device="cuda").recommend(head, k=50)
    finally:
        os.chdir(cwd)
        for h in logging.getLogger().handlers:
            if h not in root_handlers:
                logging.getLogger().removeHandler(h)
                h.close()
        shutil.rmtree(tmp, ignore_errors=True)
    check(all(math.isfinite(v) and 0.0 <= v <= 1.0
              for v in summary.values()), "sharded cli.train: summary")
    check(bool((ids != 0).all())
          and bool((scores[:, :-1] >= scores[:, 1:]).all()),
          "sharded cli.train checkpoint: recommend ids or order")
    for name, n in launches.items():
        check(n > 0, f"sharded cli.train: {name} was not launched")
    log("  cli.train --dp 1 --mp 1, one epoch: summary "
        + json.dumps(summary) + "; launches " + json.dumps(launches)
        + "; Recommender.from_checkpoint served its checkpoint")
    return launches


def phase_sharded(card, step_ms):
    log("phase 10b: a real NCCL process group of one rank (127.0.0.1, a "
        "free port) and a (1, 1) mesh: the flagship through "
        "build_sharded_train_step (one fp32 step against build_train_step;"
        " 20 faithful bf16 steps) and build_distributed_eval_step (fp32, "
        "against build_eval_step)")
    import torch.distributed as dist
    info = init_distributed(None, 1, 0, "cuda")
    try:
        mesh = make_mesh(MeshConfig(dp=1, mp=1), "cuda")
        check(dist.get_backend() == "nccl", "the process group is not NCCL")
        log(f"  rank {info.host_id} of {info.num_hosts} on {info.device}, "
            f"backend {dist.get_backend()}, mesh "
            f"{dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}")
        grad_worst = sharded_fp32_step_check(mesh)
        eval_launches = sharded_eval_check(mesh)
        train_launches, ms, turns = sharded_train_timing(mesh, step_ms)
        log("phase 10c: cli.train --synthetic --dp 1 --mp 1 under the "
            "process group, one epoch; Recommender.from_checkpoint")
        cli_launches = sharded_cli_run()
    finally:
        dist.destroy_process_group()
    log(f"sharded (1, 1) train: {ms:.4f} ms/step beside phase 7's "
        f"{step_ms:.4f} single-device on {card}")
    return dict(train_launches=train_launches, eval_launches=eval_launches,
                cli_launches=cli_launches, ms_step=ms, turns=turns,
                grad_worst=grad_worst)


# ---------------------------------------------------------------- phase 10d

# (preset, cp_impl, what): each case's model at full width (C = 512, H = 8,
# T = 2048) with its attention's sequence split over cp ranks held in this
# one process (dist/context.py::LocalExchange)
CP_CASES = (("SASREC-LC", "ring", "causal ring"),
            ("SASREC-LC", "ulysses", "causal Ulysses"),
            ("BERT4REC-LC", "ring", "non-causal ring"),
            ("EasyDGL-LC", "ring", "the two-sweep ring MAU (BiMAU)"))
CP_DEGREES = (2, 4)
# rows a batch, cut from the presets' 32 (SASREC-LC, BERT4REC-LC) and 8
# (EasyDGL-LC) to fit the time limit: the checks and the timed steps
CP_ROWS = 2
# The ring path against the single-device path (the flash or streamed
# kernels) at dropout 0, |cp - single| <= tol * scale: the logits' scale is
# their largest |single| entry, a gradient's that of its leaf (at least 1e-3
# of the model's largest; a key projection's bias, zero in exact
# arithmetic, at the key weight's scale as ZERO_GRAD_LEAF says), the loss
# relative. fp32: fp32 products in both, summed in other orders and, in the
# kernels' backward, by atomics. bf16: the kernels round the probabilities
# (and in the MAU the modulated ones) to bf16 before @V, the ring keeps
# them fp32 (as JAX's ring does), a 2^-8 relative difference on each
# attention output that the bf16 backward carries to the gradients (a
# rehearsal on the H100 measured at most 4.1e-2 of a leaf's scale there,
# 8.1e-6 on the logits, 9.5e-6 on the loss; fp32 5.6e-6 on a gradient).
CP_TOL = {torch.float32: dict(logits=1e-4, loss=1e-5, grads=1e-4),
          torch.bfloat16: dict(logits=1e-3, loss=1e-4, grads=1e-1)}
CP_TIMING_ROUNDS, CP_TIMING_STEPS = 2, 3


def cp_batch(cfg, model, seed, training):
    """A batch of CP_ROWS rows of preset ``cfg`` on the card, its marks
    looked up there where the model reads them."""
    split = synthetic_split_vectorized(num_rows=CP_ROWS,
                                       num_items=cfg.num_items,
                                       seqslen=cfg.seqslen, seed=seed,
                                       with_datetime=True)
    features, labels, _ = next(iter(BatchLoader(
        split, data_mode=model.data_mode, batch_size=CP_ROWS,
        masklen=cfg.masklen, is_training=training).epoch(0)))
    features = to_device(features, "cuda")
    labels = torch.as_tensor(labels, device="cuda")
    table = mark_table_of(cfg)
    if table is not None:
        features = device_marks(features, labels, torch.as_tensor(
            np.asarray(table, np.float32), device="cuda"),
            is_training=training)
    return features, labels


def cp_forward_and_grads(model, eval_batch, train_batch):
    """(logits of the eval batch, loss and gradients of the train batch)
    at dropout 0, under whatever exchange is active."""
    with torch.no_grad():
        logits, _ = model(eval_batch[0], is_training=False)
    loss, grads = loss_and_grads(model, *train_batch)
    return logits.float(), float(loss), {n: g.float()
                                         for n, g in grads.items()}


def cp_grad_errs(got, want):
    """Each leaf's |got - want| over its scale (``CP_TOL``'s rule)."""
    top = max(float(w.abs().max()) for w in want.values())
    errs = {}
    for n, w in want.items():
        ref = n.replace("k.bias", "k.weight") if ZERO_GRAD_LEAF.search(
            n) else n
        scale = max(float(want[ref].abs().max()), 1e-3 * top)
        errs[n] = float((got[n] - w).abs().max()) / scale
    return errs


def cp_case(name, impl, what, seed):
    """Phase 10d's checks of one case in fp32 and bf16 at cp = 2 and 4,
    against the single-device path on the card. Returns the worst errors."""
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = "float32" if dtype == torch.float32 else "bfloat16"
        cfg = preset(name, cp_impl=impl, hidden_dropout_rate=0.0,
                     attention_probs_dropout_rate=0.0, compute_dtype=dname,
                     num_events=64)
        model = build_model(cfg, device="cuda",
                            params=random_flax_params(cfg, seed=0))
        eval_b = cp_batch(cfg, model, seed, False)
        train_b = cp_batch(cfg, model, seed + 1, True)
        ref_logits, ref_loss, ref_grads = cp_forward_and_grads(
            model, eval_b, train_b)
        tol = CP_TOL[dtype]
        for cp in CP_DEGREES:
            with use_seq_exchange(LocalExchange(cp)):
                logits, loss, grads = cp_forward_and_grads(
                    model, eval_b, train_b)
            errs = cp_grad_errs(grads, ref_grads)
            leaf = max(errs, key=errs.get)
            row = dict(
                logits=float((logits - ref_logits).abs().max())
                / float(ref_logits.abs().max()),
                loss=abs(loss - ref_loss) / abs(ref_loss), grads=errs[leaf])
            key = f"{name}_{impl}_cp{cp}_{dname}"
            worst[key] = row
            log(f"  {key}: logits {row['logits']:.3e}, loss "
                f"{row['loss']:.3e} (cp {loss:.6f}, single {ref_loss:.6f}),"
                f" worst gradient {row['grads']:.3e} ({leaf}) of scale")
            for k in ("logits", "loss", "grads"):
                check(math.isfinite(row[k]) and row[k] <= tol[k],
                      f"phase 10d {key}: {k} {row[k]:.3e} > {tol[k]}")
        del model
        torch.cuda.empty_cache()
    return worst


def cp_step_times(name, impl, seed):
    """Faithful bf16 train steps (the preset's dropout) at CP_ROWS rows:
    the single-device step and the cp = 2 and 4 steps in turns. Returns
    (median ms/step by variant, the cp steps' kernel launches)."""
    cfg = preset(name, cp_impl=impl, num_events=64)
    model = build_model(cfg, device="cuda",
                        params=random_flax_params(cfg, seed=0))
    batch = cp_batch(cfg, model, seed, True)
    step = build_train_step(model)
    state = init_state(model)
    gen = torch.Generator(device="cuda").manual_seed(0)
    variants = {"single": None, **{f"cp{cp}": LocalExchange(cp)
                                   for cp in CP_DEGREES}}
    counters = FLASH_KERNELS + (catalog_nll_fwd, catalog_nll_bwd) \
        + STREAMED_KERNELS + (mau_attention, mau_attention_bwd)
    times = {v: [] for v in variants}
    launches = {}
    for rnd in range(CP_TIMING_ROUNDS + 1):      # round 0 warms up
        for v, ex in variants.items():
            for fn in counters:
                fn.launches = 0
            with (use_seq_exchange(ex) if ex else contextlib.nullcontext()):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(CP_TIMING_STEPS):
                    state, loss = step(state, *batch, gen)
                torch.cuda.synchronize()
            if rnd:
                times[v].append((time.perf_counter() - t0)
                                / CP_TIMING_STEPS * 1e3)
            check(math.isfinite(float(loss)), f"{name} {v}: loss")
            if ex is not None:
                launches[v] = {fn.__name__: fn.launches for fn in counters
                               if fn.launches}
                attn = sum(fn.launches for fn in counters
                           if fn not in (catalog_nll_fwd, catalog_nll_bwd))
                check(attn == 0, f"{name} {v}: an attention kernel launched "
                                 f"under context parallelism")
                check(catalog_nll_fwd.launches == CP_TIMING_STEPS,
                      f"{name} {v}: the catalog kernels were not launched")
    del model, state
    torch.cuda.empty_cache()
    return {v: float(np.median(t)) for v, t in times.items()}, launches


def cp_dropout_probe(kind, rate=0.1, t=256, cp=4, seed=5):
    """Uniform probabilities (q = k = 0, every key real) and one-hot values
    (D = T) read the keep mask back on the card: its keep fraction, the
    1 / (1 - rate) rescale and the backward's mask (dv_j = sum_i out_ij
    with a unit cotangent). Returns the keep fraction."""
    b, h = 1, 8
    z = torch.zeros(b, h, t, t, device="cuda")
    v = torch.eye(t, device="cuda").expand(b, h, t, t).clone()
    v.requires_grad_()
    km = torch.ones(b, t, device="cuda")
    fn = ring_attention if kind == "ring" else ulysses_attention

    def gen():
        return torch.Generator(device="cuda").manual_seed(seed)
    out = fn(z, z, v, km, LocalExchange(cp), causal=False, dropout_rate=rate,
             generator=gen())
    out.sum().backward()
    keep = out.detach() * t * (1.0 - rate)
    kept = (keep - 1.0).abs() < 1e-4
    check(bool((kept | (keep.abs() < 1e-4)).all()),
          f"dropout probe {kind}: an entry neither 0 nor rescaled")
    frac = float(kept.float().mean())
    check(abs(frac - (1.0 - rate)) < 0.01,
          f"dropout probe {kind}: keep fraction {frac}")
    dv_want = out.detach().sum(-2)[..., None].expand_as(v)
    check(bool(torch.allclose(v.grad, dv_want, rtol=1e-5, atol=1e-6)),
          f"dropout probe {kind}: the backward's mask is not the forward's")
    again = fn(z, z, v.detach(), km, LocalExchange(cp), causal=False,
               dropout_rate=rate, generator=gen())
    check(bool(torch.equal(again, out.detach())),
          f"dropout probe {kind}: a seed's replay differs")
    return frac


def phase_context(card):
    log("phase 10d: context parallelism on one card: the seq axis's cp = 2 "
        "and 4 ranks' blocks in this process (LocalExchange; the ring and "
        "Ulysses bodies the process-group exchange runs), full width "
        f"(C=512, H=8, T=2048), batches cut to B={CP_ROWS}: logits, loss "
        "and every gradient against the single-device path (the flash / "
        "streamed kernels) at dropout 0, fp32 and bf16; a dropout probe; "
        "faithful bf16 train steps, single-device and cp = 2, 4 in turns, "
        f"on {card}")
    worst, times, launches = {}, {}, {}
    for i, (name, impl, what) in enumerate(CP_CASES):
        log(f"  {name}, {what}:")
        worst.update(cp_case(name, impl, what, seed=600 + 10 * i))
        t, n = cp_step_times(name, impl, seed=605 + 10 * i)
        times[f"{name}_{impl}"] = t
        launches[f"{name}_{impl}"] = n
        log(f"    train step ms (B={CP_ROWS}, bf16, median of "
            f"{CP_TIMING_ROUNDS} turns of {CP_TIMING_STEPS}): "
            + ", ".join(f"{v} {ms:.4f}" for v, ms in t.items())
            + f" on {card}; cp launches " + json.dumps(n))
    fracs = {kind: cp_dropout_probe(kind) for kind in ("ring", "ulysses")}
    log("  dropout probe (rate 0.1, T=256, cp=4): keep fraction "
        + json.dumps(fracs) + ", 0 or 1/(1-rate) everywhere, the backward's"
        " mask the forward's, a seed's replay equal")
    return dict(worst=worst, times=times, launches=launches)


# ---------------------------------------------------------------- phase 11

# raw uid,sid,time triplets: users, catalog, events a user (uniform)
PREP_USERS, PREP_ITEMS, PREP_EVENTS = 20000, 17770, (30, 200)
PREP_HELDOUT = 2000      # validation and test users each
# items kept: those with >= PREP_MIN_SC users (the reference's 100 is for
# Netflix's 100M ratings; these 2.3M keep most of the catalog at 20)
PREP_MIN_SC = 20
PREP_TURNS = 1


def prep_triplets(path, seed):
    """Raw triplets written as a CSV: PREP_USERS users with 30-200 events
    an hour to a day apart (whole seconds) from a start in 2001-2005,
    items drawn with popularity (r + 10)^-0.8 over PREP_ITEMS ids, the
    head spread over the ids. Returns the row count."""
    import pandas as pd
    rng = np.random.default_rng(seed)
    n = rng.integers(PREP_EVENTS[0], PREP_EVENTS[1] + 1, PREP_USERS)
    uid = np.repeat(np.arange(PREP_USERS), n)
    pop = (np.arange(PREP_ITEMS) + 10.0) ** -0.8
    sid = rng.choice(PREP_ITEMS, uid.size, p=pop / pop.sum())
    sid = (sid * 7919 + 13) % PREP_ITEMS
    gaps = rng.integers(3600, 86400, uid.size)
    start = np.repeat(rng.integers(980_000_000, 1_130_000_000, PREP_USERS), n)
    first = np.repeat(np.cumsum(n) - n, n)
    t = start + np.cumsum(gaps) - np.cumsum(gaps)[first]
    write_int_csv(path, ("uid", "sid", "time"), (uid, sid, t))
    return uid.size


def write_int_csv(path, header, columns):
    """Non-negative integer columns as a CSV, each field zero-padded to its
    column's widest value (read back as the same integers): one vectorised
    pass, where pandas' writer takes seconds for millions of rows."""
    parts = []
    for j, col in enumerate(columns):
        col = np.asarray(col, np.int64)
        width = len(str(int(col.max())))
        parts.append((col[:, None] // 10 ** np.arange(width - 1, -1, -1)
                      % 10 + ord("0")).astype(np.uint8))
        parts.append(np.full((col.size, 1), ord(
            "," if j + 1 < len(columns) else "\n"), np.uint8))
    with open(path, "wb") as f:
        f.write((",".join(header) + "\n").encode())
        f.write(np.concatenate(parts, axis=1).tobytes())


def prep_marks(path, num_items, seed):
    rng = np.random.default_rng(seed)
    sid = np.repeat(np.arange(1, num_items), 2)
    import pandas as pd
    pd.DataFrame({"sid": sid, "event": rng.integers(0, 64, sid.size)}
                 ).to_csv(path, index=False)


def loader_ms(ds, cfg, model, use_native):
    """Host ms a train batch of batch assembly over one epoch."""
    ld = BatchLoader(ds, data_mode=model.data_mode,
                     batch_size=cfg.batch_size, masklen=cfg.masklen,
                     is_training=True, use_native=use_native)
    t0 = time.perf_counter()
    n = sum(1 for _ in ld.epoch(0))
    return (time.perf_counter() - t0) / n * 1e3, ld.native


def phase_prep(card):
    log("phase 11: the data-prep path: raw triplets from a seed ("
        f"{PREP_USERS:,} users, a {PREP_ITEMS:,}-item catalog, "
        f"{PREP_EVENTS[0]}-{PREP_EVENTS[1]} events each), cli.prep --raw "
        "and the mark table, then the flagship (EasyDGL, bf16) through "
        "cli.train for one epoch on the packed splits, with the native C++ "
        f"batcher (use_native=True) and the NumPy loader, {PREP_TURNS} "
        f"turn(s) after a warm-up run, on {card}")
    from easydgl_tpu_torch.cli import prep as prep_cli
    from easydgl_tpu_torch.cli import train as train_cli
    from easydgl_tpu_torch.data import native
    from easydgl_tpu_torch.data.etl import mark_table_from_csv
    from easydgl_tpu_torch.train import loop
    cwd, root_handlers = os.getcwd(), list(logging.getLogger().handlers)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_prep_")
    made = []

    class RecordingLoader(BatchLoader):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    out = dict(runs=[])
    try:
        os.chdir(tmp)
        t0 = time.perf_counter()
        rows = prep_triplets("raw.csv", seed=11)
        out["gen_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        n_items = prep_cli.main([
            "--raw", "--fin", "raw.csv", "--fout", "data", "--seqslen", "30",
            "--n_heldout_users", str(PREP_HELDOUT), "--min_sc",
            str(PREP_MIN_SC)])
        out["prep_s"] = time.perf_counter() - t0
        # the marks name the packed ids, known once cli.prep has run; the
        # table as cli.prep --mark_csv writes it
        prep_marks("marks.csv", n_items, seed=12)
        np.save("data/mark.npy", mark_table_from_csv("marks.csv", n_items))
        splits = {s: PackedDataset.load(f"data/{s}.npz")
                  for s in ("train", "validation", "test")}
        log(f"  {rows:,} triplets written in {out['gen_s']:.2f} s; cli.prep "
            f"--raw {out['prep_s']:.2f} s -> num_items {n_items:,}, rows "
            + ", ".join(f"{s} {d.num_rows:,}" for s, d in splits.items()))
        check(splits["train"].num_rows > 10000 and n_items > 10000,
              "cli.prep: too few rows or items survived")
        t0 = time.perf_counter()
        native.load_library(build=True)
        out["build_s"] = time.perf_counter() - t0
        log(f"  native batcher built (g++) into {native.library_path()} in "
            f"{out['build_s']:.2f} s")
        cfg = preset("EasyDGL", num_items=n_items, num_events=64,
                     compute_dtype="bfloat16")
        model = build_model(cfg, device="cuda")
        assembly = {}
        for mode in ("native", "numpy", "native", "numpy"):
            ms, is_native = loader_ms(splits["train"], cfg, model,
                                      mode == "native")
            check(is_native == (mode == "native"), f"loader {mode}: native")
            assembly.setdefault(mode, []).append(ms)
        del model
        argv = ["--model", "EasyDGL", "--data_dir", "data", "--mark",
                "data/mark.npy", "--num_items", str(n_items),
                "--compute_dtype", "bfloat16", "--num_epochs", "1",
                "--device", "cuda"]
        records = LoopRecords()
        loop_log = logging.getLogger(loop.__name__)
        old_level = loop_log.level
        loop_log.addHandler(records)
        loop_log.setLevel(logging.INFO)
        try:
            train_cli.main(argv + ["--native", "off"])   # warm-up
            for turn in range(PREP_TURNS):
                for mode in ("on", "off"):
                    made.clear()
                    for fn in HARNESS_KERNELS.values():
                        fn.launches = 0
                    t0 = time.perf_counter()
                    with patched(loop, "BatchLoader", RecordingLoader):
                        summary = train_cli.main(argv + ["--native", mode])
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    check(len(made) == 3 and all(
                        ld.native == (mode == "on") for ld in made),
                        f"cli.train --native {mode}: loader.native "
                        f"{[ld.native for ld in made]}")
                    check(all(math.isfinite(v) and 0.0 <= v <= 1.0
                              for v in summary.values()),
                          f"cli.train --native {mode}: summary {summary}")
                    launches = {k: fn.launches
                                for k, fn in HARNESS_KERNELS.items()}
                    for k, v in launches.items():
                        check(v > 0, f"cli.train --native {mode}: {k} was "
                                     f"not launched")
                    _, _, secs, ex_s = records.epochs[-1]
                    out["runs"].append(dict(native=mode, turn=turn,
                                            ex_s=ex_s, epoch_s=secs,
                                            wall_s=wall, launches=launches))
                    log(f"  turn {turn}, --native {mode}: {ex_s:.1f} train "
                        f"ex/s ({secs:.3f} s for the epoch of "
                        f"{splits['train'].num_rows:,} rows, loader "
                        f"included), run {wall:.2f} s with eval; launches "
                        + json.dumps(launches))
        finally:
            loop_log.removeHandler(records)
            loop_log.setLevel(old_level)
        out["assembly_ms"] = {k: float(np.median(v))
                              for k, v in assembly.items()}
        log("  host batch assembly, ms a B=512 train batch (median of 2): "
            + ", ".join(f"{k} {v:.4f}" for k, v in out["assembly_ms"].items())
            + f"; cli.train ex/s: native " + ", ".join(
                f"{r['ex_s']:.1f}" for r in out["runs"] if r["native"] == "on")
            + ", numpy " + ", ".join(
                f"{r['ex_s']:.1f}" for r in out["runs"]
                if r["native"] == "off") + f" on {card}")
    finally:
        os.chdir(cwd)
        for h in logging.getLogger().handlers:
            if h not in root_handlers:
                logging.getLogger().removeHandler(h)
                h.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def kernel_names(log_text: str):
    """kernel<dtype, template ints...> of an entry function in a ptxas
    report line."""
    m = re.search(r"(mau_fwd_kernel|mau_fwd_pre_kernel|mau_fwd_post_kernel|"
                  r"mau_bwd_attn|mau_bwd_int_tc|"
                  r"mau_bwd_weights|catalog_kernel|catalog_merge|"
                  r"catalog_fwd_tc_kernel|catalog_bwd_tc_kernel|"
                  r"flash_fwd_tc_kernel|mau_int_fwd_tc_kernel|"
                  r"mau_int_split_kernel|mau_int_round_kernel|"
                  r"mau_stats_tc_kernel|mau_stats_kernel|mau_out_tc_kernel|"
                  r"mau_out_kernel|mau_glam_tc_kernel|"
                  r"mau_glam_kernel|mau_dq_tc_kernel|mau_dq_kernel|"
                  r"mau_dkvt_tc_kernel|mau_dkvt_kernel|"
                  r"mau_int_bwd_rows_tc_kernel|mau_int_bwd_cols_tc_kernel|"
                  r"flash_fwd_kernel|flash_bwd_tc_kernel|flash_bwd_kernel|"
                  r"flash_wide_fwd_tc_kernel|flash_wide_bwd_tc_kernel|"
                  r"flash_wide_fwd_kernel|flash_wide_bwd_kernel)"
                  r"(I?\w*)",
                  log_text)
    if not m:
        return None
    rest = m.group(2)
    args = (["bf16"] if "bfloat16" in rest else
            ["fp32"] if rest.startswith("If") else [])
    args += re.findall(r"L[ib](\d+)E", rest)
    return f"{m.group(1)}<{', '.join(args)}>"


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    log("phase 1: device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    card = smi[0]
    log(card)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    log("phase 2: build")
    sources = ["mau_attention_fwd", "mau_attention_bwd", "catalog_nll",
               "mau_streamed_fwd", "mau_streamed_bwd", "flash_attention",
               "flash_wide"]
    seconds = build.build(sources)
    for name, s in seconds.items():
        log(f"  {name}: nvcc {s:.1f} s")
        report = (build.BUILD_DIR / f"{name}.log").read_text().splitlines()
        for line in report:
            if "Compiling entry function" in line:
                log(f"    {kernel_names(line) or line.strip()}:")
            if "registers" in line or "spill" in line:
                log("      " + line.split(":", 1)[-1].strip())

    errs = phase_kernel_checks()
    bwd_errs = phase_bwd_checks()
    cat_errs = phase_catalog_checks()
    streamed_errs = phase_streamed_checks()
    streamed_bwd_errs = phase_streamed_bwd_checks()
    flash_errs = phase_flash_checks()
    timing = phase_kernel_timing()
    train_timing = phase_train_kernel_timing()
    streamed_timing = phase_streamed_timing(
        "phase 4c: streamed MAU kernels at the EasyDGL-LC eval shape "
        "(B=8, T=2048, H=8, dh=64, E=64, BiMAU)", LC, causal=False,
        seed=400)
    streamed_timing.update(phase_streamed_bwd_timing(
        "phase 4d: streamed MAU backward kernels at the EasyDGL-LC train "
        "shape (B=8, T=2048, H=8, dh=64, E=64, BiMAU, dropout 0.1)", LC,
        causal=False, seed=700))
    flash_timing = phase_flash_timing()
    flash_nc_timing = phase_flash_noncausal_timing()
    wide_timing = phase_wide_flash_timing()
    catalog_lc_timing = phase_catalog_lc_timing()
    ctsma_timing = phase_ctsma_kernel_timing()
    ctsma_lc_timing = phase_streamed_timing(
        "phase 4c (CTSMA-LC): the streamed MAU forward kernels causal at "
        "the CTSMA-LC shape (B=8, T=2048, H=8, dh=64, E=64, bf16; a CTSMA-LC"
        " batch's left-padded key mask and spans)", CTSMA_LC, causal=True,
        seed=410, batch="CTSMA-LC", dtypes=(torch.bfloat16,))
    ctsma_lc_timing.update(phase_streamed_bwd_timing(
        "phase 4d (CTSMA-LC): the streamed MAU backward kernels causal at "
        "the CTSMA-LC shape, dropout 0.1", CTSMA_LC, causal=True, seed=410,
        batch="CTSMA-LC", dtypes=(torch.bfloat16,)))
    serve_launches, batch, table = phase_slice()
    phase_slice_cpu_vs_card(batch, table)
    lc_launches, lc_batch, lc_table, lc_seqs_s, lc_lat = phase_lc_slice()
    phase_lc_cpu_vs_card(lc_batch, lc_table)
    train_launches, ms_step, ex_s = phase_train()
    log("phase 8: full-width fp32 train step, card (kernels) vs CPU "
        "(plain), 8 rows, dropout 0")
    phase_train_cpu_vs_card()
    lc_train_launches, lc_ms_step, lc_ex_s = phase_lc_train()
    log("phase 8b: full-width fp32 EasyDGL-LC train step, card (streamed "
        "kernels) vs CPU (blocked plain version, _MauBlocked), 2 rows, "
        "dropout 0")
    phase_train_cpu_vs_card("EasyDGL-LC", rows=2, device_floor=True,
                            compute_dtype="float32")
    log("phase 5c: SASREC-LC eval + serving at full width on the card "
        "(B=32, L=2048, C=512, H=8, 2 blocks, bf16, flash kernels)")
    sas_launches, sas_batch, sas_seqs_s, sas_lat = phase_model_slice(
        "SASREC-LC", 14)
    log("phase 6c: full-width fp32 SASREC-LC, card (flash kernels) vs CPU "
        "(plain flash version), 2 rows")
    phase_model_cpu_vs_card("SASREC-LC", sas_batch)
    log("phase 7c: SASREC-LC faithful train steps at full width on the card "
        "(B=32, L=2048, C=512, H=8, 2 blocks, bf16, dropout 0.1 / 0.1, "
        "softmax-eps over every position, TF-Adam, flash and catalog "
        "kernels)")
    sas_train_launches, sas_ms_step, sas_ex_s = phase_model_train(
        "SASREC-LC", 16, FLASH_TRAIN_STEPS, FLASH_REPEAT_STEPS)
    log("phase 8c: full-width fp32 SASREC-LC train step, card (flash "
        "kernels) vs CPU (plain flash version, _FlashAttention), 2 rows, "
        "dropout 0")
    phase_train_cpu_vs_card("SASREC-LC", rows=2, device_floor=True,
                            compute_dtype="float32")
    log("phase 5d: BERT4REC-LC eval + serving at full width on the card "
        "(B=32, L+1=2048, C=512, H=8, 2 blocks, bf16, the masked protocol's"
        " MASK in the last position, non-causal flash kernels)")
    b4lc_launches, b4lc_batch, b4lc_seqs_s, b4lc_lat = phase_model_slice(
        "BERT4REC-LC", 17)
    log("phase 6d: full-width fp32 BERT4REC-LC, card (flash kernels) vs CPU "
        "(plain flash version), 2 rows")
    phase_model_cpu_vs_card("BERT4REC-LC", b4lc_batch)
    log("phase 7d: BERT4REC-LC faithful train steps at full width on the "
        "card (B=32, L+1=2048, masklen 256, bf16, dropout 0.1 / 0.1, "
        "sparse_ce over the masked positions, L2, TF-Adam, non-causal flash "
        "and catalog kernels at N=8,192, V=17,773)")
    b4lc_train_launches, b4lc_ms_step, b4lc_ex_s = phase_model_train(
        "BERT4REC-LC", 19, FLASH_TRAIN_STEPS, FLASH_REPEAT_STEPS)
    log("phase 8d: full-width fp32 BERT4REC-LC train step, card (flash "
        "kernels) vs CPU (plain flash version, _FlashAttention), 2 rows, "
        "dropout 0")
    phase_train_cpu_vs_card("BERT4REC-LC", rows=2, device_floor=True,
                            compute_dtype="float32")
    log("phase 5e: BERT4REC eval + serving at full width on the card "
        "(PRESETS[\"BERT4REC\"]: B=512, L+1=31, C=512, H=8, 3 blocks, bf16,"
        " the xla attention core: no kernel on the served path)")
    _, _, b4_seqs_s, b4_lat = phase_model_slice(
        "BERT4REC", 20, compute_dtype="bfloat16")
    log("phase 7e: BERT4REC faithful train steps at full width on the card "
        "(B=512, masklen 6, bf16, dropout 0.2 / 0.2, sparse_ce, L2, "
        "TF-Adam, catalog kernels at N=3,072, V=17,773)")
    b4_train_launches, b4_ms_step, b4_ex_s = phase_model_train(
        "BERT4REC", 22, BERT4REC_TRAIN_STEPS, BERT4REC_REPEAT_STEPS,
        compute_dtype="bfloat16")
    log("phase 8e: full-width fp32 BERT4REC train step, card (catalog "
        "kernels) vs CPU (plain), 8 rows, dropout 0")
    phase_train_cpu_vs_card("BERT4REC", rows=8)
    log("phase 5f: CTSMA eval + serving at full width on the card "
        "(PRESETS[\"CTSMA\"]: B=512, L=30, C=512, H=4 (dh=128), 2 causal "
        "MAU blocks, E=64, bf16, the fused kernels, marks on the device)")
    ctsma_launches, ctsma_batch, ctsma_seqs_s, ctsma_lat = phase_model_slice(
        "CTSMA", 24, num_events=64, compute_dtype="bfloat16")
    log("phase 6f: full-width fp32 CTSMA, card (fused kernels) vs CPU "
        "(plain version), 8 rows")
    phase_model_cpu_vs_card("CTSMA", ctsma_batch, rows=8, num_events=64)
    log("phase 7f: CTSMA faithful train steps at full width on the card "
        "(B=512, L=30, bf16, dropout 0.1 / 0.2, softmax-eps over every "
        "position, TPP + L2, TF-Adam, the fused MAU kernels causal at dh=128"
        " and the catalog kernels at N=15,360)")
    ctsma_train_launches, ctsma_ms_step, ctsma_ex_s = phase_model_train(
        "CTSMA", 26, TRAIN_STEPS, REPEAT_STEPS, num_events=64,
        compute_dtype="bfloat16")
    log("phase 8f: full-width fp32 CTSMA train step, card (fused kernels) vs"
        " CPU (plain), 8 rows, dropout 0")
    phase_train_cpu_vs_card("CTSMA", rows=8)
    log("phase 5g: CTSMA-LC eval + serving at full width on the card "
        "(B=8, L=2048, C=512, H=8, 1 causal MAU block, E=64, bf16, the "
        "streamed kernels)")
    ctlc_launches, ctlc_batch, ctlc_seqs_s, ctlc_lat = phase_model_slice(
        "CTSMA-LC", 27, num_events=64)
    log("phase 6g: full-width fp32 CTSMA-LC, card (streamed kernels) vs CPU "
        "(blocked plain version), 2 rows")
    phase_model_cpu_vs_card("CTSMA-LC", ctlc_batch, rows=2, num_events=64)
    log("phase 7g: CTSMA-LC faithful train steps at full width on the card "
        "(B=8, L=2048, bf16, dropout 0.1 / 0.1, softmax-eps over every "
        "position, TPP + L2, TF-Adam, the seven streamed kernels causal and "
        "the catalog kernels at N=16,384)")
    ctlc_train_launches, ctlc_ms_step, ctlc_ex_s = phase_model_train(
        "CTSMA-LC", 29, LC_TRAIN_STEPS, LC_REPEAT_STEPS, num_events=64)
    log("phase 8g: full-width fp32 CTSMA-LC train step, card (streamed "
        "kernels) vs CPU (blocked plain version, _MauBlocked), 2 rows, "
        "dropout 0")
    phase_train_cpu_vs_card("CTSMA-LC", rows=2, device_floor=True,
                            compute_dtype="float32")
    new_paths = {}
    for name, (tag, seed, what) in RECURRENT_AND_INTERVAL.items():
        log(f"phase 5{tag}: {name} eval + serving at full width on the card "
            f"(PRESETS[\"{name}\"]: {what}, bf16; no kernel on the served "
            f"path)")
        _, first, seqs_s, lat = phase_model_slice(
            name, seed, compute_dtype="bfloat16")
        log(f"phase 6{tag}: full-width fp32 {name}, card vs CPU, 8 rows")
        phase_model_cpu_vs_card(name, first, rows=8)
        if name == "TiSASREC":
            log("phase 6j': TiSASREC's interval buckets of whole-day stamps "
                "at the preset's shape on the card and the CPU; fp32 logits "
                "of 8 such rows, card vs CPU, both interval forms; the "
                "factored form against the dense one on the card (B=512, "
                "L=30, timelen 256), one forward at dropout 0")
            days = phase_day_boundary_buckets()
            for impl in ("xla", "factored"):
                phase_model_cpu_vs_card(name, days, rows=8,
                                        attention_impl=impl)
            phase_model_cpu_vs_card(
                name, first, rows=first[0]["seqs_i"].shape[0],
                sides=(("cuda", dict(attention_impl="factored")),
                       ("cuda", dict(attention_impl="xla"))))
        log(f"phase 7{tag}: {name} faithful train steps at full width on the"
            f" card (B=512, bf16, the preset's dropout, " + TRAIN_WHAT.get(
                name, "softmax-eps over every position, L2, TF-Adam, the "
                "catalog kernels at N=15,360") + ")")
        model_launches, model_ms, model_ex_s = phase_model_train(
            name, seed + 2, TRAIN_STEPS, REPEAT_STEPS,
            compute_dtype="bfloat16")
        log(f"phase 8{tag}: full-width fp32 {name} train step, card (catalog"
            f" kernels) vs CPU (plain), 8 rows, dropout 0")
        phase_train_cpu_vs_card(name, rows=8)
        new_paths[name] = dict(launches=model_launches, seqs_s=seqs_s,
                               lat=lat, ms_step=model_ms, ex_s=model_ex_s,
                               bs=512)
        if name == "TimelyREC":
            new_paths["TimelyREC_flash"] = phase_timelyrec_flash(first)
    log("phase 5o: EasyDGL-LC with gather_queries=True at full width on the"
        " card (B=8, L+1=2048, C=512, H=8, 1 BiMAU block, E=64, bf16): the"
        " block's MAU for the gathered rows alone, through the materialised"
        " chain as in JAX (no kernel): eval + recommend")
    gq = dict(gather_queries=True)
    gq_serve, _, gq_seqs_s, gq_lat = phase_model_slice(
        "EasyDGL-LC", 52, num_events=64, **gq)
    log("phase 7o: EasyDGL-LC gather_queries faithful train steps (masklen "
        "256, dropout 0.1 / 0.1, TPP + L2, TF-Adam, the catalog kernels at "
        "N=2,048)")
    gq_launches, gq_ms, gq_ex_s = phase_model_train(
        "EasyDGL-LC", 54, LC_TRAIN_STEPS, LC_REPEAT_STEPS, num_events=64,
        **gq)
    log("phase 8o: full-width fp32 EasyDGL-LC gather_queries train step, "
        "card vs CPU, 2 rows, dropout 0")
    phase_train_cpu_vs_card("EasyDGL-LC", rows=2, compute_dtype="float32",
                            **gq)
    new_paths["EasyDGL_LC_gathered"] = dict(
        serve_launches=gq_serve, launches=gq_launches, seqs_s=gq_seqs_s,
        lat=gq_lat, ms_step=gq_ms, ex_s=gq_ex_s, bs=8)
    bochner = {name: phase_bochner(name, *spec)
               for name, spec in BOCHNER.items()}
    harness = phase_harness(card, ex_s)
    shard_errs, shard_timing_rows = phase_shard_checks()
    sharded = phase_sharded(card, ms_step)
    context = phase_context(card)
    prep = phase_prep(card)

    csrc = "easydgl_tpu_torch/kernels/csrc/"
    bf16 = torch.bfloat16
    main_row = timing[bf16]
    gathered = new_paths["EasyDGL_LC_gathered"]
    fused_per_path = {
        "serving_sharded_1x1": sharded["eval_launches"],
        "training_sharded_1x1": sharded["train_launches"]["mau_attention"],
        "harness_sharded_1x1":
            sharded["cli_launches"]["mau_attention_fwd"],
        "serving": serve_launches,
        "training": train_launches["mau_attention"],
        "serving_ctsma": ctsma_launches["mau_attention"],
        "training_ctsma": ctsma_train_launches["mau_attention"],
        "harness": harness["launches"]["mau_attention_fwd"],
        # the gathered long-context rows take the materialised chain
        "serving_easydgl_lc_gathered":
            gathered["serve_launches"]["mau_attention"],
        "training_easydgl_lc_gathered":
            gathered["launches"]["mau_attention"]}
    for run in prep["runs"]:   # phase 11: cli.train on cli.prep's splits
        key = f"harness_prep_native_{run['native']}"
        fused_per_path[key] = (fused_per_path.get(key, 0)
                               + run["launches"]["mau_attention_fwd"])
    kernels = [dict(
        name="mau_attention_fwd", route="cuda",
        source=csrc + "mau_attention_fwd.cu",
        replaces="easydgl_tpu/kernels/mau_attention.py:690",
        launches=sum(fused_per_path.values()),
        launches_per_path=fused_per_path,
        max_abs_err=errs["bimau_bf16_flagship"], ms=main_row["ms"],
        plain_ms=main_row["plain_ms"], bound_ms=main_row["bound_ms"],
        bound_by=main_row["bound_by"], library_ms=None,
        sigmoid_form=main_row["sigmoid_form"],
        by_kernel=main_row["by_kernel"],
        ctsma_shape=ctsma_timing["mau_attention_fwd"])]
    # rows 4-6 (the catalog backward's three TPU kernels) are one wrapper
    for name, source, replaces, err in (
            ("mau_attention_bwd", "mau_attention_bwd.cu",
             "easydgl_tpu/kernels/mau_attention.py:757",
             bwd_errs["bimau_bf16_drop"]),
            ("catalog_nll_fwd", "catalog_nll.cu",
             "easydgl_tpu/kernels/scoring.py:84",
             cat_errs["flagship_bf16"][0])) + tuple(
            ("catalog_nll_bwd", "catalog_nll.cu",
             f"easydgl_tpu/kernels/scoring.py:{line}",
             cat_errs["flagship_bf16"][1]) for line in (292, 323, 343)):
        row = train_timing[(name, bf16)]
        per_path = {"training": train_launches[name],
                    "training_ctsma": ctsma_train_launches[name],
                    "harness": harness["launches"][name],
                    "training_sharded_1x1":
                        sharded["train_launches"][name],
                    "harness_sharded_1x1": sharded["cli_launches"][name]}
        if name == "mau_attention_bwd":
            per_path["training_easydgl_lc_gathered"] = \
                gathered["launches"][name]
        for run in prep["runs"]:
            key = f"harness_prep_native_{run['native']}"
            per_path[key] = per_path.get(key, 0) + run["launches"][name]
        if name != "mau_attention_bwd":   # phase 10d's cp train steps
            for case, by_cp in context["launches"].items():
                per_path[f"training_cp_{case.lower()}"] = sum(
                    n.get(name, 0) for n in by_cp.values())
        if name != "mau_attention_bwd":
            per_path["training_lc"] = lc_train_launches[name]
            per_path["training_sasrec_lc"] = sas_train_launches[name]
            per_path["training_bert4rec"] = b4_train_launches[name]
            per_path["training_bert4rec_lc"] = b4lc_train_launches[name]
            per_path["training_ctsma_lc"] = ctlc_train_launches[name]
            for model_name, res in new_paths.items():
                per_path[f"training_{model_name.lower()}"] = \
                    res["launches"][name]
            for model_name, res in bochner.items():
                per_path[f"training_{model_name.lower()}"] = \
                    res["launches"][name]
                per_path[f"training_{model_name.lower()}_flash_l2048"] = \
                    res["lc_train_launches"][name]
        entry = dict(name=name, route="cuda", source=csrc + source,
                     replaces=replaces, launches=sum(per_path.values()),
                     launches_per_path=per_path, max_abs_err=err,
                     ms=row["ms"], plain_ms=row["plain_ms"],
                     bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                     library_ms=None,
                     **{key: row[key] for key in ("by_kernel",) if key in row})
        if name == "catalog_nll_bwd":
            entry["sasrec_lc_shape"] = {
                k: measured(catalog_lc_timing[k]) for k in (
                    "all_live", "sasrec_lc_padded")}
            entry["bert4rec_lc_shape"] = measured(
                catalog_lc_timing["bert4rec_lc_masked"])
        if name == "mau_attention_bwd":
            entry["ctsma_shape"] = ctsma_timing[name]
        if name != "mau_attention_bwd":
            entry["tgrec_c50_max_abs_err"] = cat_errs["tgrec_c50_bf16"][
                0 if name == "catalog_nll_fwd" else 1]
            entry["grec_untied_max_abs_err"] = cat_errs["grec_bf16_untied"][
                0 if name == "catalog_nll_fwd" else 1]
        if name == "catalog_nll_fwd":
            entry["gemm_ms_for_scale"] = row["gemm_ms"]
            entry["sasrec_lc_shape"] = measured(catalog_lc_timing["forward"])
            entry["bert4rec_lc_shape"] = measured(
                catalog_lc_timing["bert4rec_lc_forward"])
        kernels.append(entry)
    for fn in STREAMED_KERNELS:
        name = fn.__name__
        row = streamed_timing[(name, bf16)]
        forward = fn in STREAMED
        gathered = new_paths["EasyDGL_LC_gathered"]
        per_path = {"training_lc": lc_train_launches[name],
                    "training_ctsma_lc": ctlc_train_launches[name],
                    "training_easydgl_lc_gathered":
                        gathered["launches"][name]}
        if forward:
            per_path["serving_lc"] = lc_launches[name]
            per_path["serving_ctsma_lc"] = ctlc_launches[name]
            per_path["serving_easydgl_lc_gathered"] = \
                gathered["serve_launches"][name]
        entry = dict(
            name=name, route="cuda",
            source=csrc + ("mau_streamed_fwd.cu" if forward
                           else "mau_streamed_bwd.cu"),
            replaces=STREAMED_REPLACES[name],
            launches=sum(per_path.values()), launches_per_path=per_path,
            max_abs_err=(streamed_errs["lc_bimau_bf16"][name] if forward
                         else streamed_bwd_errs["lc_bimau_bf16_drop"][name]),
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=None,
            ctsma_lc_causal_shape=measured(ctsma_lc_timing[(name, bf16)]),
            **{key: row[key] for key in ("ms_dropout_0_1",) if key in row})
        if forward:
            entry["sdpa_ms_for_scale"] = row["sdpa_ms"]
        kernels.append(entry)
    for name, replaces in FLASH_REPLACES:
        row = flash_timing[(name, bf16)]
        per_path = {"training_sasrec_lc": sas_train_launches[name],
                    "training_bert4rec_lc": b4lc_train_launches[name]}
        if name == "flash_attention_fwd":
            per_path["serving_sasrec_lc"] = sas_launches[name]
            per_path["serving_bert4rec_lc"] = b4lc_launches[name]
        for model_name, res in bochner.items():
            key = f"{model_name.lower()}_flash_l2048"
            per_path[f"training_{key}"] = res["lc_train_launches"][name]
            if name == "flash_attention_fwd":
                per_path[f"serving_{key}"] = res["lc_launches"][name]
        timely = new_paths["TimelyREC_flash"]
        per_path["training_timelyrec_flash"] = timely["launches"][name]
        if name == "flash_attention_fwd":
            per_path["serving_timelyrec_flash"] = \
                timely["serve_launches"][name]
        kernels.append(dict(
            name=name, route="cuda", source=csrc + "flash_attention.cu",
            wide_source=csrc + "flash_wide.cu",
            replaces=replaces, launches=sum(per_path.values()),
            launches_per_path=per_path,
            max_abs_err=flash_errs["lc_causal_bf16_drop"][name][0],
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            ms_dropout_0_1=row["ms_dropout"],
            non_causal_bert4rec_lc=flash_nc_timing[name],
            tgat_wide_shape=wide_timing[("tgat", name)],
            tgrec_wide_shape=wide_timing[("tgrec", name)],
            wide_errs={case: dict(zip(("max_abs_err", "worst_over_tol"),
                                      flash_errs[case][name]))
                       for case in FLASH_WIDE_REPORTED},
            **{key: row[key] for key in ("library_covers",) if key in row}))
    log(f"EasyDGL-LC serving: {lc_seqs_s:.1f} eval seqs/s, recommend "
        + ", ".join(f"{x * 1e3:.3f}" for x in lc_lat)
        + f" ms per B=8 batch on {card}")
    log(f"train: {ms_step:.4f} ms/step, {ex_s:.1f} ex/s at B=512 on {card}")
    log(f"EasyDGL-LC train: {lc_ms_step:.4f} ms/step, {lc_ex_s:.1f} ex/s at"
        f" B=8, L+1=2048 on {card}")
    log(f"SASREC-LC serving: {sas_seqs_s:.1f} eval seqs/s, recommend "
        + ", ".join(f"{x * 1e3:.3f}" for x in sas_lat)
        + f" ms per B=32 batch on {card}")
    log(f"SASREC-LC train: {sas_ms_step:.4f} ms/step, {sas_ex_s:.1f} ex/s at"
        f" B=32, L=2048 on {card}")
    log(f"BERT4REC-LC serving: {b4lc_seqs_s:.1f} eval seqs/s, recommend "
        + ", ".join(f"{x * 1e3:.3f}" for x in b4lc_lat)
        + f" ms per B=32 batch on {card}")
    log(f"BERT4REC-LC train: {b4lc_ms_step:.4f} ms/step, {b4lc_ex_s:.1f}"
        f" ex/s at B=32, L+1=2048 on {card}")
    log(f"BERT4REC serving: {b4_seqs_s:.1f} eval seqs/s, recommend "
        + ", ".join(f"{x * 1e3:.3f}" for x in b4_lat)
        + f" ms per B=512 batch on {card}")
    log(f"BERT4REC train: {b4_ms_step:.4f} ms/step, {b4_ex_s:.1f} ex/s at"
        f" B=512 on {card}")
    log(f"CTSMA serving: {ctsma_seqs_s:.1f} eval seqs/s, recommend "
        + ", ".join(f"{x * 1e3:.3f}" for x in ctsma_lat)
        + f" ms per B=512 batch on {card}")
    log(f"CTSMA train: {ctsma_ms_step:.4f} ms/step, {ctsma_ex_s:.1f} ex/s at"
        f" B=512 on {card}")
    log(f"CTSMA-LC serving: {ctlc_seqs_s:.1f} eval seqs/s, recommend "
        + ", ".join(f"{x * 1e3:.3f}" for x in ctlc_lat)
        + f" ms per B=8 batch on {card}")
    log(f"CTSMA-LC train: {ctlc_ms_step:.4f} ms/step, {ctlc_ex_s:.1f} ex/s at"
        f" B=8, L=2048 on {card}")
    for model_name, res in new_paths.items():
        log(f"{model_name} serving: {res['seqs_s']:.1f} eval seqs/s,"
            f" recommend " + ", ".join(f"{x * 1e3:.3f}" for x in res["lat"])
            + f" ms per B={res['bs']} batch on {card}")
        log(f"{model_name} train: {res['ms_step']:.4f} ms/step,"
            f" {res['ex_s']:.1f} ex/s at B={res['bs']} on {card}")
    for model_name, res in bochner.items():
        bs = preset(model_name).batch_size
        log(f"{model_name} serving: {res['seqs_s']:.1f} eval seqs/s,"
            f" recommend " + ", ".join(f"{x * 1e3:.3f}" for x in res["lat"])
            + f" ms per B={bs} batch on {card}")
        log(f"{model_name} train: {res['ms_step']:.4f} ms/step,"
            f" {res['ex_s']:.1f} ex/s at B={bs} on {card}")
        log(f"{model_name} flash L=2048 serving: {res['lc_seqs_s']:.1f} eval"
            f" seqs/s, recommend " + ", ".join(
                f"{x * 1e3:.3f}" for x in res["lc_lat"])
            + f" ms per B=8 batch; train {res['lc_ms_step']:.4f} ms/step,"
            f" {res['lc_ex_s']:.1f} ex/s on {card}")
    log(f"harness: {harness['ex_s']:.1f} train ex/s through cli.train, loader"
        f" included ({harness['epoch_s']:.4f} s an epoch of 8 steps at B=512),"
        f" beside phase 7's {ex_s:.1f} with batches on the device; checkpoint"
        f" save {harness['save_s']:.4f} s, {harness['save_bytes']:,} bytes on"
        f" {card}")
    shard_check_of = {"mau_attention_fwd": "mau", "mau_attention_bwd": "mau",
                      "catalog_nll_fwd": "catalog",
                      "catalog_nll_bwd": "catalog",
                      "flash_attention_fwd": "flash",
                      "flash_attention_bwd": "flash"}
    for entry in kernels:
        entry["cuda_kernels"] = CUDA_KERNELS[entry["name"]]
        part = shard_check_of.get(entry["name"])
        if part is not None:   # phase 10a: one shard's kernel at mp = 2, 4
            entry["shard_shapes"] = {
                f"mp{mp}": shard_timing_rows[mp][entry["name"]]
                for mp in SHARD_MPS}
            entry["shard_max_abs_err"] = {
                k: v for k, v in shard_errs.items() if k.startswith(part)}
        if entry["name"] in HARNESS_KERNELS:
            entry["harness_profiler_launches"] = {
                k: harness["profiler"].get(k, 0)
                for k in CUDA_KERNELS[entry["name"]]}
    log(f"sharded (1, 1) train through NCCL: {sharded['ms_step']:.4f} "
        f"ms/step beside phase 7's {ms_step:.4f} single-device (in turns: "
        f"single {sharded['turns']['single']}, sharded "
        f"{sharded['turns']['sharded']}); fp32 "
        f"gradients within {sharded['grad_worst']:.3e} of each leaf's scale"
        f" on {card}")
    for case, t in context["times"].items():
        log(f"{case} train step (B={CP_ROWS}, bf16): " + ", ".join(
            f"{v} {ms:.4f} ms" for v, ms in t.items()) + f" on {card}")
    log("context parallelism vs the single-device path, worst of logits / "
        "loss / gradients: " + json.dumps(
            {k: max(v.values()) for k, v in context["worst"].items()}))
    log(f"prep: cli.prep --raw {prep['prep_s']:.2f} s; batch assembly "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in
                    prep["assembly_ms"].items())
        + "; cli.train ex/s " + ", ".join(
            f"native {r['native']} {r['ex_s']:.1f}" for r in prep["runs"])
        + f" on {card}")
    t_end = time.perf_counter()
    log("seconds by phase: " + json.dumps(phase_seconds(t_end)))
    log(f"total {t_end - t_start:.1f} s on {card}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
