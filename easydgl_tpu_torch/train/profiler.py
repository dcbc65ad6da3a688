"""Tracing, throughput timing and failure detection (port of
``easydgl_tpu.train.profiler``).

* ``trace`` — a ``torch.profiler`` trace of a span of steps, written as a
  Chrome / TensorBoard trace (CPU activity, and the card's where there is
  one);
* ``StepTimer`` — wall-clock throughput over committed steps; the
  ``blocker`` is waited for on its device before the clock is read;
* ``NanGuard`` — NaN/Inf loss screening, one host sync every ``every``
  steps (generalizes the reference's NaN-loss abort, util.py:29-30);
* ``grad_norms`` — per-top-level-key gradient norms of the flax-layout
  tree, keyed as the JAX package keys it.
"""
from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, Iterator

import numpy as np
import torch

from easydgl_tpu_torch.parity import torch_to_flax

log = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the span; the trace lands in ``logdir`` when it ends
    (viewable in TensorBoard or chrome://tracing). Yields the profiler,
    whose ``key_averages()`` sum the time by kernel."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def _wait_for(blocker) -> None:
    tensors = blocker if isinstance(blocker, (list, tuple)) else [blocker]
    for t in tensors:
        if t.is_cuda:
            torch.cuda.synchronize(t.device)


class StepTimer:
    """Wall-clock throughput over committed steps (excludes compile)."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self.reset()

    def reset(self):
        self._t0 = None
        self.steps = 0

    def start(self):
        self._t0 = time.perf_counter()
        self.steps = 0

    def tick(self, n: int = 1):
        self.steps += n

    def examples_per_sec(self, blocker=None) -> float:
        """``blocker``: a tensor (or a list of them) whose device is
        synchronised first, so that the time covers the work queued."""
        if blocker is not None:
            _wait_for(blocker)
        dt = time.perf_counter() - self._t0
        return self.steps * self.batch_size / max(dt, 1e-9)


class NanGuard:
    """Streaming NaN/Inf detector over losses.

    check() is cheap (a host sync of one scalar every ``every`` steps);
    raises FloatingPointError so the loop can checkpoint-abort.
    """

    def __init__(self, every: int = 50):
        self.every = every
        self._n = 0

    def check(self, loss) -> None:
        self._n += 1
        if self._n % self.every:
            return
        v = float(loss.item() if isinstance(loss, torch.Tensor) else loss)
        if not np.isfinite(v):
            raise FloatingPointError(
                f"non-finite loss {v} at step {self._n}")


def grad_norms(grads: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Per-top-level-key gradient norms of ``grads`` (name -> tensor, as
    ``loss_and_grads`` gives them) in the flax layout (``torch_to_flax``),
    as the JAX package's ``grad_norms`` gives them for the same tree."""
    out: Dict[str, float] = {}
    for top, tree in torch_to_flax(grads).items():
        stack = [tree]
        while stack:
            node = stack.pop()
            if isinstance(node, dict):
                stack.extend(node.values())
            else:
                out[top] = out.get(top, 0.0) + float(
                    np.sum(np.square(node)))
    return {k: float(np.sqrt(v)) for k, v in out.items()}
