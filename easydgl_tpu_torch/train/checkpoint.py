"""Checkpoints of the train state (port of ``easydgl_tpu.train.checkpoint``).

Replaces tf.train.Saver(max_to_keep=1) saved on validation improvement
(reference src/util.py:26,49,53-55); the JAX package uses orbax's manager.
A checkpoint is one ``torch.save`` file, ``step_<n>.pt``, holding the
parameters, the optimizer state and the step, all on the CPU. It is written
to a temporary file and renamed, so a reader never finds half a file, and
only the newest ``max_to_keep`` stay.

``restore`` copies into the template's own tensors: the port's
``TrainState.params`` are the model's parameters, updated in place by the
step (train/steps.py), so a restore that rebound the dict would leave the
model with its old weights.
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import torch

from easydgl_tpu_torch.train.steps import TrainState

_NAME = re.compile(r"step_(\d+)\.pt$")


def _cpu(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in tensors.items()}


@torch.no_grad()
def _copy_into(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor],
               what: str) -> None:
    if set(dst) != set(src):
        raise ValueError(
            f"checkpoint {what} do not match the template: missing "
            f"{sorted(set(dst) - set(src))}, unexpected "
            f"{sorted(set(src) - set(dst))}")
    for k, t in dst.items():
        if t.shape != src[k].shape:
            raise ValueError(f"checkpoint {what} {k}: shape "
                             f"{tuple(src[k].shape)}, template "
                             f"{tuple(t.shape)}")
        t.copy_(src[k])


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 1):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def steps(self) -> List[int]:
        """The steps of the checkpoints on disk, oldest first."""
        found = (_NAME.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, step: Optional[int] = None):
        step = int(state.step) if step is None else step
        opt = state.opt_state
        payload = {
            "params": _cpu(state.params),
            "opt_state": {"type": type(opt).__name__, **{
                k: _cpu(v) if isinstance(v, dict) else v
                for k, v in opt._asdict().items()}},
            "step": int(state.step)}
        path = self.path(step)
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self.path(old))

    def restore(self, template: TrainState,
                step: Optional[int] = None) -> TrainState:
        """The checkpoint of ``step`` (default the latest), copied into the
        template's tensors where they lie; raises if a name or a shape
        differs."""
        step = self.latest_step() if step is None else step
        payload = torch.load(self.path(step), map_location="cpu",
                             weights_only=True)
        _copy_into(template.params, payload["params"], "params")
        opt, saved = template.opt_state, payload["opt_state"]
        if saved["type"] != type(opt).__name__:
            raise ValueError(f"checkpoint optimizer state {saved['type']}, "
                             f"template {type(opt).__name__}")
        fields = {}
        for k, v in opt._asdict().items():
            if isinstance(v, dict):
                _copy_into(v, saved[k], f"opt_state.{k}")
                fields[k] = v
            else:
                fields[k] = saved[k]
        return TrainState(template.params, type(opt)(**fields),
                          payload["step"])
