"""Optimizers (port of ``easydgl_tpu.train.optim``).

* ``adam`` — tf.train.AdamOptimizer's EXACT update (the reference default,
  Base.py:142-144): the bias corrections act as a scalar on the learning
  rate, ``lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)``, and eps is added to the
  UNcorrected ``sqrt(v_t)``. ``torch.optim.Adam`` (like optax.adam) adds eps
  to the corrected root, an effective eps ~32x smaller at t = 1, so it is
  not this optimizer. Optional global-norm clipping first (``clip_norm``).
* ``adamw_warmup`` — linear warmup to lr then linear decay to 0
  (optax.join_schedules of two linear schedules), global-norm clip 5.0,
  and AdamW (optax semantics: eps on the corrected root) whose decoupled
  weight decay skips every parameter with ``bias``, ``beta`` or ``gamma``
  in its name (reference optimization.py:145-146).

An optimizer is ``init(params) -> state`` and ``update(grads, state,
params) -> (updates, state)`` over dicts of name -> tensor, like optax,
except that the moment tensors are updated in place (the state passed in
is consumed); ``apply_updates`` adds the updates to the parameters in
place. Step counts
stay host integers, so no update waits on the device. The arithmetic runs
as ``torch._foreach_*`` passes over all tensors at once.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from easydgl_tpu_torch.config import OptimConfig

Tensors = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Tensors], Any]
    update: Callable[[Tensors, Any, Tensors], Tuple[Tensors, Any]]


class TFAdamState(NamedTuple):
    count: int
    mu: Tensors
    nu: Tensors


class AdamWState(NamedTuple):
    count: int        # scale_by_adam's count
    mu: Tensors
    nu: Tensors
    sched_count: int  # the schedule's count


def _zeros(params: Tensors) -> Tensors:
    return {k: torch.zeros_like(v) for k, v in params.items()}


def global_norm(grads: Tensors, params=None) -> torch.Tensor:
    """The global L2 norm of the gradients. Where ``params`` marks a table
    whose rows are split over the model axis (``vocab_rows``), its slices'
    squares are summed over model once, the replicated leaves' squares
    counted once."""
    names = list(grads)
    split = [k for k in names if params is not None
             and hasattr(params[k], "vocab_rows")]
    if not split:
        return torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm([grads[k] for k in names])))
    from easydgl_tpu_torch.core.mesh import model_group, spmd_mesh
    from easydgl_tpu_torch.dist.comm import total
    sq = lambda ks: torch.linalg.vector_norm(  # noqa: E731
        torch.stack(torch._foreach_norm([grads[k] for k in ks]))).square()
    rest = [k for k in names if k not in split]
    part = total(sq(split), model_group(spmd_mesh()))
    return torch.sqrt(part + sq(rest) if rest else part)


def clip_by_global_norm(grads: Tensors, max_norm: float,
                        params=None) -> Tensors:
    """optax.clip_by_global_norm: unchanged while the global norm
    (``global_norm``) is below ``max_norm``, else each tensor is t / norm *
    max_norm."""
    names = list(grads)
    gs = [grads[k] for k in names]
    norm = global_norm(grads, params)
    trigger = norm < max_norm
    return {k: torch.where(trigger, g, g / norm * max_norm)
            for k, g in zip(names, gs)}


def _moments(names, grads, mu, nu, b1, b2):
    """mu = b1 mu + (1-b1) g, nu = b2 nu + (1-b2) g^2, in place."""
    gs = [grads[k] for k in names]
    ms = [mu[k] for k in names]
    vs = [nu[k] for k in names]
    torch._foreach_mul_(ms, b1)
    torch._foreach_add_(ms, gs, alpha=1.0 - b1)
    torch._foreach_mul_(vs, b2)
    torch._foreach_addcmul_(vs, gs, gs, value=1.0 - b2)
    return ms, vs


def tf_adam(learning_rate: float, b1: float, b2: float, eps: float,
            clip_norm: float = 0.0) -> Optimizer:
    """Adam with tf.train.AdamOptimizer's update (see the module doc)."""

    def init(params: Tensors) -> TFAdamState:
        return TFAdamState(0, _zeros(params), _zeros(params))

    @torch.no_grad()
    def update(grads: Tensors, state: TFAdamState, params=None):
        if clip_norm > 0:
            grads = clip_by_global_norm(grads, clip_norm, params)
        names = list(grads)
        mu = {k: state.mu[k] for k in names}
        nu = {k: state.nu[k] for k in names}
        ms, vs = _moments(names, grads, mu, nu, b1, b2)
        count = state.count + 1
        t = np.float32(count)
        corr = float(np.sqrt(np.float32(1.0) - np.float32(b2) ** t)
                     / (np.float32(1.0) - np.float32(b1) ** t))
        denom = torch._foreach_sqrt(vs)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_mul(ms, corr)
        torch._foreach_div_(upd, denom)
        torch._foreach_mul_(upd, -learning_rate)
        return dict(zip(names, upd)), TFAdamState(count, mu, nu)

    return Optimizer(init, update)


def linear_warmup_decay(learning_rate: float, warmup: int,
                        total: int) -> Callable[[int], float]:
    """optax.join_schedules([linear 0 -> lr over ``warmup``, linear lr -> 0
    over max(total - warmup, 1)], [warmup])."""
    decay = max(total - warmup, 1)

    def linear(init, end, steps, count):
        if steps <= 0:
            return init
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    def schedule(count: int) -> float:
        if count < warmup:
            return linear(0.0, learning_rate, warmup, count)
        return linear(learning_rate, 0.0, decay, count - warmup)

    return schedule


def _decayed(name: str) -> bool:
    """No weight decay for LayerNorm parameters and biases."""
    return not {"bias", "beta", "gamma"} & set(name.split("."))


def adamw_warmup(cfg: OptimConfig) -> Optimizer:
    schedule = linear_warmup_decay(cfg.learning_rate, cfg.num_warmup_steps,
                                   cfg.num_train_steps)
    b1, b2, eps, wd = 0.9, 0.999, 1e-6, cfg.weight_decay

    def init(params: Tensors) -> AdamWState:
        return AdamWState(0, _zeros(params), _zeros(params), 0)

    @torch.no_grad()
    def update(grads: Tensors, state: AdamWState, params: Tensors):
        grads = clip_by_global_norm(grads, 5.0, params)
        names = list(grads)
        mu = {k: state.mu[k] for k in names}
        nu = {k: state.nu[k] for k in names}
        ms, vs = _moments(names, grads, mu, nu, b1, b2)
        count = state.count + 1
        m_hat = torch._foreach_div(ms, 1.0 - b1 ** count)
        v_hat = torch._foreach_div(vs, 1.0 - b2 ** count)
        denom = torch._foreach_sqrt(v_hat)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(m_hat, denom)
        upd = [u + wd * params[k] if _decayed(k) else u
               for k, u in zip(names, upd)]
        lr = schedule(state.sched_count)
        torch._foreach_mul_(upd, -lr)
        return (dict(zip(names, upd)),
                AdamWState(count, mu, nu, state.sched_count + 1))

    return Optimizer(init, update)


def build_optimizer(cfg: OptimConfig) -> Optimizer:
    if cfg.name == "adam":
        return tf_adam(cfg.learning_rate, cfg.beta1, cfg.beta2, cfg.eps,
                       cfg.clip_norm)
    if cfg.name == "adamw_warmup":
        return adamw_warmup(cfg)
    raise ValueError(f"unknown optimizer {cfg.name}")


@torch.no_grad()
def apply_updates(params: Tensors, updates: Tensors) -> None:
    """params += updates, in place (optax.apply_updates; the port updates
    the model's parameters where they are instead of copying the tree)."""
    names = list(updates)
    torch._foreach_add_([params[k] for k in names],
                        [updates[k] for k in names])
