"""Step builders (port of ``easydgl_tpu.train.steps``).

``build_train_step`` is the faithful train step: the training forward with
dropout, the loss (``compute_loss``) and one optimizer update.
``build_eval_step`` mirrors Sequential.eval (reference Base.py:150-207):
last-position logits, optional mask_seen, top-100 HR/NDCG sums. PyTorch
runs eagerly, so each step is a plain callable. Given a (data, model)
mesh (``core/mesh.py``), each builder's step is the sharded one: it takes
this rank's rows, runs under the mesh (``use_spmd_mesh``) and returns the
global batch's loss or sums (``train/sharded.py``).

Loss, per label from ``ce = lse - logit_label`` over the full catalog:
``softmax_eps`` (EasyDGL and SASREC; Base.py:119-131) takes
``-log(softmax(logits) + 1e-5)`` at the label, computed exactly as
``-log(exp(-ce) + 1e-5)``; ``sparse_ce`` (BERT4REC; BERT4REC.py:131-149)
takes ``ce`` itself. Over every label of the batch (the masked positions of
the masked protocols, every position of the regressive one, labels (B, T)
flattened), the label-weight mean with the mask on padding id 0;
``l2_reg * 0.5 * sum(w^2)`` over every ``lookup_table``; the TPP
regularizer (EasyDGL). ``grec`` (GREC.py:110-116) takes the plain mean of
``ce`` over the rows of the batch that hold a token (``|seqs_i|`` summed
over the row > 0; the reference's mean has no label weight, and an all-pad
tail row must not shift it) plus ``0.001 * l2_mean_all``: the mean over
the parameter TENSORS of ``0.5 * sum(w^2)`` (``cfg.l2_reg`` is not used).
The catalog scoring goes through ``kernels.scoring.catalog_nll`` with
hidden and table in the compute dtype, so no (N, V) logits are built on
the card.

Dropout: each step draws every mask from a ``torch.Generator`` on the
device. ``dropout_generator(seed, step)`` seeds it from the run's seed and
the step number, as the JAX step folds the step into its key
(``fold_in(rng, step)``), so a resumed run draws the masks an uninterrupted
one draws.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from easydgl_tpu_torch.core.mesh import spmd_mesh, use_spmd_mesh
from easydgl_tpu_torch.dist.comm import (data_share, data_total, data_totals,
                                         reduce_gradients)
from easydgl_tpu_torch.eval.metrics import mask_seen_logits, metric_sums
from easydgl_tpu_torch.kernels.scoring import catalog_nll
from easydgl_tpu_torch.models.base import SCORING, SequentialModel
from easydgl_tpu_torch.train.optim import apply_updates, build_optimizer


class TrainState(NamedTuple):
    """``params`` are the model's own parameters (name -> tensor), updated
    in place by the step; ``step`` counts the updates taken."""
    params: Dict[str, torch.Tensor]
    opt_state: Any
    step: int


def half_sq(p: torch.Tensor) -> torch.Tensor:
    """0.5 * sum(w^2) of one parameter; of a table whose rows are split
    over the model axis (``vocab_rows``), summed over the slices."""
    term = 0.5 * p.square().sum()
    if hasattr(p, "vocab_rows"):
        from easydgl_tpu_torch.core.mesh import model_group, spmd_mesh
        from easydgl_tpu_torch.dist.comm import all_reduce_sum
        term = all_reduce_sum(term, model_group(spmd_mesh()))
    return term


def l2_lookup_tables(params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """0.5 * sum(w^2) over every ``lookup_table`` parameter."""
    return sum(half_sq(p) for name, p in params.items()
               if name.split(".")[-1] == "lookup_table")


def l2_mean_all(params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The mean over parameter tensors of ``0.5 * sum(w^2)`` (GREC.py:115);
    the divisor is the number of leaves of the JAX model's param tree,
    which the port's modules hold one for one."""
    leaves = list(params.values())
    return sum(half_sq(p) for p in leaves) / len(leaves)


def _label_nll(logits: torch.Tensor, labels: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lse - logit_at_label, logit_at_label) from materialised logits."""
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = torch.take_along_dim(logits, labels.long()[:, None],
                                       dim=1)[:, 0]
    return lse - label_logit, label_logit


def compute_loss(model: SequentialModel, features: Dict[str, torch.Tensor],
                 labels: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The training loss of one batch (``softmax_eps``, ``sparse_ce`` or
    ``grec``). ``features`` carry ``masked_positions`` and, for the TPP
    term, ``next_marks``.

    Under a mesh (``core/mesh.py::use_spmd_mesh``) this is the rank's share
    of the global batch's loss, and the data-axis ranks' shares sum to it:
    each mean divides by the global batch's count (``data_total``), each
    term that does not depend on the batch (the L2 penalties) is divided
    by dp (``data_share``), and every model-axis rank of a data group holds
    the same share."""
    cfg = model.cfg
    if model.loss_mode not in ("softmax_eps", "sparse_ce", "grec"):
        raise NotImplementedError(f"loss mode {model.loss_mode}")
    _, aux = model(features, is_training=True, generator=generator)
    hidden, table, bias = aux[SCORING]
    dt = cfg.matmul_dtype
    if dt is not None:
        hidden, table = hidden.to(dt), table.to(dt)
    flat = labels.reshape(-1)
    mesh = spmd_mesh()
    if mesh is not None:
        # the catalog split over the model axis where mp divides V
        # (kernels/spmd.py), as JAX's compute_loss (steps.py:97-118)
        from easydgl_tpu_torch.kernels.spmd import catalog_nll_spmd
        lse, ll = catalog_nll_spmd(hidden, table, bias, flat, mesh)
    else:
        lse, ll = catalog_nll(hidden, table, bias, flat)
    ce = lse - ll
    if model.loss_mode == "grec":
        rows = features["seqs_i"].abs().sum(dim=1) > 0
        v = rows[:, None].expand(labels.shape).reshape(-1).float()
        return ((ce * v).sum() / data_total(v.sum()).clamp_min(1.0)
                + 0.001 * data_share(l2_mean_all(
                    dict(model.named_parameters()))))
    per_example = (-torch.log(torch.exp(-ce) + 1e-5)
                   if model.loss_mode == "softmax_eps" else ce)
    w = (flat != 0).float()
    loss = (w * per_example).sum() / (data_total(w.sum()) + 1e-5)
    if cfg.l2_reg:
        loss = loss + cfg.l2_reg * data_share(l2_lookup_tables(
            dict(model.named_parameters())))
    if model.uses_tpp and cfg.ct_reg:
        loss = loss + model.tpp_regularizer(aux, features, labels,
                                            features["next_marks"])
    return loss


def loss_and_grads(model: SequentialModel, features, labels,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, name -> gradient) of one batch; leaves ``.grad`` untouched.
    Under a mesh (``use_spmd_mesh``), the global batch's: the rank's share
    of the loss summed over the data axis, and the gradients its optimizer
    takes (``dist/comm.py::reduce_gradients``)."""
    names, params = zip(*model.named_parameters())
    loss = compute_loss(model, features, labels, generator)
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    mesh = spmd_mesh()
    if mesh is not None:
        grads = reduce_gradients(grads, dict(zip(names, params)), mesh)
    return data_total(loss.detach()), grads


def device_marks(features: Dict[str, torch.Tensor], labels,
                 mark_table: Optional[torch.Tensor], *, is_training: bool):
    """On-device mark lookup, the loader's host math (ids beyond the table,
    the MASK id included, map to row 0). No-op when the features already
    carry marks or no table is given."""
    if mark_table is None or "seqs_marks" in features:
        return features
    features = dict(features)

    def look(ids):
        ids = ids.long()
        return mark_table[torch.where(ids >= mark_table.shape[0], 0, ids)]

    features["seqs_marks"] = look(features["seqs_i"])
    if is_training:
        features["next_marks"] = look(labels)
    return features


def to_device(arrays: Dict[str, np.ndarray], device
              ) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}


def init_state(model: SequentialModel) -> TrainState:
    """Step 0 for the model's current weights (from ``build_model``)."""
    params = dict(model.named_parameters())
    tx = build_optimizer(model.cfg.optim)
    return TrainState(params, tx.init(params), 0)


def build_train_step(model: SequentialModel, mark_table=None, mesh=None):
    """Returns ``step(state, features, labels, generator) -> (state,
    loss)``: one training forward and backward and one optimizer update,
    applied to the model's parameters in place. features/labels may be
    numpy arrays (moved to the model's device). ``generator``: a
    ``torch.Generator`` on the model's device; every dropout mask and seed
    of the step is drawn from it (the JAX step folds the step number into
    its key instead). ``mark_table``: optional (num_items, E) incidence
    kept on the device for ``device_marks``. ``mesh``: the step is the
    sharded one (features, labels and generator this rank's, the state
    ``train/sharded.py::shard_state``'s). The loss comes back as a device
    scalar, so the step does not wait for the device."""
    dev = next(model.parameters()).device
    tx = build_optimizer(model.cfg.optim)
    mt = (None if mark_table is None else
          torch.as_tensor(np.asarray(mark_table, np.float32), device=dev))

    def step(state: TrainState, features, labels, generator):
        feats = to_device(features, dev)
        labels = torch.as_tensor(labels, device=dev)
        feats = device_marks(feats, labels, mt, is_training=True)
        with use_spmd_mesh(mesh):
            loss, grads = loss_and_grads(model, feats, labels, generator)
            updates, opt_state = tx.update(grads, state.opt_state,
                                           state.params)
        apply_updates(state.params, updates)
        return TrainState(state.params, opt_state, state.step + 1), loss

    return step


def build_multi_step(model: SequentialModel, mark_table=None):
    """Returns ``multi(state, stacked_features, stacked_labels, seed) ->
    (state, (K,) losses)``: K train steps over a stacked batch ((K, B, ...)
    features and labels, ``stack_batches``). Step k draws its dropout from
    ``dropout_generator(seed, state.step)``, as the loop's steps do.
    PyTorch runs eagerly, so this is a loop of K single steps inside one
    call, not one compiled program as JAX's ``lax.scan``."""
    step = build_train_step(model, mark_table=mark_table)
    dev = next(model.parameters()).device

    def multi(state: TrainState, features, labels, seed: int):
        losses = []
        for k in range(len(labels)):
            state, loss = step(state, {n: v[k] for n, v in features.items()},
                               labels[k],
                               dropout_generator(seed, state.step, dev))
            losses.append(loss)
        return state, torch.stack(losses)

    return multi


def _stack(xs):
    if isinstance(xs[0], torch.Tensor):
        return torch.stack(xs)
    return np.stack(xs)


def stack_batches(batches):
    """[(features, labels), ...] -> (features, labels) with a leading K
    dim; numpy arrays or tensors."""
    feats = {k: _stack([b[0][k] for b in batches]) for k in batches[0][0]}
    return feats, _stack([b[1] for b in batches])


def dropout_generator(seed: int, step: int, device,
                      shard: Optional[int] = None) -> torch.Generator:
    """The generator of step ``step``'s dropout: seeded from ``(seed,
    step)`` alone, so a step draws the same masks whether or not the run
    was resumed before it. ``shard``: the data coordinate of a rank on a
    mesh with dp > 1 (its rows draw their own masks; the model-axis ranks
    of one data group draw the same ones)."""
    key = [seed, step] if shard is None else [seed, step, shard]
    lo, hi = np.random.SeedSequence(key).generate_state(2)
    return torch.Generator(device=device).manual_seed(
        int(lo) | int(hi) << 32)


def build_analytics_step(model: SequentialModel, mark_table=None, mesh=None,
                         rank=None):
    """Returns ``step(params_or_model, features, labels, valid) -> (logits,
    sums)``: the eval step that also returns the raw (B, V) logits — the
    reference's "ANALYTICS" collection (Base.py:154, analytics.py:90-100).
    mask_seen applies to the ranking only, as in the JAX package.

    ``params_or_model`` is the port's model, or a flax-layout param tree
    that is first loaded into ``model``. features/labels/valid may be numpy
    arrays (they are moved to the model's device). ``mark_table``: optional
    (num_items, E) incidence kept on the device for ``device_marks``.
    ``mesh``: the forward and the ranking run under it on this rank's rows,
    and the sums are added over its data axis. ``rank(logits, seqs_i,
    true_items, valid) -> sums``: the ranking; by default mask_seen where
    the config asks and the top-100 sums over the whole catalog
    (``eval/evaluator.py::build_distributed_eval_step`` passes its merged
    one)."""
    from easydgl_tpu_torch.parity import flax_to_torch
    dev = next(model.parameters()).device
    mask_seen = model.cfg.mask_seen
    mt = (None if mark_table is None else
          torch.as_tensor(np.asarray(mark_table, np.float32), device=dev))

    def whole_catalog(logits, seqs_i, true_items, valid):
        ranked = mask_seen_logits(logits, seqs_i) if mask_seen else logits
        return metric_sums(ranked, true_items, valid)

    rank = rank or whole_catalog

    @torch.no_grad()
    def step(params_or_model, features, labels, valid):
        m = params_or_model
        if not isinstance(m, nn.Module):
            model.load_state_dict(flax_to_torch(m))
            m = model
        feats = to_device(features, dev)
        labels = torch.as_tensor(labels, device=dev)
        valid = torch.as_tensor(valid, device=dev)
        feats = device_marks(feats, labels, mt, is_training=False)
        with use_spmd_mesh(mesh):
            logits, _ = m(feats, is_training=False)
            sums = data_totals(rank(logits, feats["seqs_i"], labels[:, -1],
                                    valid))
        return logits, sums

    return step


def build_eval_step(model: SequentialModel, mark_table=None, mesh=None,
                    rank=None):
    """Returns ``step(params_or_model, features, labels, valid) -> sums``.

    Mirrors Sequential.eval (Base.py:150-207): last-position logits,
    optional mask_seen, top-100 HR/NDCG sums. The arguments are those of
    ``build_analytics_step``, whose sums this returns."""
    analytics = build_analytics_step(model, mark_table, mesh, rank)

    def step(params_or_model, features, labels, valid):
        return analytics(params_or_model, features, labels, valid)[1]

    return step
