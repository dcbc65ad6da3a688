"""Training and eval over a (data, model[, seq]) mesh (port of
``easydgl_tpu.train.sharded``).

One process per rank. The dense tower is data-parallel: each rank runs it
on its data shard's rows. The item table, the dominant parameter, is
row-sharded over the model axis where mp divides its rows
(``shard_state``), and its TF-Adam moments with it; every other parameter
is replicated. Within a data group the model-axis ranks run the same dense
graph; the collectives in the forward (``dist/comm.py``) carry the
backwards that make each replicated leaf's gradient the whole one on every
rank and each table slice's its own. After the backward, the table slices'
gradients are summed over the data axis and the replicated leaves' over
the whole world, divided by mp (``dist/comm.py::reduce_gradients``), so
that every rank's replicas stay bit-identical.

Under a seq axis (cp > 1, ``dist/context.py``) the cp ranks of a (data,
model) coordinate read the same rows and run the same dense graph too;
only the attention splits the sequence over them. Its split's backward
all-gathers the blocks' gradients and its gather's backward takes the
rank's block, so each replicated leaf's dense part arrives whole and
equal on every seq rank (counted once, not cp times), and the world's
sum is divided by mp cp; a table slice's gradient is summed over data and
averaged over seq.

The steps are ``train/steps.py``'s, given the mesh. The loss of a rank is
its share of the global batch's (``compute_loss``), so the sum over the
data axis is the single-device step's gradient and loss; TF-Adam's clip takes the global
norm over the table's slices and the replicated leaves
(``train/optim.py::global_norm``).

``gather_state`` puts the table's slices back together, so that a
checkpoint has the single-device layout; ``shard_state`` slices a whole
state again (a resume re-shards).
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from easydgl_tpu_torch.core.mesh import (data_index, data_size, model_group,
                                         table_rows)
from easydgl_tpu_torch.dist.comm import all_gather_cat
from easydgl_tpu_torch.models.base import SequentialModel
from easydgl_tpu_torch.train.steps import (TrainState, build_eval_step,
                                           build_train_step)


def is_table_path(name: str) -> bool:
    """The item table: a ``lookup_table`` under a module named (or ending
    in) ``item_embs``."""
    parts = name.split(".")
    return (parts[-1] == "lookup_table"
            and any(p.startswith("item_embs") or p.endswith("item_embs")
                    for p in parts[:-1]))


def param_shardings(model: nn.Module, mesh) -> Dict[str, object]:
    """name -> the [start, stop) rows this rank holds of a row-sharded
    parameter (the item table, where mp divides its rows), or None
    (replicated)."""
    return {name: (table_rows(mesh, p.shape[0]) if is_table_path(name)
                   else None)
            for name, p in model.named_parameters()}


def _map_opt(opt, fn):
    """The optimizer state with ``fn(name, tensor)`` applied to each
    moment tensor."""
    fields = {}
    for k, v in opt._asdict().items():
        fields[k] = ({n: fn(n, t) for n, t in v.items()}
                     if isinstance(v, dict) else v)
    return type(opt)(**fields)


@torch.no_grad()
def shard_state(state: TrainState, model: nn.Module, mesh) -> TrainState:
    """A whole state of ``model`` (its step-0 state, or one restored from
    a checkpoint) made this rank's: each row-sharded parameter of the
    model replaced by this rank's rows, marked with ``vocab_rows`` (read by
    the embedding, the L2 terms, the clip and ``gather_state``), and its
    moments sliced as it is."""
    rows = param_shardings(model, mesh)
    for name, r in rows.items():
        if r is not None:
            mod_name, _, leaf = name.rpartition(".")
            mod = model.get_submodule(mod_name)
            part = nn.Parameter(getattr(mod, leaf)[r[0]:r[1]].clone())
            part.vocab_rows = r
            setattr(mod, leaf, part)

    def cut(name, t):
        r = rows.get(name)
        return t if r is None else t[r[0]:r[1]].clone()

    return TrainState(dict(model.named_parameters()),
                      _map_opt(state.opt_state, cut), state.step)


@torch.no_grad()
def gather_state(state: TrainState, mesh) -> TrainState:
    """The whole state on the CPU, each row-sharded parameter and its
    moments gathered over the model axis (every rank takes part)."""
    split = {n for n, p in state.params.items() if hasattr(p, "vocab_rows")}
    g = model_group(mesh)

    def whole(name, t):
        t = all_gather_cat(t, 0, g) if name in split else t
        return t.detach().cpu()

    return TrainState({n: whole(n, p) for n, p in state.params.items()},
                      _map_opt(state.opt_state, whole), state.step)


def build_sharded_train_step(model: SequentialModel, mesh, mark_table=None):
    """``train/steps.py::build_train_step`` under the mesh: features and
    labels are this rank's rows, the generator this rank's
    (``dropout_generator`` with its data coordinate where dp > 1), the
    state ``shard_state``'s. The loss comes back as the global batch's."""
    return build_train_step(model, mark_table, mesh)


def build_sharded_eval_step(model: SequentialModel, mesh, mark_table=None):
    """The eval where the catalog is not split (mp == 1, or mp does not
    divide the vocab): ``train/steps.py::build_eval_step`` under the mesh,
    each rank ranking its rows against the whole catalog; the sums are
    added over the data axis."""
    return build_eval_step(model, mark_table, mesh)


def rank_generator_shard(mesh):
    """The ``shard`` argument of ``dropout_generator`` for this rank: its
    data coordinate where dp > 1, else None (the single-device draws)."""
    return data_index(mesh) if data_size(mesh) > 1 else None
