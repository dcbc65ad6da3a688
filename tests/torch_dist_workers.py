"""Rank workers of the port's distributed tests (``test_torch_sharding``,
``test_torch_dist_eval``, ``test_torch_dist_cli``).

``run_world`` spawns one process per rank with ``torch.multiprocessing``,
starts a gloo process group and a (dp, mp[, cp]) mesh through the port's
own ``core/runtime.py`` and ``core/mesh.py``, runs one of the ``w_*``
functions below on every rank and returns each rank's result. This module
imports torch and the port, never JAX: the JAX side of each test runs in
the pytest process. A rank's rows of a global batch are its data
coordinate's block of B / dp rows, as ``train/loop.py::make_loaders``
hands them out; the seq ranks of a data coordinate hold the same rows
(``test_torch_context``).
"""
from __future__ import annotations

import os
import pathlib

import numpy as np
import torch
import torch.distributed as dist


def run_world(fn_name: str, payload, dp: int, mp: int, out_dir,
              cp: int = 1):
    """Every rank's result of ``fn_name(mesh, payload)`` on a gloo world of
    dp * mp * cp ranks."""
    import torch.multiprocessing as tmp

    from easydgl_tpu_torch.core.runtime import free_port
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    world = dp * mp * cp
    tmp.spawn(_entry, args=(world, free_port(), (dp, mp, cp), fn_name,
                            payload, str(out_dir)), nprocs=world, join=True)
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _entry(rank, world, port, shape, fn_name, payload, out_dir):
    torch.set_num_threads(1)
    from easydgl_tpu_torch.config import MeshConfig
    from easydgl_tpu_torch.core.mesh import make_mesh
    from easydgl_tpu_torch.core.runtime import init_distributed
    init_distributed(f"127.0.0.1:{port}", world, rank, "cpu")
    dp, mp, cp = shape
    try:
        if fn_name == "w_cli":
            res = w_cli(rank, world, port, payload)
        else:
            mesh = make_mesh(MeshConfig(dp=dp, mp=mp, cp=cp), "cpu")
            res = globals()[fn_name](mesh, payload)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _coords(mesh):
    from easydgl_tpu_torch.core.mesh import (data_index, data_size,
                                             model_index, model_size)
    return data_index(mesh), data_size(mesh), model_index(mesh), \
        model_size(mesh)


def _rows(x, mesh):
    """This rank's block of the leading (batch) dim."""
    di, dp, _, _ = _coords(mesh)
    n = x.shape[0] // dp
    return x[di * n:(di + 1) * n]


def _t(x):
    return torch.as_tensor(np.asarray(x))


def w_many(mesh, jobs):
    """Several workers in one world: ``jobs`` is a dict of name ->
    (worker name, payload); returns name -> that worker's result."""
    return {name: globals()[fn](mesh, p) for name, (fn, p) in jobs.items()}


# ---------------------------------------------------------------- pieces


def w_topk(mesh, p):
    """distributed_top_k / _label_nll / _mask_seen and
    sharded_tied_logits on this rank's rows and catalog columns."""
    from easydgl_tpu_torch.dist.embedding import sharded_tied_logits
    from easydgl_tpu_torch.dist.topk import (distributed_label_nll,
                                             distributed_mask_seen,
                                             distributed_top_k)
    _, _, mi, mp = _coords(mesh)
    logits = _rows(_t(p["logits"]), mesh)
    v = logits.shape[1] // mp
    cols = logits[:, mi * v:(mi + 1) * v]
    vals, ids = distributed_top_k(cols, p["k"], mesh)
    masked = distributed_mask_seen(cols, _rows(_t(p["seen"]), mesh), mesh)
    vals_m, ids_m = distributed_top_k(masked, p["k_all"], mesh)
    nll = distributed_label_nll(cols, _rows(_t(p["labels"]), mesh), mesh)
    table = _t(p["table"])
    tv = table.shape[0] // mp
    tied = sharded_tied_logits(_rows(_t(p["hidden"]), mesh),
                               table[mi * tv:(mi + 1) * tv], _t(p["bias"]),
                               mesh)
    tied_whole = sharded_tied_logits(_rows(_t(p["hidden"]), mesh), table,
                                     _t(p["bias"]), mesh)
    return dict(vals=vals, ids=ids, masked=masked, vals_m=vals_m,
                ids_m=ids_m, nll=nll, tied=tied, tied_whole=tied_whole)


def w_catalog(mesh, p):
    """catalog_nll_spmd: the loss sum((lse - ll) w) over this rank's rows,
    its value and gradients (the table's slice, the whole bias)."""
    from easydgl_tpu_torch.kernels.spmd import catalog_nll_spmd
    _, _, mi, mp = _coords(mesh)
    table = _t(p["table"])
    v = table.shape[0] // mp
    h = _rows(_t(p["hidden"]), mesh).requires_grad_()
    t = table[mi * v:(mi + 1) * v].clone().requires_grad_()
    b = _t(p["bias"]).requires_grad_()
    lse, ll = catalog_nll_spmd(h, t, b, _rows(_t(p["labels"]), mesh), mesh)
    loss = ((lse - ll) * _rows(_t(p["weights"]), mesh)).sum()
    loss.backward()
    return dict(lse=lse.detach(), ll=ll.detach(), loss=loss.detach(),
                dh=h.grad, dt=t.grad, db=b.grad)


def w_mau(mesh, p):
    """mau_attention_spmd on this rank's rows: out, lam and the gradients
    of sum(sin(out)) + sum(cos(lam))."""
    from easydgl_tpu_torch.kernels.spmd import mau_attention_spmd
    rows = [_rows(_t(p[k]), mesh).clone().requires_grad_()
            for k in ("q", "k", "v", "t")]
    weights = [_t(p[k]).clone().requires_grad_()
               for k in ("wd", "bd", "w", "sc")]
    km, iv, oh = (_rows(_t(p[k]), mesh) for k in ("km", "iv", "oh"))
    out, lam = mau_attention_spmd(*rows, km, iv, oh, *weights, None, mesh,
                                  p["causal"], p["diag"], 0.0, p["h"])
    loss = torch.sin(out).sum() + torch.cos(lam).sum()
    loss.backward()
    return dict(out=out.detach(), lam=lam.detach(), loss=loss.detach(),
                grads=[x.grad for x in rows + weights])


def w_flash(mesh, p):
    """flash_attention_spmd on this rank's rows, heads over model: out and
    the gradients of sum(out * g)."""
    from easydgl_tpu_torch.kernels.spmd import flash_attention_spmd
    q, k, v = (_rows(_t(p[n]), mesh).clone().requires_grad_()
               for n in ("q", "k", "v"))
    out = flash_attention_spmd(q, k, v, _rows(_t(p["km"]), mesh), mesh,
                               causal=True)
    (out * _rows(_t(p["g"]), mesh)).sum().backward()
    return dict(out=out.detach(), grads=[q.grad, k.grad, v.grad])


# ---------------------------------------------------------------- steps


def _model(p):
    """The payload's model and config (``clip``: TF-Adam's clip norm)."""
    import dataclasses

    from easydgl_tpu_torch.config import preset
    from easydgl_tpu_torch.models.registry import build_model
    cfg = preset(p["model"], **p["cfg"])
    if "clip" in p:
        cfg = cfg.replace(optim=dataclasses.replace(cfg.optim,
                                                    clip_norm=p["clip"]))
    return cfg, build_model(cfg, device="cpu", params=p["params"])


def _train(mesh, p):
    """(this rank's state, the loss of each step) after one sharded train
    step on each of the payload's batches, from its weights."""
    from easydgl_tpu_torch.train.sharded import (build_sharded_train_step,
                                                 rank_generator_shard,
                                                 shard_state)
    from easydgl_tpu_torch.train.steps import dropout_generator, init_state
    cfg, model = _model(p)
    state = shard_state(init_state(model), model, mesh)
    step = build_sharded_train_step(model, mesh, mark_table=p.get("mark"))
    losses = []
    for features, labels in p["batches"]:
        feats = {k: _rows(v, mesh) for k, v in features.items()}
        state, loss = step(state, feats, _rows(labels, mesh),
                           dropout_generator(cfg.seed, state.step, "cpu",
                                             rank_generator_shard(mesh)))
        losses.append(float(loss))
    return state, losses


def w_train(mesh, p):
    """The payload's sharded train steps; the loss of each and the whole
    state after them (``gather_state``)."""
    from easydgl_tpu_torch.train.sharded import gather_state
    state, losses = _train(mesh, p)
    whole = gather_state(state, mesh)
    return dict(losses=losses, params=whole.params,
                mu=whole.opt_state.mu, shapes={
                    n: tuple(t.shape) for n, t in state.params.items()})


def w_replicas(mesh, p):
    """``w_train``'s steps, with a term of its own added to each rank's
    gradients before they are reduced, as a nondeterministic op (an atomic
    scatter) leaves them on the card: this rank's own parameters after
    the steps (the table as its slice) and its mesh coordinates."""
    import easydgl_tpu_torch.train.steps as steps
    reduce = steps.reduce_gradients
    term = 1e-6 * (dist.get_rank() + 1)

    def perturbed(grads, params, mesh):
        return reduce({n: g + term for n, g in grads.items()}, params, mesh)

    steps.reduce_gradients = perturbed
    try:
        state, _ = _train(mesh, p)
    finally:
        steps.reduce_gradients = reduce
    return dict(params={n: t.detach().clone()
                        for n, t in state.params.items()},
                coords=_coords(mesh))


def w_eval(mesh, p):
    """The distributed eval step's sums (or the sharded one's, where mp
    does not divide the vocab) over the payload's batch, and the route."""
    from easydgl_tpu_torch.core.mesh import model_size
    from easydgl_tpu_torch.eval.evaluator import build_distributed_eval_step
    from easydgl_tpu_torch.train.sharded import (build_sharded_eval_step,
                                                 shard_state)
    from easydgl_tpu_torch.train.steps import init_state
    cfg, model = _model(p)
    shard_state(init_state(model), model, mesh)
    mp = model_size(mesh)
    dist_route = mp > 1 and model.vocab_size % mp == 0
    build = (build_distributed_eval_step if dist_route
             else build_sharded_eval_step)
    step = build(model, mesh, mark_table=p.get("mark"))
    features, labels, valid = p["batch"]
    sums = step(model, {k: _rows(v, mesh) for k, v in features.items()},
                _rows(labels, mesh), _rows(valid, mesh))
    return dict(sums={k: float(v) for k, v in sums.items()},
                distributed=dist_route)


def w_loader(mesh, p):
    """The rows (seqs_i) of each batch of the train and validation loaders
    this rank's data shard gets from ``make_loaders``."""
    from easydgl_tpu_torch.config import preset
    from easydgl_tpu_torch.core.runtime import host_shard_info
    from easydgl_tpu_torch.data.loader import PackedDataset
    from easydgl_tpu_torch.models.registry import build_model
    from easydgl_tpu_torch.train.loop import make_loaders
    cfg = preset(p["model"], **p["cfg"])
    model = build_model(cfg, device="cpu")
    ds = PackedDataset(p["arrays"], cfg.num_items)
    host_id, num_hosts = host_shard_info(mesh)
    tr, vl, _ = make_loaders(cfg, model, ds, ds, ds, host_id=host_id,
                             num_hosts=num_hosts)
    return dict(
        train=[f["seqs_i"] for f, _, _ in tr.epoch(0)],
        valid=[(f["seqs_i"], valid) for f, _, valid in vl.epoch(0)],
        shard=(host_id, num_hosts))


def w_cli(rank, world, port, p):
    """``cli.train`` on this rank, in the payload's directory; the
    process group is up already, as torchrun leaves it."""
    from easydgl_tpu_torch.cli import train as train_cli
    os.chdir(p["cwd"])
    return train_cli.main(p["argv"] + [
        "--coordinator_address", f"127.0.0.1:{port}", "--num_processes",
        str(world), "--process_id", str(rank)])


# ---------------------------------------------------------------- context


def context_case(ex, case):
    """One ``dist/context.py`` call over the exchange ``ex`` on the case's
    whole inputs: the output (and, for the ring MAU, the intensity) and
    the gradients of sum(out * co) [+ sum(cos(lam))] with respect to
    every input. ``test_torch_context`` runs it in a world (the mesh's
    seq axis) and in one process (a ``LocalExchange``)."""
    from easydgl_tpu_torch.dist.context import (mau_ring_attention,
                                                ring_attention,
                                                ulysses_attention)
    kind, rate = case["kind"], case.get("rate", 0.0)
    kw = dict(dropout_rate=rate, generator=torch.Generator().manual_seed(
        case.get("seed", 0)))
    if kind == "mau":
        names = ("q", "k", "v", "t", "wd", "bd", "w", "sc")
        x = {n: _t(case[n]).clone().requires_grad_() for n in names}
        out, lam = mau_ring_attention(
            x["q"], x["k"], x["v"], x["t"], _t(case["km"]), _t(case["iv"]),
            _t(case["oh"]), x["wd"], x["bd"], x["w"], x["sc"], ex,
            causal=case["causal"], diag_reset=case["diag"], **kw)
        loss = (out * _t(case["co"])).sum() + torch.cos(lam).sum()
        res = dict(out=out.detach(), lam=lam.detach())
    else:
        names = ("q", "k", "v")
        x = {n: _t(case[n]).clone().requires_grad_() for n in names}
        fn = ring_attention if kind == "ring" else ulysses_attention
        out = fn(x["q"], x["k"], x["v"], _t(case["km"]), ex,
                 causal=case["causal"], **kw)
        loss = (out * _t(case["co"])).sum()
        res = dict(out=out.detach())
    loss.backward()
    res["grads"] = {n: x[n].grad for n in names}
    return res


def w_context(mesh, cases):
    """``context_case`` of every case over the mesh's seq axis."""
    from easydgl_tpu_torch.core.mesh import use_spmd_mesh
    from easydgl_tpu_torch.dist.context import seq_exchange
    with use_spmd_mesh(mesh):
        ex = seq_exchange()
        return {name: context_case(ex, c) for name, c in cases.items()}


def w_logits(mesh, p):
    """The eval forward's logits of this rank's rows under the mesh."""
    from easydgl_tpu_torch.core.mesh import use_spmd_mesh
    _, model = _model(p)
    features = {k: _rows(_t(v), mesh) for k, v in p["features"].items()}
    with use_spmd_mesh(mesh), torch.no_grad():
        logits, _ = model(features, is_training=False)
    return logits


def w_grads(mesh, p):
    """(loss, reduced gradients) of ``train/steps.py::loss_and_grads``
    under the mesh on this rank's rows of the payload's first batch."""
    from easydgl_tpu_torch.core.mesh import use_spmd_mesh
    from easydgl_tpu_torch.train.sharded import shard_state
    from easydgl_tpu_torch.train.steps import (device_marks, init_state,
                                               loss_and_grads)
    _, model = _model(p)
    shard_state(init_state(model), model, mesh)
    features, labels = p["batches"][0]
    feats = {k: _rows(_t(v), mesh) for k, v in features.items()}
    labels = _rows(_t(labels), mesh)
    mt = p.get("mark")
    feats = device_marks(feats, labels, None if mt is None else _t(mt)
                         .float(), is_training=True)
    with use_spmd_mesh(mesh):
        loss, grads = loss_and_grads(model, feats, labels)
    return dict(loss=float(loss), grads=grads)


def w_cli_in_world(mesh, p):
    """``cli.train`` on this rank inside the running world (its process
    group reused, as under torchrun), in the payload's directory."""
    from easydgl_tpu_torch.cli import train as train_cli
    os.chdir(p["cwd"])
    return train_cli.main(p["argv"])
