"""Training/evaluation loop (port of ``easydgl_tpu.train.loop``; replaces
reference src/main.py:78-151), one device.

Per epoch: run the train step over the shuffled train loader, then stream
validation and test metrics, feed EarlyStopping on validation H100,
checkpoint on improvement, stop on patience/NaN. The per-step losses stay
on the device until the epoch's mean; ``device_prefetch`` keeps the next
batches' host-to-device copies in flight while the card runs a step.

With a ``mesh`` (``core/mesh.py::make_mesh``; one process per rank) the
loop runs the sharded path, as the JAX loop's (loop.py:99-200): each rank
loads batch_size / dp rows of its data shard (the model-axis ranks of one
data group the same rows), the item table is row-sharded
(``train/sharded.py``), the eval is the distributed one where mp > 1
divides the vocab and the sharded one otherwise, and rank 0 saves the
whole state, the table's slices gathered, in the single-device format; a
resume restores it whole and shards it again. Context and pipeline
parallelism (the JAX loop's ``pipe`` axis) are not ported (ROADMAP A.3).
"""
from __future__ import annotations

import collections
import logging
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from easydgl_tpu_torch.config import Config
from easydgl_tpu_torch.core.runtime import host_shard_info
from easydgl_tpu_torch.data.loader import BatchLoader, PackedDataset
from easydgl_tpu_torch.device import resolve_device
from easydgl_tpu_torch.eval.metrics import MetricAccumulator
from easydgl_tpu_torch.models.base import SequentialModel
from easydgl_tpu_torch.models.registry import build_model
from easydgl_tpu_torch.train.checkpoint import Checkpointer
from easydgl_tpu_torch.train.early_stopping import EarlyStopping
from easydgl_tpu_torch.train.profiler import StepTimer
from easydgl_tpu_torch.train.steps import (TrainState, build_eval_step,
                                           build_train_step,
                                           dropout_generator, init_state)

log = logging.getLogger(__name__)


def make_loaders(cfg: Config, model: SequentialModel,
                 train: PackedDataset, valid: PackedDataset,
                 test: PackedDataset,
                 mark_table: Optional[np.ndarray] = None,
                 marks_on_device: bool = False,
                 host_id: int = 0, num_hosts: int = 1,
                 use_native: Optional[bool] = None):
    """The train, validation and test loaders of one data shard.
    cfg.batch_size is the GLOBAL batch; shard ``host_id`` of ``num_hosts``
    (the data axis) loads batch_size / num_hosts rows of its disjoint
    rows. ``use_native``: ``BatchLoader``'s."""
    if cfg.batch_size % num_hosts:
        raise ValueError(f"global batch {cfg.batch_size} not divisible by "
                         f"{num_hosts} data shards")
    kw = dict(data_mode=model.data_mode,
              batch_size=cfg.batch_size // num_hosts,
              masklen=cfg.masklen, seed=cfg.seed, mark_table=mark_table,
              needs_marks=model.uses_tpp, marks_on_device=marks_on_device,
              host_id=host_id, num_hosts=num_hosts, use_native=use_native)
    return (BatchLoader(train, is_training=True, **kw),
            BatchLoader(valid, is_training=False, **kw),
            BatchLoader(test, is_training=False, **kw))


def _map(fn, item):
    """``fn`` over the arrays of a loader item (nested dicts and tuples)."""
    if isinstance(item, dict):
        return {k: _map(fn, v) for k, v in item.items()}
    if isinstance(item, (tuple, list)):
        return type(item)(_map(fn, v) for v in item)
    return fn(item)


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def device_prefetch(iterator, size: int = 2, device=None):
    """Keep ``size`` batches in flight: each loader item (nested dicts and
    tuples of numpy arrays) is put on ``device`` before the one ``size - 1``
    items ahead of it is handed out — the pipeline role of the reference's
    tf.data prefetch (dataloader.py:245).

    On ``cuda`` the arrays go through pinned host memory and are copied
    with ``non_blocking`` on a side stream, so that assembling the next
    batches on the host and their copies overlap the step running on the
    card; the consumer's stream waits for an item's copies only when it is
    handed out (``wait_event``), and ``record_stream`` keeps the allocator
    from reusing its memory while that stream may still read it. On the
    CPU the arrays pass through as tensors."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        for item in iterator:
            yield _map(_tensor, item)
        return
    copy_stream = torch.cuda.Stream(dev)
    buf = collections.deque()

    def put(item):
        with torch.cuda.stream(copy_stream):
            moved = _map(lambda a: _tensor(a).pin_memory().to(
                dev, non_blocking=True), item)
            done = torch.cuda.Event()
            done.record(copy_stream)
        return moved, done

    def hand_out(entry):
        moved, done = entry
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(done)
        _map(lambda t: t.record_stream(consumer), moved)
        return moved

    for item in iterator:
        buf.append(put(item))
        if len(buf) >= size:
            yield hand_out(buf.popleft())
    while buf:
        yield hand_out(buf.popleft())


def evaluate(eval_step, model, loader: BatchLoader,
             device=None) -> Dict[str, float]:
    acc = MetricAccumulator()
    for features, labels, valid in device_prefetch(loader.epoch(),
                                                   device=device):
        acc.update(eval_step(model, features, labels, valid))
    return acc.result()


def train_model(cfg: Config, train_ds: PackedDataset, valid_ds: PackedDataset,
                test_ds: PackedDataset,
                mark_table: Optional[np.ndarray] = None,
                ckpt_dir: Optional[str] = None,
                num_epochs: Optional[int] = None,
                resume: bool = False, *, device=None, mesh=None,
                use_native: Optional[bool] = None
                ) -> Tuple[TrainState, Dict[str, float]]:
    """Train with early stopping on ``device`` (default ``cuda``; raises if
    there is none). Weights start from ``cfg.seed`` (``build_model``);
    with ``resume`` and a checkpoint in ``ckpt_dir`` the run continues from
    the latest one, at epoch ``step // steps_per_epoch``. ``mesh``: the
    (data, model[, seq]) mesh of the sharded path (this rank's
    ``device``); a data coordinate's seq ranks load the same rows.
    ``use_native``: the loaders' C++ batcher (``BatchLoader``). Returns
    the final state (this rank's under a mesh) and the EarlyStopping
    summary (test metrics of the best epoch)."""
    dev = resolve_device(device)
    model = build_model(cfg, device=dev)
    host_id, num_hosts = host_shard_info(mesh)
    # marks are looked up on the device from a resident table
    # (train/steps.py::device_marks): the loader ships only ids
    dev_marks = mark_table is not None and model.uses_tpp
    mt = np.asarray(mark_table, np.float32) if dev_marks else None
    tr_loader, vl_loader, te_loader = make_loaders(
        cfg, model, train_ds, valid_ds, test_ds, mark_table,
        marks_on_device=dev_marks, host_id=host_id, num_hosts=num_hosts,
        use_native=use_native)
    state = init_state(model)

    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    start_epoch = 0
    if resume and ckpt is not None and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        steps_per_epoch = max(tr_loader.num_batches(), 1)
        start_epoch = state.step // steps_per_epoch
        log.info("resumed from step %d (epoch %d)", state.step,
                 start_epoch)
    gen_shard = None
    if mesh is None:
        train_step = build_train_step(model, mark_table=mt)
        eval_step = build_eval_step(model, mark_table=mt)
        save = lambda state: ckpt.save(state)  # noqa: E731
    else:
        import torch.distributed as dist

        from easydgl_tpu_torch.core.mesh import model_size
        from easydgl_tpu_torch.eval.evaluator import \
            build_distributed_eval_step
        from easydgl_tpu_torch.train.sharded import (
            build_sharded_eval_step, build_sharded_train_step, gather_state,
            rank_generator_shard, shard_state)
        state = shard_state(state, model, mesh)
        train_step = build_sharded_train_step(model, mesh, mark_table=mt)
        mp = model_size(mesh)
        if mp > 1 and model.vocab_size % mp == 0:
            eval_step = build_distributed_eval_step(model, mesh,
                                                    mark_table=mt)
        else:
            eval_step = build_sharded_eval_step(model, mesh, mark_table=mt)
        gen_shard = rank_generator_shard(mesh)

        def save(state):
            whole = gather_state(state, mesh)
            if dist.get_rank() == 0:
                ckpt.save(whole)
    state_ref = [state]
    stopper = EarlyStopping(
        cfg.model, cfg.patience,
        save_fn=(lambda: save(state_ref[0])) if ckpt else None)

    timer = StepTimer(cfg.batch_size)
    epochs = num_epochs if num_epochs is not None else cfg.num_epochs
    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        timer.start()
        losses = []
        for features, labels, _ in device_prefetch(tr_loader.epoch(epoch),
                                                   device=dev):
            state, loss = train_step(
                state, features, labels,
                dropout_generator(cfg.seed, state.step, dev, gen_shard))
            losses.append(loss)
            timer.tick()
        state_ref[0] = state
        mean_loss = (float(torch.stack(losses).mean()) if losses
                     else np.nan)
        log.info("%03d: Loss=%.4f (%.1fs, %.1f train ex/s)", epoch,
                 mean_loss, time.time() - t0, timer.examples_per_sec())

        if epoch % cfg.eval_per_steps:
            continue
        vl = evaluate(eval_step, model, vl_loader, dev)
        te = evaluate(eval_step, model, te_loader, dev)
        log.info("%03d: valid %s", epoch,
                 {k: f"{v:.5f}" for k, v in vl.items()})
        if stopper.step(mean_loss, vl.get("H100", 0.0), vl, te):
            break
    return state, stopper.summary()
