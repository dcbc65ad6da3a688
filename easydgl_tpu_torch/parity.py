"""Weight bridge between the JAX package's flax param trees and the port's
``state_dict``s.

The port's modules carry the flax names, so the mapping is one rule:

* ``a/b/kernel`` (flax Dense, stored (in, out)) <-> ``a.b.weight`` (stored
  (out, in), as ``nn.Linear``), transposed;
* every other leaf ``a/b/c`` <-> ``a.b.c`` unchanged (``lookup_table``,
  ``intensity_*``, ``gamma``/``beta``, ``output_bias``, ``bias``).

``load_state_dict`` (strict) then checks that the tree holds exactly the
model's parameters. ``tf_adam_state_to_torch`` / ``tf_adam_state_to_flax``
carry the TF-Adam optimizer state (count, mu, nu) the same way, so a JAX
``TrainState`` after k steps can be continued in the port and back. ``random_flax_params`` draws a tree with the flax
initializers of ``easydgl_tpu.models.easydgl.EasyDGL.init`` from a numpy
seed, so a full-width model can be built without JAX.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import numpy as np
import torch

from easydgl_tpu_torch.config import Config


def _leaves(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def flax_to_torch(params: Dict) -> "OrderedDict[str, torch.Tensor]":
    """flax param tree (nested dicts of arrays, with or without the top
    ``params`` collection) -> fp32 CPU ``state_dict``."""
    if set(params) == {"params"}:
        params = params["params"]
    out = OrderedDict()
    for path, leaf in _leaves(params):
        arr = np.asarray(leaf, dtype=np.float32)
        if path[-1] == "kernel":
            path = path[:-1] + ("weight",)
            arr = arr.T
        out[".".join(path)] = torch.tensor(arr)
    return out


def torch_to_flax(state_dict: Dict[str, torch.Tensor]) -> Dict:
    """Inverse of ``flax_to_torch``: -> {"params": nested numpy dicts}."""
    tree: Dict = {}
    for name, tensor in state_dict.items():
        path = name.split(".")
        arr = tensor.detach().cpu().float().numpy()
        if path[-1] == "weight":
            path[-1] = "kernel"
            arr = arr.T
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return {"params": tree}


def tf_adam_state_to_torch(count, mu: Dict, nu: Dict, device="cpu"):
    """The JAX TF-Adam state (``count`` and the ``mu`` / ``nu`` trees, as
    numpy) -> the port's ``TFAdamState`` on ``device``."""
    from easydgl_tpu_torch.train.optim import TFAdamState

    def tensors(tree):
        return {k: v.to(device) for k, v in flax_to_torch(tree).items()}

    return TFAdamState(int(np.asarray(count)), tensors(mu), tensors(nu))


def tf_adam_state_to_flax(state) -> tuple:
    """The port's ``TFAdamState`` -> (count as int32, mu tree, nu tree) in
    the flax layout of ``torch_to_flax``."""
    return (np.int32(state.count), torch_to_flax(state.mu),
            torch_to_flax(state.nu))


def random_flax_params(cfg: Config, seed: int) -> Dict:
    """An EasyDGL flax param tree drawn with flax's initializers: glorot-
    uniform Dense kernels and embedding tables, normal(0.02) for the fused
    QKVT kernel, zero biases / scalings / output bias, unit LN gammas."""
    rng = np.random.default_rng(seed)
    c, h, e = cfg.num_units, cfg.num_heads, cfg.num_events
    dh = c // h
    v = cfg.num_items + 1

    def glorot(n_in, n_out):
        lim = np.sqrt(6.0 / (n_in + n_out))
        return rng.uniform(-lim, lim, (n_in, n_out)).astype(np.float32)

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    def dense(n_in, n_out):
        return {"kernel": glorot(n_in, n_out), "bias": zeros(n_out)}

    def ln():
        return {"gamma": np.ones((c,), np.float32), "beta": zeros(c)}

    p: Dict = {}
    for i in range(cfg.num_blocks):
        c_in = 3 * c if i == 0 else c
        p[f"block{i}_bimau"] = {
            "qkvt": {"kernel": (0.02 * rng.standard_normal(
                (c_in, 4 * c))).astype(np.float32), "bias": zeros(4 * c)},
            "intensity_dense_kernel": glorot(dh + 1, e * dh),
            "intensity_dense_bias": zeros(e * dh),
            "intensity_weight": glorot(e, dh),
            "intensity_scaling": zeros(e),
        }
        p[f"block{i}_attn_out"] = dense(c, c)
        p[f"block{i}_ln0"] = ln()
        p[f"block{i}_inter"] = dense(c, 2 * c)
        p[f"block{i}_out"] = dense(2 * c, c)
        p[f"block{i}_ln1"] = ln()
    p["item_embs"] = {"lookup_table": glorot(v, c)}
    p["mark_embs"] = {"lookup_table": glorot(e, c)}
    p["pcoding"] = {"pembs": {"lookup_table": glorot(cfg.seqslen + 1, c)}}
    p["out_bias"] = {"output_bias": zeros(v - 1)}
    p["transform"] = dense(c, c)
    p["transform_ln"] = ln()
    return {"params": p}
