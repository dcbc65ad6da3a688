"""Weight bridge between the JAX package's flax param trees and the port's
``state_dict``s.

The port's modules carry the flax names, so the mapping is one rule:

* ``a/b/kernel`` (flax Dense, stored (in, out)) <-> ``a.b.weight`` (stored
  (out, in), as ``nn.Linear``), transposed;
* every other leaf ``a/b/c`` <-> ``a.b.c`` unchanged (``lookup_table``,
  ``intensity_*``, ``gamma``/``beta``, ``output_bias``, ``bias``, GREC's
  3-D convolution ``weight`` (W, I, O) and ``head_kernel``, TimelyREC's
  0-d ``te_weight``).

``load_state_dict`` (strict) then checks that the tree holds exactly the
model's parameters. ``tf_adam_state_to_torch`` / ``tf_adam_state_to_flax``
carry the TF-Adam optimizer state (count, mu, nu) the same way, so a JAX
``TrainState`` after k steps can be continued in the port and back.
``random_flax_params`` draws a tree of the JAX model's ``init`` layout, which
each model class gives (``flax_layout``), with flax's initializers from a
numpy seed, so a full-width model can be built without JAX.
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
        if path[-1] == "weight" and arr.ndim == 2:
            path[-1] = "kernel"
            arr = arr.T
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        # np.array, not np.ascontiguousarray, which makes a 0-d leaf 1-d
        node[path[-1]] = np.array(arr, order="C")
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


class FlaxInit:
    """flax's initializers, drawn in call order from one numpy generator:
    glorot-uniform Dense kernels and embedding tables, truncated normals,
    zero biases, unit LayerNorm gammas. A model's ``flax_layout`` builds
    its tree with it; the recurrent models' kernels are per-gate
    orthogonal."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def glorot(self, n_in: int, n_out: int) -> np.ndarray:
        lim = np.sqrt(6.0 / (n_in + n_out))
        return self.rng.uniform(-lim, lim, (n_in, n_out)).astype(np.float32)

    def normal(self, std: float, *shape) -> np.ndarray:
        return (std * self.rng.standard_normal(shape)).astype(np.float32)

    def truncated_normal(self, std: float, *shape) -> np.ndarray:
        """``jax.nn.initializers.truncated_normal(std)``: a standard normal
        truncated to (-2, 2), by rejection, times ``std``, with no variance
        correction (its std is ~0.88 std)."""
        n = int(np.prod(shape))
        out = np.empty(0)
        while out.size < n:
            draw = self.rng.standard_normal(n - out.size)
            out = np.concatenate([out, draw[np.abs(draw) < 2.0]])
        return (std * out.reshape(shape)).astype(np.float32)

    def orthogonal(self, n_rows: int, n_cols: int) -> np.ndarray:
        """``flax.linen.initializers.orthogonal()``: the Q of a normal
        draw's QR, its columns' signs set by R's diagonal; orthonormal
        rows or columns, whichever are fewer."""
        a = self.rng.standard_normal((max(n_rows, n_cols),
                                      min(n_rows, n_cols)))
        q, r = np.linalg.qr(a)
        q = q * np.sign(np.diag(r))
        return (q if n_rows >= n_cols else q.T).astype(np.float32)

    def per_gate_orthogonal(self, in_c: int, c: int, gates: int
                            ) -> np.ndarray:
        """The JAX ``nn.rnn.per_gate_orthogonal`` kernel (in_c, gates * c):
        each gate's block an independent orthogonal (c, in_c) matrix,
        transposed (the reference's per-gate ``tf.orthogonal_initializer``
        of shape (num_units, input_size))."""
        return np.concatenate([self.orthogonal(c, in_c).T
                               for _ in range(gates)], axis=1)

    @staticmethod
    def zeros(*shape) -> np.ndarray:
        return np.zeros(shape, np.float32)

    @staticmethod
    def ones(*shape) -> np.ndarray:
        return np.ones(shape, np.float32)

    def dense(self, n_in: int, n_out: int) -> Dict:
        return {"kernel": self.glorot(n_in, n_out), "bias": self.zeros(n_out)}

    @staticmethod
    def time_function(width: int) -> Dict:
        """``TimeFunctionCoding``'s leaves: ``basis_freq = linspace(0, 9,
        C)``, ``phase = 0`` (no draw)."""
        return {"basis_freq": np.linspace(0, 9, width).astype(np.float32),
                "phase": np.zeros((width,), np.float32)}

    @staticmethod
    def ln(width: int) -> Dict:
        return {"gamma": np.ones((width,), np.float32),
                "beta": np.zeros((width,), np.float32)}


def random_flax_params(cfg: Config, seed: int) -> Dict:
    """A flax param tree of ``cfg.model``'s layout (its class's
    ``flax_layout``, the tree of the JAX model's ``init``) drawn from
    ``seed`` with flax's initializers (``FlaxInit``)."""
    from easydgl_tpu_torch.models.registry import model_class
    return {"params": model_class(cfg).flax_layout(cfg, FlaxInit(seed))}
