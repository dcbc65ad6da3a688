"""Float64 readings of one EasyDGL gradient, to tell which fp32 step is off
when the port's and JAX's disagree (ROADMAP C15). CPU only; like the
tests, it imports both packages.

The batch and weights are ``test_torch_context.py``'s EasyDGL step. Five
readings, each in a process of its own (the float64 ones patch dtypes for
the whole process):

* ``port32``: the port's ``loss_and_grads``;
* ``port64``: the same in float64 (the model and the float features cast,
  fp32 casts made float64);
* ``jit32``: JAX's jitted ``value_and_grad`` (what the tests compare);
* ``eager32``: JAX's ``grad`` run op by op;
* ``jax64``: JAX under ``jax_enable_x64`` with its fp32 casts made float64.

The float64 readings keep the scaled stamps and the time-coding arguments
at their fp32 values, which is how both packages define them. Prints each
reading's largest gap from ``jax64`` over all leaves, as a share of the
leaf's scale (``test_torch_context.grads_close``'s rule), and the gap on
``intensity_scaling``; then JAX's fp32 time coding of the batch's stamps,
jitted and op by op, against sin / cos of its fp32 arguments.

    JAX_PLATFORMS=cpu python tests/torch_float64_readings.py
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
MODES = ("port32", "port64", "jit32", "eager32", "jax64")
LEAF = "block0_bimau.intensity_scaling"


def _fp32_args(inputs, num_units):
    """The time coding's arguments as fp32 computes them, as float64."""
    d = num_units
    scale = np.power(10000.0, np.arange(0, d, 2) / d).astype(np.float32)
    ts = np.asarray(inputs, np.float32)
    return (ts[:, :, None] / scale).astype(np.float32).astype(np.float64)


def _reading(mode: str, out: str) -> None:
    if mode == "port64":
        import torch
        torch.set_default_dtype(torch.float64)
        torch.float32 = torch.float64
        torch.Tensor.float = lambda s, *a, **k: s.double()
    if mode == "jax64":
        import jax
        jax.config.update("jax_enable_x64", True)
        import jax.numpy as jnp
        jnp.float32 = jnp.float64
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(HERE.parent))
    import test_torch_context as tc
    name, kw, seed, mark = tc.STEPS["easydgl"]
    p = tc._model_payload(name, kw, 16, seed, training=True, mark=mark)
    features, labels = p["batches"][0]
    if mode.startswith("port"):
        import torch
        from easydgl_tpu_torch.models import easydgl as peasydgl
        from easydgl_tpu_torch.nn import coding as pcoding
        model = tc.build_model(tc.preset(name, **kw), device="cpu",
                               params=p["params"])
        feats = {k: torch.as_tensor(v) for k, v in features.items()}
        if mode == "port64":
            def code(self, inputs):
                x = torch.from_numpy(_fp32_args(inputs.numpy(),
                                                self.num_units))
                return torch.stack([torch.sin(x), torch.cos(x)], -1).reshape(
                    inputs.shape[0], inputs.shape[1], self.num_units)

            def scaled(seqs_t, time_scale):
                ts = np.asarray(seqs_t.numpy(), np.float32) / np.float32(
                    time_scale)
                return torch.from_numpy(ts.astype(np.float32)).double()
            pcoding.TimeSinusoidCoding.code = code
            peasydgl.scaled_times = scaled
            model = model.double()
            feats = {k: v.double() if v.is_floating_point() else v
                     for k, v in feats.items()}
        _, grads = tc.loss_and_grads(model, feats, torch.as_tensor(labels))
        grads = {n: g.double().numpy() for n, g in grads.items()}
    elif mode == "jit32":
        grads = tc._jax_single(name, kw, p)[1]
        grads = {n: t.double().numpy() for n, t in tc.flax_to_torch(
            tc.jax.tree.map(np.asarray, grads)).items()}
    elif mode == "eager32":
        grads = tc._jax_eager_grads(name, kw, p)
    else:
        import jax
        import jax.numpy as jnp
        from easydgl_tpu.nn import coding as jcoding

        def jcode(self, inputs):
            x = jnp.asarray(_fp32_args(inputs, self.num_units))
            return jnp.stack([jnp.sin(x), jnp.cos(x)], -1).reshape(
                inputs.shape[0], inputs.shape[1], self.num_units)
        jcoding.TimeSinusoidCoding.code = jcode
        jm = tc.jbuild(tc._jcfg(name, kw))
        scale = jm.cfg.time_scale
        jf = {}
        for k, v in features.items():
            v = np.asarray(v)
            if k == "seqs_t":   # so that seqs_t / time_scale is the fp32 ts
                v = (v.astype(np.float32) / np.float32(scale)).astype(
                    np.float32).astype(np.float64) * scale
            jf[k] = jnp.asarray(v.astype(np.float64) if v.dtype.kind == "f"
                                else v)
        params = jax.tree.map(lambda a: jnp.asarray(np.asarray(a),
                                                    jnp.float64),
                              p["params"])
        grads = jax.grad(lambda prm: tc.jsteps.compute_loss(
            jm, prm, jf, jnp.asarray(labels),
            rngs={"dropout": jax.random.key(7)}))(params)
        grads = {n: t.double().numpy() for n, t in tc.flax_to_torch(
            jax.tree.map(lambda a: np.asarray(a, np.float64),
                         grads)).items()}
    np.savez(out, **grads)


def _coding_gaps():
    """JAX's fp32 ``TimeSinusoidCoding.code`` of the batch's scaled stamps,
    jitted and op by op: the largest gap from sin / cos of its own fp32
    arguments taken in float64."""
    import jax
    import jax.numpy as jnp
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(HERE.parent))
    import test_torch_context as tc
    from easydgl_tpu.nn.coding import TimeSinusoidCoding
    name, kw, seed, mark = tc.STEPS["easydgl"]
    p = tc._model_payload(name, kw, 16, seed, training=True, mark=mark)
    d = kw["num_units"]
    ts = (np.asarray(p["features"]["seqs_t"], np.float32)
          / np.float32(tc.jpreset(name).time_scale)).astype(np.float32)
    x = _fp32_args(ts, d)
    want = np.stack([np.sin(x), np.cos(x)], -1).reshape(*ts.shape, d)
    coding = TimeSinusoidCoding(d)
    eager = np.asarray(coding.code(jnp.asarray(ts)), np.float64)
    jitted = np.asarray(jax.jit(coding.code)(jnp.asarray(ts)), np.float64)
    return dict(jitted=float(np.abs(jitted - want).max()),
                eager=float(np.abs(eager - want).max()),
                days=[float(ts[ts > 0].min()), float(ts.max())])


def main() -> int:
    if len(sys.argv) == 3:
        _reading(sys.argv[1], sys.argv[2])
        return 0
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        got = {}
        for mode in MODES:
            path = os.path.join(tmp, mode + ".npz")
            subprocess.run([sys.executable, __file__, mode, path], env=env,
                           check=True)
            got[mode] = dict(np.load(path))
    ref = got["jax64"]
    top = max(float(np.abs(v).max()) for v in ref.values())
    res = {}
    for mode in MODES[:-1]:
        gaps = {}
        for n, w in ref.items():
            scale = max(float(np.abs(w).max()), 1e-3 * top)
            gaps[n] = float(np.abs(got[mode][n] - w).max()) / scale
        res[mode] = dict(worst=max(gaps.values()),
                         intensity_scaling=gaps[LEAF])
    res["time_coding"] = _coding_gaps()
    print(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
