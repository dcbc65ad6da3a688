"""PyTorch port: TGAT (serving and the train step) vs the JAX package, on
the CPU, in each form of its Bochner time attention (``attention_impl``
``"xla"``: the dense codes; ``"factored"``; ``"flash"``: the port's plain
flash version, JAX's flash kernel through its plain reference,
``torch_model_checks.jax_flash_reference``).

TGAT (C = 16, H = 2, 2 blocks, L = 12, the preset's time_scale of a day)
through ``torch_model_checks``: eval logits to 1e-4, eval-step sums and
``recommend``, one train step (loss 1e-5 relative, every gradient to 1e-4
of its leaf's scale, the TF-Adam update), the random param tree. The JAX
side runs op by op (``make_world(op_by_op=True)``), not jitted: its jitted
CPU program divides the stamps by time_scale as a product with the fp32
reciprocal, which moves a stamp of ~1e9 s by an ulp and each cos argument
by up to ~9e-3 rad. The padding's query rows are re-masked after every
block, so no large-argument trig of a pad key's span reaches the loss.

Dropout is 0 where the two sides are compared; weights come from JAX
``init`` with non-zero biases and output bias. The modules are held in
``test_torch_bochner.py``.
"""
import jax
import numpy as np
import pytest
import torch

from easydgl_tpu.config import preset as jpreset
from easydgl_tpu.data.loader import BatchLoader as JBatchLoader
from easydgl_tpu.data.synthetic import synthetic_split
from easydgl_tpu.models.registry import build_model as jbuild
from easydgl_tpu.nn.layers import use_compute_dtype
from easydgl_tpu_torch.config import preset
from easydgl_tpu_torch.models.registry import build_model
from torch_model_checks import (_nonzero, check_eval_logits,
                                check_eval_step_and_recommend,
                                check_random_tree, check_step, jfeats,
                                make_world, model_context, port, tfeats)

torch.set_num_threads(2)
SMALL = dict(num_items=50, seqslen=12, num_units=16, num_heads=2,
             num_blocks=2, batch_size=4, hidden_dropout_rate=0.0,
             attention_probs_dropout_rate=0.0, l2_reg=1e-4)


@pytest.fixture(scope="module", params=["xla", "factored", "flash"])
def world(request):
    form = request.param
    return make_world("TGAT", dict(SMALL, attention_impl=form), 7,
                      op_by_op=True, context=lambda: model_context(form))


def test_tgat_eval_logits_match_jax(world):
    check_eval_logits(world)


def test_tgat_eval_step_and_recommend_match_jax(world):
    check_eval_step_and_recommend(world)


def test_tgat_train_step_matches_jax(world):
    check_step(world, port(world))


def test_tgat_random_tree_matches_jax_layout(world):
    check_random_tree(world)


def test_tgat_bf16_flash_key_rounding_stays_within_bf16_noise():
    """In bf16 the port's flash form rounds the whole augmented key to bf16
    (its kernels take one dtype), where JAX's concatenates bf16 k with fp32
    position codes and multiplies in fp32. Eval logits of both sides' bf16
    flash forms (JAX op by op under its compute dtype, its flash kernel
    through its plain reference) are held to 2e-2 of the largest live
    logit, bf16's tolerance; printed beside that distance, for scale, the
    one between JAX's own bf16 and fp32 flash forms."""
    ds = synthetic_split(num_rows=8, num_items=50, seqslen=12, seed=7)
    ef = next(JBatchLoader(ds, data_mode="regressive", batch_size=4,
                           is_training=False, use_native=False).epoch(0))[0]
    logits, params = {}, None
    for dtype in ("bfloat16", "float32"):
        kw = dict(SMALL, attention_impl="flash", compute_dtype=dtype)
        jcfg = jpreset("TGAT").replace(use_pallas=False, **kw)
        jm = jbuild(jcfg)
        with model_context("flash"):
            if params is None:
                params = _nonzero(jax.tree.map(np.asarray, jm.init(
                    {"params": jax.random.key(0)}, jfeats(ef),
                    is_training=False)), np.random.default_rng(5))
            with jax.disable_jit(), use_compute_dtype(jcfg.matmul_dtype):
                logits["jax", dtype] = np.asarray(jm.apply(
                    params, jfeats(ef), is_training=False)[0], np.float32)
        if dtype == "bfloat16":
            with torch.no_grad():
                model = build_model(preset("TGAT", **kw), device="cpu",
                                    params=params)
                logits["port", dtype] = model(tfeats(ef))[0].float().numpy()
    live = logits["jax", "float32"] > -500   # not the padding item's column
    scale = float(np.abs(logits["jax", "float32"][live]).max())

    def apart(a, b):
        return float(np.abs(logits[a] - logits[b])[live].max()) / scale

    flash = apart(("port", "bfloat16"), ("jax", "bfloat16"))
    noise = apart(("jax", "bfloat16"), ("jax", "float32"))
    print(f"bf16 TGAT flash logits, max |difference| / max |logit|: port vs"
          f" JAX {flash:.3e}; JAX bf16 vs JAX fp32 {noise:.3e}")
    assert flash <= 2e-2
