"""PyTorch port: GRU4REC and S2PNM (serving and the train step) vs the JAX
package, on the CPU.

Each model at C = 16, L = 8, B = 4, V = 50 (GRU4REC with 2 GRU layers,
S2PNM with 2 heads), weights from JAX ``init`` with non-zero biases and
output bias, dropout 0 (the two sides' PRNG streams differ by design):

* eval logits against the JAX model run op by op, to 1e-4;
* eval-step sums over the regressive protocol's batches, and
  ``Recommender.recommend`` top-k (ids equal, scores to 1e-4);
* one ``build_train_step`` step: the loss to 1e-5 relative, every
  gradient leaf to 1e-4 of its scale against JAX ``value_and_grad``, and
  the parameters after the TF-Adam update (the presets' beta2 0.98,
  eps 1e-9, global-norm clip 5, and GRU4REC's also with a clip under its
  gradient's norm) within the bound that a gradient known to
  that tolerance allows (``torch_model_checks.check_step``); the loss
  against JAX ``build_train_step``'s too;
* the random param tree against JAX ``init``, and each preset at full
  width (C = 512) on the CPU.
"""
import pytest
import torch

from easydgl_tpu.data.synthetic import synthetic_split
from easydgl_tpu_torch.config import preset
from easydgl_tpu_torch.data.loader import BatchLoader
from easydgl_tpu_torch.models.registry import build_model
from torch_model_checks import (check_eval_logits,
                                check_eval_step_and_recommend,
                                check_random_tree, check_step, make_world,
                                port, tfeats)

torch.set_num_threads(2)
V, L, B = 50, 8, 4
SMALL = dict(num_items=V, seqslen=L, num_units=16, batch_size=B,
             hidden_dropout_rate=0.0, attention_probs_dropout_rate=0.0,
             l2_reg=1e-4)
KW = {"GRU4REC": dict(SMALL, num_blocks=2, num_heads=1),
      "S2PNM": dict(SMALL, num_blocks=1, num_heads=2)}
NAMES = tuple(KW)


@pytest.fixture(scope="module", params=NAMES)
def world(request):
    return make_world(request.param, KW[request.param], 7)


def test_eval_logits_match_jax(world):
    check_eval_logits(world)


def test_eval_step_and_recommend_match_jax(world):
    check_eval_step_and_recommend(world)


def test_train_step_matches_jax(world):
    opt = world["jcfg"].optim
    assert (opt.beta2, opt.eps, opt.clip_norm) == (0.98, 1e-9, 5.0)
    check_step(world, port(world))


def test_train_step_clips_as_jax():
    """GRU4REC's step with the clip at 0.1, under its gradient's global
    norm (~0.5 here, below the preset's 5): the step scales the gradients
    by clip / norm before TF-Adam, as JAX's."""
    world = make_world("GRU4REC", KW["GRU4REC"], 7, clip_norm=0.1)
    assert check_step(world, port(world)) < 0.5


def test_random_tree_matches_jax_init(world):
    check_random_tree(world)


def test_training_forward_needs_a_generator_for_dropout(world):
    model = port(world, hidden_dropout_rate=0.1)
    feats = tfeats(world["train"][0])
    with pytest.raises(ValueError, match="Generator"):
        model(feats, is_training=True)
    none, aux = model(feats, is_training=True,
                      generator=torch.Generator().manual_seed(0))
    assert none is None
    hidden, table, bias = aux["scoring"]
    assert hidden.shape == (B * L, 16) and table.shape == (V, 16)
    assert bool(torch.isfinite(hidden).all())


@pytest.mark.parametrize("name", NAMES)
def test_presets_build_on_the_cpu(name):
    """Full width (C = 512; S2PNM's one head of 512), random weights from
    the seed; an eval forward on two short rows."""
    cfg = preset(name, num_items=300, seqslen=12)
    model = build_model(cfg, device="cpu")
    assert type(model).__name__ == name
    assert model.gru.r_0.shape == (512, 1536)
    ds = synthetic_split(num_rows=2, num_items=300, seqslen=12, seed=1)
    f, _, _ = next(BatchLoader(ds, data_mode=model.data_mode, batch_size=2,
                               is_training=False).epoch(0))
    with torch.no_grad():
        logits, _ = model(tfeats(f))
    assert logits.shape == (2, 300) and bool(torch.isfinite(logits).all())
