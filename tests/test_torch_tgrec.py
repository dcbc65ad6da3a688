"""PyTorch port: TGREC (serving and the train step) vs the JAX package, on
the CPU, in two forms of its Bochner time attention (``attention_impl``
``"xla"``: the dense codes; ``"factored"``); its ``"flash"`` form is held
in ``test_torch_tgrec_flash.py`` (one file each, so that each stays
under ~40 s: most of their time is JAX compiling each op once).

TGREC (C = 16, H = 2, 2 blocks, L = 12, the preset's time_scale of a day)
through ``torch_model_checks``: eval logits to 1e-4, eval-step sums and
``recommend``, one train step (loss 1e-5 relative, every gradient to 1e-4
of its leaf's scale, the TF-Adam update), the random param tree. The JAX
side runs op by op (``make_world(op_by_op=True)``), not jitted: its jitted
CPU program divides the stamps by time_scale as a product with the fp32
reciprocal, which moves a stamp of ~1e9 s by an ulp and each cos argument
by up to ~9e-3 rad. TGREC does not re-mask its padding's query rows:
the boundary pad row, which carries loss weight, attends uniformly over
pad keys whose spans reach ~1.2e4 days (cos arguments ~1e5 rad), and the
two sides, each computing one form, agree there at these tolerances.

Dropout is 0 where the two sides are compared; weights come from JAX
``init`` with non-zero biases and output bias. The modules are held in
``test_torch_bochner.py``.
"""
import pytest
import torch

from torch_model_checks import (check_eval_logits,
                                check_eval_step_and_recommend,
                                check_random_tree, check_step, make_world,
                                model_context, port)

torch.set_num_threads(2)
SMALL = dict(num_items=50, seqslen=12, num_units=16, num_heads=2,
             num_blocks=2, batch_size=4, hidden_dropout_rate=0.0,
             attention_probs_dropout_rate=0.0, l2_reg=1e-4)


@pytest.fixture(scope="module", params=["xla", "factored"])
def world(request):
    form = request.param
    return make_world("TGREC", dict(SMALL, attention_impl=form), 7,
                      op_by_op=True, context=lambda: model_context(form))


def test_tgrec_eval_logits_match_jax(world):
    check_eval_logits(world)


def test_tgrec_eval_step_and_recommend_match_jax(world):
    check_eval_step_and_recommend(world)


def test_tgrec_train_step_matches_jax(world):
    check_step(world, port(world))


def test_tgrec_random_tree_matches_jax_layout(world):
    check_random_tree(world)
