"""PyTorch port: TimelyREC's ``"flash"`` form (its user tower through the
flash attention wrappers: the plain flash version on the CPU) vs the JAX
package's, whose flash kernel runs through its plain reference
(``torch_model_checks.jax_flash_reference``), on the CPU; the setting and
the checks of ``test_torch_timelyrec.py`` (ETL-style pads, JAX op by op):
eval logits to 1e-4, eval-step sums and ``recommend``, one train step
(loss 1e-5 relative, every gradient to 1e-4 of its leaf's scale, the
TF-Adam update).
"""
import pytest
import torch

from torch_model_checks import (check_eval_logits,
                                check_eval_step_and_recommend, check_step,
                                etl_pads, make_world, model_context, port)

torch.set_num_threads(2)
SMALL = dict(num_items=50, seqslen=12, num_units=16, num_heads=2,
             batch_size=4, hidden_dropout_rate=0.0,
             attention_probs_dropout_rate=0.0, l2_reg=1e-4)


@pytest.fixture(scope="module")
def world():
    return make_world("TimelyREC", dict(SMALL, attention_impl="flash"), 7,
                      op_by_op=True, context=lambda: model_context("flash"),
                      data=etl_pads)


def test_timelyrec_flash_eval_logits_match_jax(world):
    check_eval_logits(world)


def test_timelyrec_flash_eval_step_and_recommend_match_jax(world):
    check_eval_step_and_recommend(world)


def test_timelyrec_flash_train_step_matches_jax(world):
    check_step(world, port(world))
