"""The CSC heads' train step against the JAX package's
``make_csc_train_step``, on the CPU, with the helpers and tolerance of
``tests/test_torch_wsod_heads.py`` (the toy flagship config, float32,
dropout 0, 3 steps from the same weights, rtol 1e-4 and atol 1e-5 on every
loss and ``csc/*`` metric at every step and on the final trainable
parameters; frozen parameters bit-unchanged). ``tau`` is 0: the image
probabilities of random weights sit far below the default 0.7, which would
zero every CPG map.

  * CSC at ``FREEZE_AT 2``: live CPG maps through the trainable stages and
    the differentiable pool; W differs from 1 at every step;
  * CSC at ``FREEZE_AT 5``: the JAX package stops the gradient at the
    backbone's output, so the maps are zero and W = 1 at every step;
  * CSC + OICR at ``FREEZE_AT 2``.

Each batch's first proposals cover nearly the whole 64x64 image, so their
context clips away and their contrast is positive: with only the random
boxes every contrast is negative and the weights are all 1, which would
prove nothing."""

import pytest
import torch

from test_torch_wsod_heads import (check_final_trainable_params,
                                   check_frozen_unchanged_and_trainable_moved,
                                   check_losses_and_metrics, run_case)

torch.set_num_threads(1)

CASES = {
    "csc_freeze_at_2": ("CSCROIHeads", 2),
    "csc_freeze_at_5": ("CSCROIHeads", 5),
    "csc_oicr": ("CSCOICRROIHeads", 2),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def trajectories(request):
    return run_case(request.param, *CASES[request.param])


def test_losses_and_metrics_match_at_every_step(trajectories):
    check_losses_and_metrics(trajectories)


def test_final_trainable_params_match(trajectories):
    check_final_trainable_params(trajectories)


def test_frozen_params_bit_unchanged_and_trainable_moved(trajectories):
    check_frozen_unchanged_and_trainable_moved(trajectories)
