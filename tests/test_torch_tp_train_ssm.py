"""Training under tensor parallelism on 4 gloo ranks on the CPU for the
SSM, hybrid and audio families, held as tests/test_torch_tp_train.py holds
the dense and MoE ones (its docstring says what (a)-(d) are; the harness
is tests/_tp_train.py).

Cases, under ``dp_tp`` on a (2, 2) ("data", "model") mesh:

* mamba2-780m: ``w_in``'s columns gathered, the conv on the rank's
  channels, the scan on the rank's heads, the gated RMSNorm's sum of
  squares all-reduced, ``w_out``'s rows;
* hymba-1.5b: attention by KV heads beside the rank's SSM heads;
* whisper-tiny: the encoder, the decoder's self-attention and its
  cross-attention over the encoder's keys and values, by heads.
"""

import pytest

from _tp_train import (check_first_loss, check_gradients, check_split,
                       check_steps, run_cases, tag)

CASES = [("mamba2-780m", "dp_tp", (2, 2), {}),
         ("hymba-1.5b", "dp_tp", (2, 2), {}),
         ("whisper-tiny", "dp_tp", (2, 2), {})]
IDS = [tag(*c) for c in CASES]


@pytest.fixture(scope="module")
def runs():
    return run_cases(CASES)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_gradients_equal_the_unsharded_port_in_fp32(runs, case):
    check_gradients(runs, case)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_steps_equal_the_unsharded_step_in_bf16(runs, case):
    check_steps(runs, case)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_first_loss_equals_the_reference(runs, case):
    check_first_loss(runs, case)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_weights_stay_split_and_activations_cross(runs, case):
    check_split(runs, case)
