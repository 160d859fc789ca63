"""Training under tensor parallelism (``sharding.spmd.make_sharded_grad_fn``
and ``make_sharded_train_step`` with one ``tp_axes`` axis) on 4 gloo ranks
on the CPU, against the port's unsharded ``train_loop`` and the
reference's single-device ``make_train_step``: the dense and MoE families.
tests/test_torch_tp_train_ssm.py holds the SSM, hybrid and audio families
alike; tests/_tp_train.py is the harness both use.

Cases, on reduced configurations from the reference's initialisation
(``from_jax``), MoE capacity factors raised to 8 so that no assignment is
dropped in either lowering (tests/test_torch_sharded_step.py):

* on a (2, 2) ("data", "model") mesh: gemma-2b under ``dp_tp`` and
  ``dp_tp_fsdp`` (remat on); qwen3-moe-30b-a3b under ``dp_tp`` (the dense
  oracle over the rank's experts), ``dp_tp_ep`` (two microbatches) and
  ``dp_tp_fsdp_ep_q8``;
* on a (1, 4) mesh: gemma-2b under ``dp_tp`` and qwen3-moe-30b-a3b under
  ``dp_tp_ep``.

Held, each case:

(a) with the port computing in fp32 (``layers.COMPUTE_DTYPE``, as
    tests/test_torch_ssd_train.py's ``_compute_in`` switches it), every
    gradient leaf of the tp step against the unsharded port's, by relative
    norm, within ``GRAD_RTOL`` (1e-4): a gradient dropped at a crossing,
    or counted once per rank, parts by 1 or more;
(b) in bf16, two steps against the unsharded ``make_train_step``: losses
    at ``LOSS_RTOL`` and parameters at (i + 1)·``PARAM_ATOL``
    (tests/test_torch_sharded_step.py's limits); the first clip norm at
    ``BF16_NORM_RTOL`` (1e-2) against the unsharded step's and the exact
    one (the unsharded step's in fp32).  The tp step sums bf16 partial
    products across ranks, so it does not round where the unsharded step
    does (tests/test_torch_sharded_step.py's 1e-3 holds steps that compute
    the same products), and reduced qwen3's bf16 clip norm parts from its
    fp32 one by 6.4e-3 in the unsharded step itself (this harness's
    ``norm_fp32`` beside the unsharded step's norm);
(c) the first loss against the reference's single-device
    ``make_train_step`` (a JAX subprocess, started beside the ranks) at
    ``LOSS_RTOL``; the reference serves ``moe_dense`` without a mesh;
(d) every leaf split over ``model`` reached the layers as its shard, and
    the collectives issued over ``model`` include an all-reduce.

The VLM (llama-3.2-vision-11b) trains under ``dp_tp`` in the dry-run only
(tests/test_torch_dryrun.py and the dry-run's cells on the card).
"""

import pytest

from _tp_train import (GEMMA, QWEN3, check_first_loss, check_gradients,
                       check_split, check_steps, run_cases, tag)

# (arch, layout, mesh, plan overrides)
CASES = [(GEMMA, "dp_tp", (2, 2), {}),
         (GEMMA, "dp_tp_fsdp", (2, 2), {"remat": True}),
         (QWEN3, "dp_tp", (2, 2), {}),
         (QWEN3, "dp_tp_ep", (2, 2), {"microbatches": 2}),
         (QWEN3, "dp_tp_fsdp_ep_q8", (2, 2), {}),
         (GEMMA, "dp_tp", (1, 4), {}),
         (QWEN3, "dp_tp_ep", (1, 4), {})]
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
