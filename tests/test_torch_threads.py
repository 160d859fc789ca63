"""One torch intra-op thread in every process of the tier-1 run.

The tier-1 run is ``pytest -n 6 --dist loadfile``: six xdist workers share
the host's cores.  Left alone, torch sizes each worker's intra-op pool to
the whole machine, so six pools of eight threads contend for eight cores,
beside XLA's own pool in the same workers.  The port's tests run many
small-tensor ops, and each forks and joins across threads that are
descheduled.  On an 8-core host,
``test_torch_training.py::test_train_cli_on_the_cpu_learns_checkpoints_and_resumes``
took 618.3 s in a full tier-1 run and 4.5 s alone; the port's tests took
3581 of the run's 5160 test-seconds.

So this module sets one thread at import.  pytest collects every test
module before it runs any test, and under xdist every worker collects the
whole suite, so the setting holds in every worker for the whole session,
whichever files the worker is given, the JAX package's among them.
``OMP_NUM_THREADS`` also reaches every Python process the tests start,
since they inherit ``os.environ``: the ``repro_torch.launch`` CLIs, the
import-isolation checks and the spawned gloo ranks (which also call
``torch.set_num_threads(1)`` themselves).

The setting is not in ``conftest.py`` because that file and
``pyproject.toml`` belong to the JAX package's tests, which the port leaves
as they are.  Run alone (``pytest tests/test_torch_x.py``), a port file does
not collect this module and keeps torch's default, with no other worker to
contend with.  XLA's pool is not sized here.
"""

import os

import pytest

os.environ["OMP_NUM_THREADS"] = "1"
torch = pytest.importorskip("torch")
torch.set_num_threads(1)


def test_torch_runs_on_one_thread_in_this_worker():
    assert torch.get_num_threads() == 1
    assert os.environ["OMP_NUM_THREADS"] == "1"
