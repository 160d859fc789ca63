"""The port stands alone: it imports neither jax nor anything of ``repro``,
its entry points refuse CUDA on a machine without a GPU (no fallback to the
CPU), and its copies of the JAX package's data and digests are exact."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.fingerprint import dag_fingerprint as jdag_fingerprint  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.core.fingerprint import dag_fingerprint  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
sys.path.insert(0, sys.argv[1])
import chip_smoke
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LOADED", len([n for n in sys.modules if n.startswith("repro_torch")]))
print("BAD", bad)
"""


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL, str(ROOT)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert int(out.stdout.split("LOADED")[1].split()[0]) >= 20


def _needs_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: CUDA requests succeed here")


def test_entry_points_refuse_cuda_without_a_gpu():
    _needs_no_gpu()
    cfg = get_config("gemma-2b").reduced()
    model = build_model(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        model.init(torch.Generator(), device="cuda")
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(model, params)                 # cuda is the default
    with pytest.raises(RuntimeError, match="cuda"):
        model.init_cache(1, 8)
    ssm = build_model(get_config("mamba2-780m").reduced())
    with pytest.raises(RuntimeError, match="cuda"):
        ssm.init(torch.Generator(), device="cuda")
    ssm_params = ssm.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(ssm, ssm_params)
    with pytest.raises(RuntimeError, match="cuda"):
        ssm.init_cache(1, 8)
    with pytest.raises(ValueError, match="backend"):
        ops.set_backend("cuda")


@pytest.mark.parametrize("aid", ARCH_IDS)
def test_config_copies_equal_their_counterparts(aid):
    assert dataclasses.asdict(get_config(aid)) == \
        dataclasses.asdict(jget_config(aid))
    assert dataclasses.asdict(get_config(aid).reduced()) == \
        dataclasses.asdict(jget_config(aid).reduced())


def test_dag_fingerprint_equals_the_jax_digest():
    from test_serving import _toy_cache

    _, dag = _toy_cache()
    ours = dag_fingerprint(dataclasses.replace(dag))      # fresh instances:
    theirs = jdag_fingerprint(dataclasses.replace(dag))   # no memo shared
    assert ours == theirs
    two = dataclasses.replace(dag, name="toy_b", blocks=dag.blocks[:-1])
    assert dag_fingerprint(two) == jdag_fingerprint(dataclasses.replace(two))
    assert dag_fingerprint(two) != ours
