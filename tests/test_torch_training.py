"""The port's training substrate — ``training.optimizer``, ``checkpoint``
(with its own MessagePack codec), ``data``, ``runtime.fault_tolerance`` and
the ``launch.train`` CLI — on the CPU.

The cases of ``tests/test_training.py``, and
``tests/test_arch_smoke.py::test_train_step_decreases_loss`` for every
architecture, run here on the port's classes: each test function is called
with its module's names rebound to the port's (``_on``), ``jnp``/``jax``/
``np`` to thin torch-backed stand-ins, so the cases are the same code, not
copies of it.  Beside them: the codec's bytes against
``msgpack``, checkpoints restored across the two packages, and the synthetic
batches byte for byte.
"""

import os
import types

import msgpack
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_arch_smoke as arch_cases  # noqa: E402
import test_training as cases  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import optimizer as joptim  # noqa: E402
from repro.training.data import SyntheticDataset as JSyntheticDataset  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import (from_jax,  # noqa: E402
                                        opt_state_from_jax, to_numpy)
from repro_torch.runtime.fault_tolerance import (  # noqa: E402
    CheckpointPolicy, FaultTolerantRunner, StragglerPolicy)
from repro_torch.sharding.plan import SINGLE_POD, ShardingPlan  # noqa: E402
from repro_torch.training import _msgpack, tree  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training import optimizer as optim  # noqa: E402
from repro_torch.training.data import SyntheticDataset  # noqa: E402
from repro_torch.training.train_loop import make_train_step  # noqa: E402


# --------------------------------------------------------------------------
# Stand-ins for the names the reference cases call
# --------------------------------------------------------------------------

_TORCH_NP = types.SimpleNamespace(
    asarray=lambda x, dtype=None: torch.as_tensor(x, dtype=dtype),
    zeros=lambda shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype),
    ones=lambda shape, dtype=torch.float32: torch.ones(shape, dtype=dtype),
    arange=lambda n, dtype=None: torch.arange(n, dtype=dtype),
    float32=torch.float32, bfloat16=torch.bfloat16, int32=torch.int32)


def _randint(key, shape, lo, hi):
    gen = torch.Generator().manual_seed(int(np.asarray(key).sum()))
    return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32)


_TORCH_JAX = types.SimpleNamespace(
    tree=types.SimpleNamespace(leaves=tree.leaves),
    random=types.SimpleNamespace(
        PRNGKey=lambda seed: torch.Generator().manual_seed(seed),
        randint=_randint))


def _np_asarray(x, dtype=None):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        x = (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x, dtype)


_NP = types.SimpleNamespace(**{k: getattr(np, k) for k in dir(np)
                               if not k.startswith("__")})
_NP.asarray = _np_asarray


def _batch(cfg, key):
    """``tests/test_arch_smoke.py::_batch``'s tensors (shapes, ranges, the
    stub frontends' 0.1 scale in bf16), drawn with torch."""
    b, s = arch_cases.B, arch_cases.S
    gen = torch.Generator().manual_seed(int(np.asarray(key).sum()))
    out = {name: torch.randint(0, cfg.vocab, (b, s), generator=gen,
                               dtype=torch.int32)
           for name in ("tokens", "targets")}
    rows = {"audio": s // 2, "vlm": cfg.n_vision_tokens}.get(cfg.family)
    if rows is not None:
        name = "frames" if cfg.family == "audio" else "vision"
        out[name] = (torch.randn((b, rows, cfg.d_model), generator=gen)
                     .to(torch.bfloat16) * 0.1)
    return out


class _CpuModel:
    """The port's model with ``init(generator)`` on the CPU (the port's
    entry points default to cuda)."""

    def __init__(self, cfg):
        self.model = build_model(cfg)

    def init(self, gen):
        return self.model.init(gen, device="cpu")

    def __getattr__(self, name):
        return getattr(self.model, name)


PORT_NAMES = dict(
    jnp=_TORCH_NP, jax=_TORCH_JAX, np=_NP, optim=optim, ckpt=ckpt,
    CheckpointPolicy=CheckpointPolicy, FaultTolerantRunner=FaultTolerantRunner,
    StragglerPolicy=StragglerPolicy, SyntheticDataset=SyntheticDataset,
    get_config=get_config, build_model=_CpuModel, ShardingPlan=ShardingPlan,
    SINGLE_POD=SINGLE_POD, make_train_step=make_train_step, _batch=_batch)


def _on(fn):
    """``fn`` with its module's globals rebound to the port's names.  Fails
    if the code would still reach a name of ``repro`` or of jax."""
    g = dict(fn.__globals__)
    g.update(PORT_NAMES)
    codes, names = [fn.__code__], set()
    while codes:                                  # nested defs and lambdas
        code = codes.pop()
        names.update(code.co_names)
        codes += [c for c in code.co_consts if isinstance(c, types.CodeType)]

    def foreign(v):
        root = (v.__name__ if isinstance(v, types.ModuleType)
                else getattr(v, "__module__", "") or "")
        return root.split(".")[0] in ("repro", "jax", "jaxlib")

    left = sorted(n for n in names if n in g and foreign(g[n]))
    assert not left, f"{fn.__name__} would still reach {left}"
    return types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__,
                              fn.__closure__)


@pytest.mark.parametrize("name", [
    "test_lr_schedules", "test_adamw_converges_quadratic",
    "test_bf16_opt_state_still_converges", "test_checkpoint_roundtrip",
    "test_checkpoint_latest_and_gc", "test_fault_tolerant_runner_restarts",
    "test_straggler_detection", "test_synthetic_data_deterministic",
    "test_microbatch_equivalence"])
def test_reference_training_cases_on_the_port(name, tmp_path):
    fn = _on(getattr(cases, name))
    args = {"tmp_path": tmp_path, "rng": jax.random.PRNGKey(0)}
    fn(*(args[a] for a in fn.__code__.co_varnames[:fn.__code__.co_argcount]))


@pytest.mark.parametrize("aid", ARCH_IDS)
def test_reference_train_step_decreases_loss_on_the_port(aid):
    """Five steps of ``make_train_step`` on one batch lower the loss, for
    every family (the SSM and MoE layers through their plain versions on
    the CPU, differentiated by autograd)."""
    cfg = get_config(aid).reduced()
    model = _CpuModel(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    _on(arch_cases.test_train_step_decreases_loss)(
        (aid, cfg, model, params), jax.random.PRNGKey(0))


# --------------------------------------------------------------------------
# Schedules, data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["cosine", "wsd", "constant"])
def test_lr_at_equals_the_reference(schedule):
    cfg = dict(lr=3e-3, warmup_steps=20, total_steps=200, schedule=schedule)
    steps = list(range(0, 230, 7)) + [20, 179, 180, 181, 200]
    got = [float(optim.lr_at(optim.OptConfig(**cfg), torch.tensor(s)))
           for s in steps]
    want = [float(joptim.lr_at(joptim.OptConfig(**cfg), jnp.asarray(s)))
            for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("aid", ["gemma-2b", "whisper-tiny",
                                 "llama-3.2-vision-11b"])
def test_synthetic_batches_equal_the_references_byte_for_byte(aid):
    ours = iter(SyntheticDataset(get_config(aid).reduced(), 2, 64, seed=3))
    theirs = iter(JSyntheticDataset(jget_config(aid).reduced(), 2, 64,
                                    seed=3))
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


# --------------------------------------------------------------------------
# The checkpoint codec and cross-package restore
# --------------------------------------------------------------------------

@pytest.mark.parametrize("obj", [
    {"step": 0, "leaves": []},
    {"step": 17, "leaves": [{"dtype": "float32", "shape": [2, 3],
                             "data": b"\x00" * 24}]},
    [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
     2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31,
     -2 ** 31 - 1, -2 ** 63],
    ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40000],
    [b"", b"x" * 255, b"y" * 256, b"z" * 70000],
    {f"k{i}": list(range(i)) for i in range(20)},
    [list(range(15)), list(range(16)), list(range(70000))]])
def test_codec_bytes_equal_msgpack(obj):
    data = _msgpack.packb(obj)
    assert data == msgpack.packb(obj, use_bin_type=True)
    back = _msgpack.unpackb(data)
    assert back == msgpack.unpackb(data, raw=False)
    assert back == obj


def test_codec_refuses_what_it_does_not_encode():
    for bad in (1.5, None, True, {1, 2}):
        with pytest.raises(TypeError):
            _msgpack.packb(bad)
    with pytest.raises(ValueError):
        _msgpack.unpackb(msgpack.packb(1.5))       # a float: not in the subset
    with pytest.raises(ValueError):
        _msgpack.unpackb(msgpack.packb([1, 2])[:-1])


def _trained_state(seed=0):
    """Reduced gemma-2b parameters and an AdamW state with bf16 moments and
    fp32 masters after one update, in both packages: (jax state, port
    state), the port's converted from the JAX one."""
    jm = jbuild_model(jget_config("gemma-2b").reduced())
    jp = jm.init(jax.random.PRNGKey(seed))
    jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp)
    st = joptim.init(jp, jnp.bfloat16, master=True)
    cfg = joptim.OptConfig(state_dtype="bfloat16", warmup_steps=1)
    grads = jax.tree.map(lambda x: jnp.ones_like(x) * 0.01, jp)
    jp, st, _ = joptim.apply_updates(cfg, jp, grads, st)
    jnp_state = (jp, st)
    port = (from_jax(jax.tree.map(np.asarray, jp), device="cpu"),
            opt_state_from_jax(jax.tree.map(np.asarray, st), device="cpu"))
    return jnp_state, port


def test_checkpoint_file_bytes_equal_the_references(tmp_path):
    jstate, port = _trained_state()
    a = ckpt.save(str(tmp_path / "port.msgpack"), port, step=7)
    b = jckpt.save(str(tmp_path / "jax.msgpack"), jstate, step=7)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_checkpoints_restore_across_the_two_packages(tmp_path):
    jstate, port = _trained_state(1)
    # the reference's file in the port, into a zeroed state of its structure
    path = jckpt.save(str(tmp_path / "jax.msgpack"), jstate, step=5)
    like = tree.map(torch.zeros_like, port)
    got, step = ckpt.restore(path, like)
    assert step == 5 and type(got[1]) is optim.OptState
    for x, y in zip(tree.leaves(got), tree.leaves(port)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    # the port's file in the reference
    path = ckpt.save(str(tmp_path / "port.msgpack"), port, step=9)
    jgot, jstep = jckpt.restore(path, jstate)
    assert jstep == 9
    for x, y in zip(jax.tree.leaves(jgot), tree.leaves(to_numpy(port))):
        assert np.asarray(x).dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x), y)


# --------------------------------------------------------------------------
# The CLI on the CPU
# --------------------------------------------------------------------------

def test_train_cli_on_the_cpu_learns_checkpoints_and_resumes(tmp_path):
    argv = ["--device", "cpu", "--d-model", "64", "--layers", "2",
            "--batch", "4", "--seq", "32", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "10"]
    first = train_cli.main(argv + ["--steps", "30"])
    assert first["step"] == 30 and first["steps_run"] == 30
    assert sorted(os.listdir(tmp_path)) == [
        f"ckpt_{s:08d}.msgpack" for s in (10, 20, 30)]
    # the first run's cosine schedule ended at lr 0: a longer one resumes
    # from step 30 and goes on learning
    resumed = train_cli.main(argv + ["--steps", "60"])
    assert resumed["step"] == 90 and resumed["steps_run"] == 60


def test_train_cli_refuses_cuda_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the cuda default runs here")
    with pytest.raises(RuntimeError, match="cuda"):
        train_cli.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
