"""Dry-run of every (architecture × input shape) cell on the GPU meshes,
ported from ``repro.launch.dryrun``: plan the cell, run its step on
abstract tensors, prove the memory fit and collect the roofline terms.

For each cell:
  1. HiDP plans it (``plan_gpu``: the global DP over nodes, the layout DSE
     on ``GPU_NODE`` (1 × 8) or ``GPU_MULTI_NODE`` (2 × 1 × 8)).
  2. A fake process group of the mesh's world size (8 or 16; no
     communication, one process plays rank 0) and the plan's mesh from it.
  3. The step runs under ``FakeTensorMode`` on DTensors placed by
     ``specs`` (no storage anywhere): for train, the sharded step with
     AdamW (``sharding.spmd``), or the GPipe pipeline under
     ``--force-global model``; for prefill, ``spmd.make_sharded_prefill``;
     for decode, ``spmd.make_sharded_decode`` with the cache an argument,
     written in place (the reference donates it).  Under ``tp_axes`` the
     steps keep every weight split and move activations
     (``models.layers``), the train step's gradients through the
     crossings' backward (reduce-scatters and all-reduces).  The kernels' plain versions run, as in the
     reference (``ops.set_backend("blocked")``).
     The attention kernels on these abstract tensors take their shape
     paths (``ops``): their outputs and scratch allocated as on the card,
     their FLOPs counted analytically (``flash_attention.visible_pairs``;
     decode every key of the cache or its share, at most the window).
  4. ``MemTracker`` gives the per-GPU peak; ``FlopCounterMode`` the FLOPs
     per GPU, plus the attention kernels'; every collective issued is
     recorded (``CollectiveRecorder``) and its result bytes summed per kind
     under the reference's HLO names (``collective_bytes``).

A cell the port has no step for is recorded ``not_ported`` with the reason
(``not_ported``): training under tensor parallelism beside a sequence split
(``ctx_tp``, ``seq_tp``) or over two axes (``tp_all``), and a decode cache
split over ``seq_axes`` without tensor parallelism.  Neither planner offers
any of these, so every serving cell has its step; ``plan_gpu`` picks
``ctx_tp``, ``seq_tp`` or ``tp_all`` at B = 1 on neither GPU mesh, and
``--layout`` reaches them (``--layout ctx_tp --shape decode_32k``).
``--layout dp_tp`` (or ``dp_tp_fsdp``, and ``_ep``/``_ep_q8`` for MoE)
traces a ``train_4k`` cell under tensor parallelism.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
  python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k \
      --layout dp_tp
  python -m repro_torch.launch.dryrun --all [--multi-node] [--out DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import SHAPES, build_model, shape_applicable
from repro_torch.sharding import pipeline as pp
from repro_torch.sharding import specs, spmd
from repro_torch.sharding.plan import GPU_MULTI_NODE, GPU_NODE, plan_gpu
from repro_torch.training import optimizer as optim
from repro_torch.training import tree

# the c10d and functional-collective ops, by name, and their kind under the
# reference's HLO names; a point-to-point receive is the pipeline's
# collective-permute (its send is the same bytes, counted once)
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "recv_": "collective-permute",
}
DTYPE_BYTES = {torch.float64: 8, torch.float32: 4, torch.bfloat16: 2,
               torch.float16: 2, torch.int64: 8, torch.int32: 4,
               torch.int16: 2, torch.int8: 1, torch.uint8: 1, torch.bool: 1}


def collective_kind(op_name: str) -> str | None:
    """``"_c10d_functional::all_gather_into_tensor"`` → ``"all-gather"``;
    None for an op that is no collective (``wait_tensor``, compute)."""
    return _KINDS.get(op_name.split("::")[-1].split(".")[0])


def collective_bytes(records) -> dict:
    """Sum the result bytes of every recorded collective, per kind, and
    their ``total``.  ``records``: (op name, [(shape, dtype), ...]) of each
    op issued on this rank, its results' shapes (per GPU)."""
    out: dict[str, float] = {}
    for name, results in records:
        kind = collective_kind(name)
        if kind is None:
            continue
        nbytes = 0.0
        for shape, dtype in results:
            numel = 1
            for s in shape:
                numel *= int(s)
            nbytes += numel * DTYPE_BYTES[dtype]
        out[kind] = out.get(kind, 0.0) + nbytes
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    return []


def _recording_mode():
    from torch.utils._python_dispatch import TorchDispatchMode

    class CollectiveRecorder(TorchDispatchMode):
        """Records every collective issued under it: (op name, result
        shapes and dtypes).  An in-place c10d op's results are its tensor
        arguments (a receive's buffer)."""

        def __init__(self):
            super().__init__()
            self.records: list = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func._schema.name
            if collective_kind(name) is not None:
                res = _tensors(out) or _tensors(args[:1])
                self.records.append(
                    (name, [(tuple(t.shape), t.dtype) for t in res]))
            return out

    return CollectiveRecorder()


def _grouped_mm_flops():
    """``torch._grouped_mm``'s FLOPs for the FLOP counter: 2·rows·K·N
    (every row meets one group's (K, N) matrix), whatever the offsets."""
    import torch.utils.flop_counter as fc

    op = torch.ops.aten._grouped_mm
    if op in fc.flop_registry or op.default in fc.flop_registry:
        return

    @fc.register_flop_formula(op)
    def _flops(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
        rows, k = a_shape[-2], a_shape[-1]
        return 2 * rows * k * b_shape[-1]


# --------------------------------------------------------------------------
# Cells
# --------------------------------------------------------------------------

def build_cell(arch: str, shape_name: str, mesh_desc, force_layout=None,
               moe_impl=None, force_global=None, cfg=None):
    """(cfg, model, shape, plan); ``cfg`` replaces ``get_config(arch)``
    (the tests' reduced configurations)."""
    cfg = cfg or get_config(arch)
    model = build_model(cfg)
    shape = SHAPES[shape_name]
    plan = plan_gpu(model, shape, mesh_desc, force_layout=force_layout,
                    moe_impl=moe_impl, force_global=force_global)
    return cfg, model, shape, plan


@contextlib.contextmanager
def fake_world(mesh_desc):
    """A fake process group of the mesh's world size (this process is rank
    0; collectives return at once) and the mesh over it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry-run makes its own fake process group: "
                           "run it in a process without one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh_desc.total_chips)
    try:
        yield init_device_mesh("cpu", mesh_desc.shape,
                               mesh_dim_names=mesh_desc.axes)
    finally:
        dist.destroy_process_group()


def _fake(meta_tree):
    """Fake tensors of a ``meta`` tree's shapes (inside FakeTensorMode)."""
    return tree.map(lambda m: torch.empty(m.shape, dtype=m.dtype),
                    meta_tree)


def _local_bytes(x) -> int:
    from torch.distributed.tensor import DTensor
    t = x.to_local() if isinstance(x, DTensor) else x
    return t.numel() * t.element_size()


def _train_step(model, shape, plan, mesh, args: dict):
    """Builds the sharded train step's inputs into ``args`` and returns a
    closure that runs one step."""
    master = plan.param_dtype == "bfloat16"
    sd = torch.bfloat16 if plan.opt_dtype == "bfloat16" else torch.float32
    oc = optim.OptConfig(state_dtype=plan.opt_dtype)
    params = model.param_specs(torch.bfloat16 if master else torch.float32)
    args["params"] = specs.param_shardings(mesh, params, plan, device="cpu")
    args["opt"] = optim.init(args["params"], sd, master=master)
    args["batch"] = _fake(model.input_specs(shape))
    step = spmd.make_sharded_train_step(model, oc, plan, mesh)
    local = spmd.local_batch(mesh, args["batch"], plan)
    args["local_batch"] = local
    return lambda: step(args["params"], args["opt"], args["batch"])


def _pipeline_train_step(model, shape, plan, mesh, args: dict):
    """The GPipe rendering of global model mode (stage-resident weights
    over ``pod``, the batch whole on every rank)."""
    cfg = model.cfg
    sd = torch.bfloat16 if plan.opt_dtype == "bfloat16" else torch.float32
    staged = pp.stage_params(cfg, model.param_specs(torch.float32),
                             plan.pipeline_stages)
    args["params"] = pp.stage_param_shardings(mesh, staged, device="cpu")
    args["opt"] = optim.init(args["params"], sd)
    args["batch"] = _fake(model.input_specs(shape))
    args["local_batch"] = args["batch"]
    step = pp.make_pipeline_train_step(
        model, optim.OptConfig(state_dtype=plan.opt_dtype), plan, mesh)
    return lambda: step(args["params"], args["opt"], args["batch"])


def _serving_args(model, shape, plan, mesh, args: dict) -> None:
    params = model.param_specs(torch.bfloat16)
    args["params"] = specs.param_shardings(mesh, params, plan, device="cpu")
    args["batch"] = _fake(model.input_specs(shape))
    args["local_batch"] = spmd.local_batch(mesh, args["batch"], plan)


def _prefill_step(model, shape, plan, mesh, args: dict):
    """``spmd.make_sharded_prefill``: the parameters (bf16) on their
    shards, no gradient; the prompt's cache returned."""
    _serving_args(model, shape, plan, mesh, args)
    step = spmd.make_sharded_prefill(model, plan, mesh)
    return lambda: step(args["params"], args["batch"])


def _decode_step(model, shape, plan, mesh, args: dict):
    """``spmd.make_sharded_decode`` over the cache of ``shape`` (an
    argument, each rank's shard of it, written in place)."""
    _serving_args(model, shape, plan, mesh, args)
    args["cache"] = specs.cache_shardings(mesh, model.cache_specs(shape),
                                          plan, device="cpu")
    step = spmd.make_sharded_decode(model, plan, mesh)
    return lambda: step(args["params"], args["cache"], args["batch"])


def not_ported(plan, shape) -> str | None:
    """Why the port has no step for the cell, or None."""
    try:
        spmd.require_ported_layout(plan, shape.kind)
    except NotImplementedError as e:
        return str(e)
    return None


def trace_cell(model, shape, plan, mesh) -> dict:
    """Runs the cell's step once on fake tensors; returns its memory,
    FLOPs and collectives."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    _grouped_mm_flops()
    cfg = model.cfg
    pipeline = (shape.kind == "train" and plan.pipeline_stages > 1
                and cfg.family in ("dense", "moe", "ssm", "hybrid"))
    build = (_pipeline_train_step if pipeline else
             {"train": _train_step, "prefill": _prefill_step,
              "decode": _decode_step}[shape.kind])
    args: dict = {}
    rec = _recording_mode()
    flops = FlopCounterMode(display=False)
    mt = MemTracker()
    fa.abstract_flops = da.abstract_flops = 0.0
    with FakeTensorMode(), mt:
        run = build(model, shape, plan, mesh, args)
        arg_bytes = sum(_local_bytes(x) for k in ("params", "opt", "cache",
                                                   "local_batch")
                        for x in tree.leaves(args.get(k)))
        with rec, flops:
            run()
    # the abstract parameter trees (``meta``) hold no memory on the GPU
    peak = {str(dev): v for dev, v in mt.get_tracker_snapshot(
        "peak").items() if str(dev) != "meta"}
    kinds = {}
    for v in peak.values():
        for k, b in v.items():
            k = str(k).split(".")[-1].lower()
            kinds[k] = kinds.get(k, 0) + b
    return dict(memory=dict(argument_bytes=arg_bytes,
                            peak_per_device=kinds.pop("total", 0),
                            peak_by_kind=kinds),
                cost=dict(flops=float(flops.get_total_flops())
                          + fa.abstract_flops + da.abstract_flops,
                          attention_flops=fa.abstract_flops
                          + da.abstract_flops),
                collectives=collective_bytes(rec.records))


def _plan_record(plan) -> dict:
    return dict(global_mode=plan.global_mode, layout=plan.local_layout,
                batch_axes=plan.batch_axes, seq_axes=plan.seq_axes,
                tp_axes=plan.tp_axes, fsdp_axes=plan.fsdp_axes,
                microbatches=plan.microbatches, moe_impl=plan.moe_impl,
                remat_group=plan.remat_group, opt_dtype=plan.opt_dtype,
                param_dtype=plan.param_dtype,
                pipeline_stages=plan.pipeline_stages,
                predicted={k: v for k, v in plan.predicted.items()
                           if k != "fits"},
                planning_ms=plan.planning_seconds * 1e3)


def run_cell(arch: str, shape_name: str, multi_node: bool = False,
             force_layout=None, moe_impl=None, force_global=None,
             out_dir: str | None = "artifacts/dryrun_gpu",
             cfg=None) -> dict:
    """Plans and traces one cell; writes its JSON record under ``out_dir``
    (None: no file) and returns it.  ``status`` is ``ok``, ``skipped`` (the
    shape does not apply) or ``not_ported`` (``not_ported``'s layouts)."""
    mesh_desc = GPU_MULTI_NODE if multi_node else GPU_NODE
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "x".join(map(str, mesh_desc.shape)),
           "multi_node": multi_node}
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    t0 = time.time()
    cfg, model, shape, plan = build_cell(arch, shape_name, mesh_desc,
                                         force_layout, moe_impl,
                                         force_global, cfg)
    rec["plan"] = _plan_record(plan)
    why = not_ported(plan, shape)
    if why is not None:
        rec.update(status="not_ported", reason=why)
        _write(rec, out_dir, arch, shape_name, multi_node, force_layout,
               moe_impl)
        return rec
    t_plan = time.time() - t0
    prev = kernel_ops.get_backend()
    kernel_ops.set_backend("blocked")
    try:
        with fake_world(mesh_desc) as mesh:
            out = trace_cell(model, shape, plan, mesh)
    finally:
        kernel_ops.set_backend(prev)
    rec.update(status="ok", **out, model_flops=model.step_flops(shape),
               seconds=dict(plan=t_plan, trace=time.time() - t0 - t_plan))
    _write(rec, out_dir, arch, shape_name, multi_node, force_layout,
           moe_impl)
    return rec


def _write(rec, out_dir, arch, shape_name, multi_node, force_layout,
           moe_impl) -> None:
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{arch}_{shape_name}_{'mn' if multi_node else 'sn'}"
    if force_layout:
        tag += f"_{force_layout}"
    if moe_impl:
        tag += f"_{moe_impl}"
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=2, default=list)


def line(rec: dict) -> str:
    """The cell's one-line summary."""
    a, s, m = rec["arch"], rec["shape"], rec["mesh"]
    if rec["status"] == "ok":
        coll = rec["collectives"]
        by_kind = " ".join(f"{k}={v / 1e9:.3f}" for k, v in coll.items()
                           if k != "total")
        return (f"[OK] {a:22s} {s:12s} {m:7s} "
                f"layout={rec['plan']['layout']:18s} "
                f"peak={rec['memory']['peak_per_device'] / 2**30:7.2f}GiB "
                f"flops={rec['cost']['flops']:.3e} "
                f"coll={coll.get('total', 0) / 1e9:.3f}GB ({by_kind}) "
                f"trace={rec['seconds']['trace']:.1f}s")
    if rec["status"] == "not_ported":
        return (f"[NOT PORTED] {a:22s} {s:12s} {m:7s} "
                f"layout={rec['plan']['layout']} — {rec['reason']}")
    return f"[SKIP] {a:22s} {s:12s} — {rec['reason']}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-node", action="store_true",
                    help="GPU_MULTI_NODE (2 x 1 x 8) in place of GPU_NODE")
    ap.add_argument("--all", action="store_true",
                    help="every (arch × shape) on the selected mesh")
    ap.add_argument("--layout", default=None,
                    help="force a tier-2 layout candidate (hillclimb)")
    ap.add_argument("--moe-impl", default=None,
                    choices=["dense", "ep_a2a", "ep_a2a_q8"])
    ap.add_argument("--force-global", default=None,
                    choices=["data", "model"])
    ap.add_argument("--out", default="artifacts/dryrun_gpu")
    args = ap.parse_args(argv)
    # DTensor warns once per redistribution over two mesh dims
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all) required")
        cells = [(args.arch, args.shape)]
    failures, counts = 0, {}
    for arch, shape in cells:
        try:
            rec = run_cell(arch, shape, args.multi_node,
                           force_layout=args.layout, moe_impl=args.moe_impl,
                           force_global=args.force_global, out_dir=args.out)
            counts[rec["status"]] = counts.get(rec["status"], 0) + 1
            print(line(rec), flush=True)
        except Exception as e:                     # noqa: BLE001
            failures += 1
            print(f"[FAIL] {arch:22s} {shape:12s}: "
                  f"{type(e).__name__}: {e}", flush=True)
            traceback.print_exc()
    print(f"cells: {counts}, failed {failures}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
