"""The port's copy of ``repro.sharding.plan``, with the chip as a parameter.

HiDP planning for the accelerator tier — the paper's two-tier strategy
driving real sharding decisions (DESIGN.md §2 table).

The reference hard-codes the TPU v5e (its ``CHIP`` dict and
``HBM_PER_CHIP``); here a frozen :class:`ChipSpec` carries those numbers
and the node factory the global tier collapses pods into, and one
:func:`plan` takes it.  :func:`plan_tpu` is ``plan(..., V5E)`` and equals
the reference plan for plan; :func:`plan_gpu` is ``plan(..., H100)``: the
port's H100 datasheet constants (``core/cost_model.py``), 80 GB of HBM a
GPU, NVLink as the intra-node (ICI) term, InfiniBand as the inter-node
(DCN) term, and ``gpu_node`` hosts.  On GPU meshes the ``pod`` axis is the
host.

Tier 1 (global, across pods): the core DP (``core.dp_partitioner``)
runs on the model's block DAG with pods collapsed to (Λ_pod, β_DCN)
resources — exactly Alg. 1 lines 4-6 — choosing **data** (batch/context over
the ``pod`` axis) vs **model** (pipeline stages over ``pod``) partitioning,
and the stage boundaries when model mode wins.

Tier 2 (local, intra-pod): the DSE agent enumerates concrete mesh layouts —
the TPU analogue of the paper's P1–P9 sweep (Fig. 1) — and costs each with a
three-term roofline model (compute / HBM / ICI-collectives, the ψ = λ/μ
ratio in vector form).  P1 (pure data parallelism with replicated params,
the "default framework" behaviour) is always in the candidate set and is
rejected by the cost model exactly when the paper says it should be.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import TYPE_CHECKING, Callable

from repro_torch.core import cost_model as cm
from repro_torch.core import dp_partitioner
from repro_torch.core.dag import ModelPartition
from repro_torch.models.config import ArchConfig, ShapeConfig

if TYPE_CHECKING:           # the model modules import the sharding context
    from repro_torch.models.model import Model


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """One accelerator as the planner sees it: ``peak`` FLOP/s, ``hbm``
    bytes/s, ``ici`` (intra-pod or intra-host link) and ``dcn`` (between
    pods or hosts) bytes/s, ``hbm_per_chip`` bytes, and ``node(name,
    chips)``, which builds one pod or host of ``chips`` of them."""

    peak: float
    hbm: float
    ici: float
    dcn: float
    hbm_per_chip: float
    node: Callable[[str, int], cm.Node]


V5E = ChipSpec(peak=cm.TPU_V5E_PEAK_FLOPS, hbm=cm.TPU_V5E_HBM_BW,
               ici=cm.TPU_V5E_ICI_BW, dcn=cm.TPU_V5E_DCN_BW,
               hbm_per_chip=16e9, node=cm.tpu_pod)
H100 = ChipSpec(peak=cm.H100_PEAK_FLOPS, hbm=cm.H100_HBM_BW,
                ici=cm.H100_NVLINK_BW, dcn=cm.H100_NET_BW,
                hbm_per_chip=80e9, node=cm.gpu_node)


@dataclasses.dataclass(frozen=True)
class MeshDesc:
    axes: tuple[str, ...]
    shape: tuple[int, ...]

    @property
    def n_pods(self) -> int:
        return self.shape[self.axes.index("pod")] if "pod" in self.axes else 1

    @property
    def chips_per_pod(self) -> int:
        n = 1
        for a, s in zip(self.axes, self.shape):
            if a != "pod":
                n *= s
        return n

    @property
    def total_chips(self) -> int:
        return self.n_pods * self.chips_per_pod

    def size(self, axis: str) -> int:
        return self.shape[self.axes.index(axis)] if axis in self.axes else 1


SINGLE_POD = MeshDesc(("data", "model"), (16, 16))
MULTI_POD = MeshDesc(("pod", "data", "model"), (2, 16, 16))
# one HGX H100 host of 8 NVLink GPUs; two such hosts over InfiniBand
GPU_NODE = MeshDesc(("data", "model"), (1, 8))
GPU_MULTI_NODE = MeshDesc(("pod", "data", "model"), (2, 1, 8))


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    arch: str
    shape: str
    mesh: MeshDesc
    global_mode: str                       # "data" | "model" (across pods)
    local_layout: str                      # candidate id (P1-analogue names)
    batch_axes: tuple[str, ...]            # batch dim of activations
    seq_axes: tuple[str, ...] = ()         # context/cache parallelism
    tp_axes: tuple[str, ...] = ("model",)
    fsdp_axes: tuple[str, ...] = ()
    pipeline_stages: int = 1               # >1 → GPipe over 'pod'
    pipeline_boundaries: tuple[int, ...] = ()
    microbatches: int = 1
    remat_group: int = 1                   # checkpoint every N layers
    opt_dtype: str = "float32"             # AdamW m/v dtype
    param_dtype: str = "float32"           # bf16 + fp32 master → ½ coll bytes
    moe_impl: str = "dense"
    remat: bool = True
    predicted: dict = dataclasses.field(default_factory=dict)
    planning_seconds: float = 0.0

    @property
    def dp_size(self) -> int:
        n = 1
        for a in self.batch_axes:
            n *= self.mesh.size(a)
        return n


# --------------------------------------------------------------------------
# Per-candidate three-term cost model (the local ψ in roofline form)
# --------------------------------------------------------------------------

def _train_bytes_per_chip(cfg: ArchConfig, shape: ShapeConfig,
                          cand: dict, mesh: MeshDesc) -> float:
    """Resident bytes per chip: fp32 params + AdamW m/v + activation
    checkpoints for one microbatch + gradients + loss working set."""
    shards = 1
    for a in set(cand["tp_axes"]) | set(cand["fsdp_axes"]):
        shards *= mesh.size(a)
    if cand.get("pipeline_stages", 1) > 1:
        shards *= cand["pipeline_stages"]
    p_total = cfg.params_total()
    sd = 2 if cand.get("opt_dtype") == "bfloat16" else 4
    pd = 2 if cand.get("param_dtype") == "bfloat16" else 4
    master = 4 if pd == 2 else 0
    # w, m, v, grad (+ fp32 master when params are bf16)
    param_state = p_total * (pd + sd + sd + pd + master) / shards
    tokens = shape.global_batch * shape.seq_len
    tok_local = tokens / max(cand["dp_size"], 1) / max(cand["microbatches"], 1)
    g = max(cand.get("remat_group", 1), 1)
    tp = 1
    for a in cand["tp_axes"]:
        tp *= mesh.size(a)
    # one checkpoint per layer *group*; ×6 bytes/elem: the bf16 stack plus
    # the f32 copy XLA materialises when the backward loop consumes it in
    # fp32 (observed in the compiled HLO; priced in to stay honest)
    act = tok_local * cfg.d_model * 6.0 * (cfg.n_layers / g + 2)
    # live group's backward working set: residual streams (4 × d, unsharded
    # by tp) + matmul output activations (≈ per-layer params / d_model output
    # features, sharded by tp), in fp32-ish units
    out_features = (p_total / max(cfg.n_layers, 1)) / max(cfg.d_model, 1)
    act += g * tok_local * (4.0 * cfg.d_model + out_features / tp) * 4.0
    # chunked-CE loss slice (fp32 logits + grad, 8 chunks)
    act += 3.0 * (tok_local / 8) * cfg.vocab * 4 / tp
    return param_state + act


def _decode_bytes_per_chip(cfg: ArchConfig, shape: ShapeConfig,
                           cand: dict, mesh: MeshDesc) -> float:
    shards = 1
    for a in set(cand["tp_axes"]) | set(cand["fsdp_axes"]):
        shards *= mesh.size(a)
    params = cfg.params_total() * 2.0 / shards             # bf16 serving
    cache_shards = max(cand["dp_size"], 1) * math.prod(
        [mesh.size(a) for a in cand["tp_axes"]])
    cache = _cache_bytes(cfg, shape) / cache_shards
    return params + cache


def _cache_bytes(cfg: ArchConfig, shape: ShapeConfig) -> float:
    B, S = shape.global_batch, shape.seq_len
    total = 0.0
    if cfg.family != "ssm":
        total += cfg.n_layers * B * S * cfg.n_kv_heads * cfg.hd * 2 * 2
    if cfg.family in ("ssm", "hybrid"):
        s = cfg.ssm
        total += cfg.n_layers * B * s.n_heads(cfg.d_model) * s.head_dim \
            * s.d_state * 4
    return total


def _collective_bytes_per_chip(cfg: ArchConfig, shape: ShapeConfig,
                               cand: dict, mesh: MeshDesc,
                               kind: str) -> float:
    """Ring-model per-chip collective traffic per step (ICI terms)."""
    tokens = shape.global_batch * (1 if kind == "decode" else shape.seq_len)
    dp = max(cand["dp_size"], 1)
    tp = math.prod([mesh.size(a) for a in cand["tp_axes"]]) or 1
    p_total = cfg.params_total()
    by = 0.0
    pd = 2.0 if cand.get("param_dtype") == "bfloat16" else 4.0
    ep_mode = cand.get("moe_impl", "dense").startswith("ep_a2a") \
        and cfg.moe is not None
    p_expert = 0.0
    if cfg.moe is not None:
        p_expert = (cfg.moe.num_experts * 3.0 * cfg.d_model
                    * cfg.moe.d_ff_expert * cfg.n_layers)
    if kind == "train":
        # gradient reduce-scatter + param all-gather (or all-reduce): ring;
        # bf16 params → bf16 grads/gathers (half the bytes)
        p_dense_grads = p_total - (p_expert if ep_mode else 0.0)
        by += 2.0 * (p_dense_grads * pd / tp) * (dp - 1) / dp
        if cand["fsdp_axes"]:
            by += 2.0 * (p_dense_grads * pd / tp) * (dp - 1) / dp
        if ep_mode:
            # expert grads live on their owner rank: reduce over the data
            # axis only (the EP axis never sees other ranks' expert grads)
            ep = tp if tp > 1 else math.prod(
                [mesh.size(a) for a in cand["seq_axes"]]) or 1
            dp_b = max(dp // max(ep, 1), 1) if not cand["tp_axes"] else dp
            by += 2.0 * (p_expert * pd / ep) * (dp_b - 1) / max(dp_b, 1) * (
                2.0 if cand["fsdp_axes"] else 1.0)
    elif cand["fsdp_axes"]:
        # inference param gathers; under EP the expert weights (the bulk of
        # an MoE) are resident on their owner rank and never gathered
        by += ((p_total - (p_expert if ep_mode else 0.0)) * 2 / tp)
    if cand["seq_axes"] and cfg.family != "ssm" and kind != "decode":
        # sequence-parallel attention: per-chip KV gather per layer
        b_sh = 1
        for a in cand["batch_axes"]:
            b_sh *= mesh.size(a)
        kv_dims = 2 * cfg.n_kv_heads * cfg.hd
        by += (shape.global_batch / max(b_sh, 1)) * shape.seq_len \
            * kv_dims * 2 * cfg.n_layers * (3 if kind == "train" else 1)
    if tp > 1:
        # 2 all-reduces of activations per layer (attn out + mlp out)
        per_chip_tokens = tokens / dp
        by += (2 * cfg.n_layers * 2.0 * per_chip_tokens * cfg.d_model * 2
               * (tp - 1) / tp) * (3 if kind == "train" else 1)
    if ep_mode:
        # a2a out + back of the routed token slice; when tokens are
        # pre-sharded over the EP axis (sequence parallel) there is no
        # output all-gather
        seq_sharded = bool(cand["seq_axes"]) and not cand["tp_axes"]
        ep = tp if tp > 1 else math.prod(
            [mesh.size(a) for a in cand["seq_axes"]]) or 1
        per_chip_tokens = tokens / dp
        t_ep = per_chip_tokens if seq_sharded else per_chip_tokens / ep
        a2a_bytes = 1.25 if cand["moe_impl"] == "ep_a2a_q8" else 2.0
        per_layer = 4.0 * t_ep * cfg.moe.top_k * cfg.moe.capacity_factor \
            * cfg.d_model * a2a_bytes
        if not seq_sharded:
            per_layer += 2.0 * per_chip_tokens * cfg.d_model * 2
        by += per_layer * cfg.n_layers * (3 if kind == "train" else 1)
    return by


def _candidate_cost(model: Model, shape: ShapeConfig, cand: dict,
                    mesh: MeshDesc, chip: ChipSpec) -> dict:
    cfg = model.cfg
    kind = shape.kind
    chips = mesh.total_chips
    flops = model.step_flops(shape)
    if cfg.moe is not None and cand.get("moe_impl", "dense") == "dense":
        # the dense baseline computes every expert for every token: its
        # executed FLOPs exceed the useful ones by (E/top_k − 1)× on the ffn
        waste = cfg.moe.num_experts / cfg.moe.top_k
        impl_flops = flops + (waste - 1) * _moe_ffn_share(cfg, shape)
    else:
        impl_flops = flops
    compute = impl_flops / (chips * chip.peak)
    if cand.get("pipeline_stages", 1) > 1:
        s, m = cand["pipeline_stages"], max(cand["microbatches"], 1)
        compute *= 1.0 + (s - 1) / m                        # bubble
    # dense-MoE materialises (tokens, E_local, ffe) intermediates (~4 live
    # tensors); experts that do not divide the tp axes replicate entirely
    moe_tmp = 0.0
    if cfg.moe is not None and cand.get("moe_impl", "dense") == "dense":
        tok = shape.global_batch * (1 if kind == "decode" else shape.seq_len)
        tok_local = tok / max(cand["dp_size"], 1) \
            / max(cand["microbatches"], 1)
        tp = 1
        for a in cand["tp_axes"]:
            tp *= mesh.size(a)
        e_local = (cfg.moe.num_experts // tp
                   if cfg.moe.num_experts % tp == 0 else cfg.moe.num_experts)
        moe_tmp = tok_local * e_local * cfg.moe.d_ff_expert * 2.0 * 4
    if kind == "train":
        resident = _train_bytes_per_chip(cfg, shape, cand, mesh) + moe_tmp
        hbm_traffic = cfg.params_total() * 4 / (
            cand["param_shards"]) * (3 if cand["microbatches"] == 1
                                     else 2 + cand["microbatches"])
    else:
        resident = _decode_bytes_per_chip(cfg, shape, cand, mesh) + moe_tmp
        hbm_traffic = resident                              # read weights+cache
    memory = hbm_traffic / chip.hbm
    coll = _collective_bytes_per_chip(cfg, shape, cand, mesh, kind) \
        / chip.ici
    fits = resident <= chip.hbm_per_chip * 0.92
    total = max(compute, memory, coll) if fits else float("inf")
    return dict(compute=compute, memory=memory, collective=coll,
                resident=resident, fits=fits, total=total)


def _moe_ffn_share(cfg: ArchConfig, shape: ShapeConfig) -> float:
    m = cfg.moe
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    f = tokens * m.top_k * 2.0 * 3 * cfg.d_model * m.d_ff_expert * cfg.n_layers
    return f * (3.0 if shape.kind == "train" else 1.0)


# --------------------------------------------------------------------------
# Candidate enumeration (tier-2 DSE agent)
# --------------------------------------------------------------------------

def _enumerate_candidates(cfg: ArchConfig, shape: ShapeConfig,
                          mesh: MeshDesc, global_mode: str) -> list[dict]:
    """Concrete mesh layouts = the P1..P9 analogue.  'pod' participates in
    batch/context axes when the global tier chose data mode; in pipeline
    stages when it chose model mode."""
    pod_in_data = global_mode == "data" and mesh.n_pods > 1
    pod_axes = ("pod",) if pod_in_data else ()
    pstages = mesh.n_pods if (global_mode == "model" and mesh.n_pods > 1) else 1
    B = shape.global_batch
    out: list[dict] = []

    def cand(name, batch_axes, seq_axes=(), tp=(), fsdp=(), micro=1,
             moe="dense", rg=1, od="float32", pd="float32"):
        # effective batch sharding: drop axes (largest first) until the batch
        # divides — mirrors specs.sanitize so predicted dp == realised dp
        baxes = list(batch_axes)
        while baxes:
            prod = 1
            for a in baxes:
                prod *= mesh.size(a)
            if B % prod == 0:
                break
            baxes.sort(key=mesh.size)
            baxes.pop()
        batch_axes = tuple(baxes)
        dp = 1
        for a in batch_axes + seq_axes:
            dp *= mesh.size(a)
        # microbatching must keep the per-microbatch batch divisible by dp
        if micro > 1 and (B % (micro * dp) != 0 if not
                          _shards_seq(batch_axes, seq_axes) else False):
            return
        shards = pstages
        for a in set(tp) | set(fsdp):
            shards *= mesh.size(a)
        out.append(dict(name=name, batch_axes=batch_axes, seq_axes=seq_axes,
                        tp_axes=tp, fsdp_axes=fsdp, microbatches=micro,
                        moe_impl=moe, dp_size=dp, param_shards=max(shards, 1),
                        pipeline_stages=pstages, remat_group=rg,
                        opt_dtype=od, param_dtype=pd))

    def _shards_seq(batch_axes, seq_axes):
        return bool(seq_axes)

    if shape.kind == "train":
        for m in (1, 2, 4, 8):
            for rg in (1, 2, 4, 8):
                if cfg.n_layers % rg:
                    continue
                for od in ("float32", "bfloat16"):
                    for pd in ("float32", "bfloat16"):
                        # P1: framework default — pure DP, replicated params
                        cand("P1_pure_dp", pod_axes + ("data", "model"),
                             micro=m, rg=rg, od=od, pd=pd)
                        cand("dp_tp", pod_axes + ("data",), tp=("model",),
                             micro=m, rg=rg, od=od, pd=pd)
                        cand("dp_tp_fsdp", pod_axes + ("data",),
                             tp=("model",), fsdp=("data",), micro=m, rg=rg,
                             od=od, pd=pd)
                        cand("fsdp_all", pod_axes + ("data", "model"),
                             fsdp=("data", "model"), micro=m, rg=rg, od=od,
                             pd=pd)
                        cand("dp_sp_fsdp", pod_axes + ("data",),
                             seq_axes=("model",), fsdp=("data", "model"),
                             micro=m, rg=rg, od=od, pd=pd)
    elif shape.kind == "prefill":
        cand("P1_pure_dp", pod_axes + ("data", "model"))
        cand("dp_tp", pod_axes + ("data",), tp=("model",))
        cand("dp_tp_fsdp", pod_axes + ("data",), tp=("model",),
             fsdp=("data",))
        # no-TP layout: batch over data, sequence over model, params FSDP
        # over both — trades the per-layer TP activation all-reduces
        # (∝ tokens·d_model) for attention KV gathers (∝ tokens·kv_dims,
        # ≥8× smaller under GQA) + param all-gathers
        cand("dp_sp_fsdp", pod_axes + ("data",), seq_axes=("model",),
             fsdp=("data", "model"))
        if B < 32:
            cand("seq_tp", pod_axes, seq_axes=("data",), tp=("model",))
    else:                                   # decode
        cand("P1_pure_dp", pod_axes + ("data", "model"))
        cand("dp_tp", pod_axes + ("data",), tp=("model",))
        if cfg.family not in ("ssm", "hybrid"):
            # context parallelism: shard the KV cache sequence dim
            cand("ctx_tp", pod_axes, seq_axes=("data",), tp=("model",))
        cand("tp_all", pod_axes, tp=("data", "model")
             if B == 1 else ("model",))
    # MoE: expert-parallel variants (including the sequence-parallel one,
    # where tokens are pre-sharded over the EP axis: no output all-gather and
    # expert gradients reduce over the data axis only)
    if cfg.moe is not None:
        base = [c for c in list(out)
                if c["name"] in ("dp_tp", "dp_tp_fsdp", "ctx_tp",
                                 "dp_sp_fsdp")]
        for c in base:
            c2 = dict(c)
            c2["name"] = c["name"] + "_ep"
            c2["moe_impl"] = "ep_a2a"
            out.append(c2)
            c3 = dict(c)
            c3["name"] = c["name"] + "_ep_q8"
            c3["moe_impl"] = "ep_a2a_q8"
            out.append(c3)
    return out


# --------------------------------------------------------------------------
# Tier-1 global DP (pods as nodes) + plan assembly
# --------------------------------------------------------------------------

def _pods_as_cluster(mesh: MeshDesc, chip: ChipSpec) -> cm.Cluster:
    return cm.Cluster(tuple(chip.node(f"pod{i}", mesh.chips_per_pod)
                            for i in range(mesh.n_pods)))


def plan(model: Model, shape: ShapeConfig, mesh: MeshDesc, chip: ChipSpec,
         *, force_layout: str | None = None,
         force_global: str | None = None,
         moe_impl: str | None = None) -> ShardingPlan:
    """Two-tier HiDP planning for one (arch × shape × mesh) cell on
    ``chip``."""
    t0 = time.perf_counter()
    cfg = model.cfg
    dag = model.block_costs(shape)
    boundaries: tuple[int, ...] = ()
    if mesh.n_pods > 1:
        cluster = _pods_as_cluster(mesh, chip)
        resources = [
            dataclasses.replace(cm.node_as_resource(n), rtt=5e-5,
                                bw=chip.dcn)
            for n in cluster.nodes]
        gpart = dp_partitioner.partition(dag, resources)
        global_mode = ("model" if isinstance(gpart, ModelPartition)
                       else "data")
        if isinstance(gpart, ModelPartition):
            boundaries = gpart.boundaries
    else:
        global_mode = "data"
    if force_global:
        global_mode = force_global

    # Rendering of global model-mode: for train/prefill it becomes GPipe
    # stages over 'pod'; for decode (no microbatch stream to fill a pipeline
    # with) it becomes tensor parallelism extended over the pod axis.
    decode_pod_tp = (shape.kind == "decode" and global_mode == "model"
                     and mesh.n_pods > 1)

    cands = _enumerate_candidates(cfg, shape, mesh, global_mode)
    if decode_pod_tp:
        for c in cands:
            c["tp_axes"] = ("pod",) + tuple(c["tp_axes"])
            c["pipeline_stages"] = 1
            c["param_shards"] = max(c["param_shards"], 1) * mesh.n_pods
    best, best_cost = None, None
    for c in cands:
        if force_layout and c["name"] != force_layout:
            continue
        if moe_impl and c["moe_impl"] != moe_impl:
            continue
        cost = _candidate_cost(model, shape, c, mesh, chip)
        if best is None or cost["total"] < best_cost["total"]:
            best, best_cost = c, cost
    if best is None or not best_cost["fits"]:
        # nothing fits the chip's HBM budget: take the minimum-resident
        # candidate (the least-bad memory plan) rather than an arbitrary one
        scored = [(c, _candidate_cost(model, shape, c, mesh, chip))
                  for c in cands
                  if (not force_layout or c["name"] == force_layout)
                  and (not moe_impl or c["moe_impl"] == moe_impl)]
        best, best_cost = min(scored, key=lambda cc: cc[1]["resident"])
    return ShardingPlan(
        arch=cfg.name, shape=shape.name, mesh=mesh,
        global_mode=global_mode, local_layout=best["name"],
        batch_axes=tuple(best["batch_axes"]),
        seq_axes=tuple(best["seq_axes"]),
        tp_axes=tuple(best["tp_axes"]),
        fsdp_axes=tuple(best["fsdp_axes"]),
        pipeline_stages=best.get("pipeline_stages", 1),
        pipeline_boundaries=boundaries,
        microbatches=best["microbatches"],
        remat_group=best.get("remat_group", 1),
        opt_dtype=best.get("opt_dtype", "float32"),
        param_dtype=best.get("param_dtype", "float32"),
        moe_impl=best["moe_impl"],
        predicted=best_cost,
        planning_seconds=time.perf_counter() - t0)


def plan_tpu(model: Model, shape: ShapeConfig, mesh: MeshDesc,
             **kw) -> ShardingPlan:
    """:func:`plan` on the TPU v5e: the reference's ``plan_tpu``."""
    return plan(model, shape, mesh, V5E, **kw)


def plan_gpu(model: Model, shape: ShapeConfig, mesh: MeshDesc,
             **kw) -> ShardingPlan:
    """:func:`plan` on the H100."""
    return plan(model, shape, mesh, H100, **kw)
