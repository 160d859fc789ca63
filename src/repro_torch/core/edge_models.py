"""The port's copy of ``repro.core.edge_models``.

The paper's four evaluation workloads as analytic block DAGs, plus the
Table II edge-device specifications.

ResNet-152, VGG-19, InceptionNet-V3 and EfficientNet-B0 are built
programmatically from their published layer hyper-parameters; block FLOPs are
2·MACs, activations are float32.  Partitionable blocks follow the paper's
granularity ("layers are dynamically grouped into executable blocks"): one
block per residual/bottleneck block, VGG conv stage, Inception mixed block or
MBConv stage — 20–60 blocks per model, matching the DP's O(n·m) scale.

Device peak-FLOPs figures are sustained-CNN estimates for the boards in
Table II (not datasheet peaks): they reproduce the paper's qualitative
landscape — Orin ≫ TX2 > Nano ≫ RPi5 > RPi4, GPU:CPU ratios of 3–10×, and
GPU-unfriendly depthwise convolutions (the Fig. 1 "P1 is never optimal"
effect and EfficientNet's 50/50 optimal split).
"""

from __future__ import annotations

import dataclasses
import math

from .cost_model import Cluster, Node, Processor
from .dag import Block, ModelDAG, chain

BYTES = 4  # float32 activations


# --------------------------------------------------------------------------
# Block builders
# --------------------------------------------------------------------------

def conv_flops(h: int, w: int, cin: int, cout: int, k: int, stride: int = 1,
               groups: int = 1) -> tuple[float, int, int]:
    ho, wo = math.ceil(h / stride), math.ceil(w / stride)
    f = 2.0 * ho * wo * cout * (cin // groups) * k * k
    return f, ho, wo


def dense_flops(n_in: int, n_out: int) -> float:
    return 2.0 * n_in * n_out


def _block(name, kind, flops, params, h, w, cin, ho, wo, cout,
           halo=0.0, splittable=True) -> Block:
    return Block(name=name, kind=kind, flops=flops,
                 param_bytes=params * BYTES,
                 bytes_in=h * w * cin * BYTES,
                 bytes_out=ho * wo * cout * BYTES,
                 data_splittable=splittable, halo_fraction=halo)


# --------------------------------------------------------------------------
# ResNet-152  (224×224, bottleneck counts [3, 8, 36, 3])
# --------------------------------------------------------------------------

def resnet152() -> ModelDAG:
    blocks: list[Block] = []
    h = w = 224
    # stem: 7x7/2 conv 64 + 3x3/2 maxpool
    f, h, w = conv_flops(h, w, 3, 64, 7, 2)
    blocks.append(_block("stem", "conv", f, 3 * 64 * 49, 224, 224, 3,
                         h // 2, w // 2, 64, halo=0.06))
    h, w = h // 2, w // 2
    cin = 64
    stage_cfg = [(256, 3, 1), (512, 8, 2), (1024, 36, 2), (2048, 3, 2)]
    for si, (cout, reps, stride) in enumerate(stage_cfg):
        mid = cout // 4
        for r in range(reps):
            s = stride if r == 0 else 1
            f1, _, _ = conv_flops(h, w, cin, mid, 1)
            f2, ho, wo = conv_flops(h, w, mid, mid, 3, s)
            f3, _, _ = conv_flops(ho, wo, mid, cout, 1)
            fs = conv_flops(h, w, cin, cout, 1, s)[0] if (r == 0) else 0.0
            params = cin * mid + mid * mid * 9 + mid * cout + (
                cin * cout if r == 0 else 0)
            blocks.append(_block(f"res{si}_{r}", "conv", f1 + f2 + f3 + fs,
                                 params, h, w, cin, ho, wo, cout, halo=0.03))
            h, w, cin = ho, wo, cout
    # head: GAP + fc1000
    blocks.append(_block("head", "dense", dense_flops(2048, 1000),
                         2048 * 1000, h, w, 2048, 1, 1, 1000,
                         splittable=True))
    return chain("resnet152", blocks, 224 * 224 * 3 * BYTES, 1000 * BYTES)


# --------------------------------------------------------------------------
# VGG-19  (224×224, 16 conv + 3 FC)
# --------------------------------------------------------------------------

def vgg19() -> ModelDAG:
    cfg = [(64, 2), (128, 2), (256, 4), (512, 4), (512, 4)]
    blocks: list[Block] = []
    h = w = 224
    cin = 3
    for si, (cout, reps) in enumerate(cfg):
        f_total, params = 0.0, 0
        h_in, w_in, cin_in = h, w, cin
        for r in range(reps):
            f, _, _ = conv_flops(h, w, cin, cout, 3)
            f_total += f
            params += cin * cout * 9
            cin = cout
        h, w = h // 2, w // 2          # maxpool closes the stage
        blocks.append(_block(f"vgg{si}", "conv", f_total, params,
                             h_in, w_in, cin_in, h, w, cout, halo=0.05))
    blocks.append(_block("fc1", "dense", dense_flops(7 * 7 * 512, 4096),
                         7 * 7 * 512 * 4096, 7, 7, 512, 1, 1, 4096))
    blocks.append(_block("fc2", "dense", dense_flops(4096, 4096), 4096 * 4096,
                         1, 1, 4096, 1, 1, 4096))
    blocks.append(_block("fc3", "dense", dense_flops(4096, 1000), 4096 * 1000,
                         1, 1, 4096, 1, 1, 1000))
    return chain("vgg19", blocks, 224 * 224 * 3 * BYTES, 1000 * BYTES)


# --------------------------------------------------------------------------
# InceptionNet-V3  (299×299, simplified mixed blocks with published shapes)
# --------------------------------------------------------------------------

def inceptionv3() -> ModelDAG:
    blocks: list[Block] = []
    # stem: 3 convs + pool + 2 convs + pool → 35×35×192
    stem_f = 0.0
    f, h, w = conv_flops(299, 299, 3, 32, 3, 2); stem_f += f
    f, h, w = conv_flops(h, w, 32, 32, 3); stem_f += f
    f, h, w = conv_flops(h, w, 32, 64, 3); stem_f += f
    h, w = h // 2, w // 2
    f, _, _ = conv_flops(h, w, 64, 80, 1); stem_f += f
    f, h, w = conv_flops(h, w, 80, 192, 3); stem_f += f
    h, w = h // 2, w // 2
    blocks.append(_block("stem", "conv", stem_f, 9.2e5, 299, 299, 3,
                         h, w, 192, halo=0.04))
    # (h,w) now 35×35. Mixed blocks: (grid, cout, approx GMACs each)
    mixed = [("m35", 35, 288, 3, 0.30), ("m17", 17, 768, 5, 0.42),
             ("m8", 8, 2048, 2, 0.58)]
    cin = 192
    for name, grid, cout, reps, gmacs in mixed:
        for r in range(reps):
            c_in = cin if r == 0 else cout
            h_in = h if r == 0 else grid
            blocks.append(_block(f"{name}_{r}", "conv", gmacs * 2e9,
                                 gmacs * 2e9 / (2 * grid * grid) / 4,
                                 h_in, h_in, c_in, grid, grid, cout,
                                 halo=0.04))
        cin, h = cout, grid
    blocks.append(_block("head", "dense", dense_flops(2048, 1000),
                         2048 * 1000, 8, 8, 2048, 1, 1, 1000))
    return chain("inceptionv3", blocks, 299 * 299 * 3 * BYTES, 1000 * BYTES,
                 validate=False)  # mixed-block byte edges are approximations


# --------------------------------------------------------------------------
# EfficientNet-B0  (224×224, MBConv stages; heavy depthwise share)
# --------------------------------------------------------------------------

def efficientnet_b0() -> ModelDAG:
    # stage: (expansion, cout, reps, stride, k)
    cfg = [(1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5),
           (6, 80, 3, 2, 3), (6, 112, 3, 1, 5), (6, 192, 4, 2, 5),
           (6, 320, 1, 1, 3)]
    blocks: list[Block] = []
    f, h, w = conv_flops(224, 224, 3, 32, 3, 2)
    blocks.append(_block("stem", "conv", f, 3 * 32 * 9, 224, 224, 3,
                         h, w, 32, halo=0.05))
    cin = 32
    for si, (exp, cout, reps, stride, k) in enumerate(cfg):
        for r in range(reps):
            s = stride if r == 0 else 1
            mid = cin * exp
            fe = conv_flops(h, w, cin, mid, 1)[0] if exp != 1 else 0.0
            fd, ho, wo = conv_flops(h, w, mid, mid, k, s, groups=mid)
            fp, _, _ = conv_flops(ho, wo, mid, cout, 1)
            params = cin * mid + mid * k * k + mid * cout
            # depthwise FLOPs dominate runtime on GPU → mark the block dwconv
            blocks.append(_block(f"mb{si}_{r}", "dwconv", fe + fd + fp, params,
                                 h, w, cin, ho, wo, cout, halo=0.04))
            h, w, cin = ho, wo, cout
    f, _, _ = conv_flops(h, w, 320, 1280, 1)
    blocks.append(_block("headconv", "conv", f, 320 * 1280, h, w, 320,
                         h, w, 1280))
    blocks.append(_block("fc", "dense", dense_flops(1280, 1000), 1280 * 1000,
                         h, w, 1280, 1, 1, 1000))
    return chain("efficientnet_b0", blocks, 224 * 224 * 3 * BYTES,
                 1000 * BYTES)


EDGE_MODELS = {
    "resnet152": resnet152,
    "vgg19": vgg19,
    "inceptionv3": inceptionv3,
    "efficientnet_b0": efficientnet_b0,
}


# --------------------------------------------------------------------------
# Table II devices.  Affinity rows implement the paper's "CPU-friendly layer"
# effect: GPUs run depthwise convs at ~1/3 efficiency, dense layers at ~0.7.
# --------------------------------------------------------------------------

_GPU_AFF = (("dwconv", 0.35), ("dense", 0.7), ("mixed", 0.9))
_CPU_AFF = (("conv", 0.9), ("dwconv", 1.0), ("dense", 1.0), ("mixed", 0.9))
LOCAL_BW = 12e9            # CPU↔GPU shared-DRAM copy bandwidth (bytes/s)
WIRELESS_BW = 80e6         # paper: 80 MBps wireless


def _node(name: str, cpu_flops: float, gpu_flops: float, cpu_w: float,
          gpu_w: float, idle_w: float, default: str = "gpu") -> Node:
    return Node(name=name, processors=(
        Processor(name="cpu", kind="cpu", peak_flops=cpu_flops,
                  local_bw=LOCAL_BW, idle_power=idle_w / 2,
                  active_power=cpu_w, affinity=_CPU_AFF),
        Processor(name="gpu", kind="gpu", peak_flops=gpu_flops,
                  local_bw=LOCAL_BW, idle_power=idle_w / 2,
                  active_power=gpu_w, affinity=_GPU_AFF),
    ), net_bw=WIRELESS_BW, default_processor=default)


# Power model: whole-board static power dominates (SoC rails, DRAM, radio —
# what the on-board INA sensors meter), with modest per-processor deltas on
# top; this is what makes energy track latency in Fig. 5 (the paper: "lowest
# inference latency ... also reflects in the lowest energy consumption").

def jetson_orin_nx() -> Node:   # 8×A78 + 1024-core Ampere (CUDA default)
    return _node("orin_nx", 2.4e11, 1.1e12, 2.5, 8.0, 10.0)


def jetson_tx2() -> Node:       # 2×Denver2 + 4×A57 + 256-core Pascal
    return _node("tx2", 7.5e10, 3.2e11, 2.0, 5.0, 7.0)


def jetson_nano() -> Node:      # 4×A57 + 128-core Maxwell
    return _node("nano", 3.2e10, 1.2e11, 1.5, 3.5, 5.0)


def rpi5() -> Node:             # 2×A76 + VideoCore VII (no usable GPU default)
    return _node("rpi5", 3.2e10, 2.2e10, 2.0, 1.5, 4.0, default="cpu")


def rpi4() -> Node:             # 2×A72 + VideoCore VI (no usable GPU default)
    return _node("rpi4", 1.4e10, 1.1e10, 1.5, 1.2, 3.2, default="cpu")


def paper_cluster(n_nodes: int = 5) -> Cluster:
    """The paper's evaluation cluster, optionally truncated (Fig. 8 uses
    2–5 nodes, dropped slowest-first so the leader Orin always remains)."""
    all_nodes = (jetson_orin_nx(), jetson_tx2(), jetson_nano(), rpi5(), rpi4())
    return Cluster(nodes=all_nodes[:n_nodes])


def battery_cluster(n_nodes: int = 5, idle_scale: float = 0.05) -> Cluster:
    """The same boards deployed duty-cycled (battery/solar fleets with
    aggressive sleep states): idle draw shrinks to ``idle_scale`` of the
    wall-powered figures while active power is unchanged.

    On the wall-powered :func:`paper_cluster`, static power dominates and
    energy simply tracks latency (the paper: "lowest inference latency ...
    also reflects in the lowest energy consumption") — so the
    latency-optimal plan is already energy-optimal.  Duty-cycling breaks
    that degeneracy: active joules dominate, and roping slow helpers into a
    wide data split costs real energy for marginal speedup.  This is the
    regime where ``Objective("energy")`` / ``Objective("edp")`` planning
    pays off (see ``benchmarks/fig5_latency_energy.py --objective``)."""
    base = paper_cluster(n_nodes)
    return Cluster(nodes=tuple(
        dataclasses.replace(n, processors=tuple(
            dataclasses.replace(p, idle_power=p.idle_power * idle_scale)
            for p in n.processors))
        for n in base.nodes))


# Per-model compute intensity δ [cycles/flop] — calibrates absolute latency to
# the paper's Fig. 5 ranges (hundreds of ms).  Relative values follow each
# model's arithmetic-intensity profile (EffNet's depthwise convs have the
# worst locality; VGG's dense 3×3 convs the best).
MODEL_DELTA = {
    "resnet152": 70.0,
    "vgg19": 55.0,
    "inceptionv3": 80.0,
    "efficientnet_b0": 140.0,
}
