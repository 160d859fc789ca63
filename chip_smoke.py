#!/usr/bin/env python3
"""Proof that the PyTorch/CUDA port starts and is right on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an H100 and the CUDA
toolkit.  Imports nothing of jax and nothing of the JAX package.  Phases,
each of which exits non-zero when it fails:

1. the card (``nvidia-smi`` name and power limit); the seven kernel
   libraries (flash attention, its backward, decode attention, the SSD pass
   and its backward, the SSD decode step, the Mamba-2 prefill passes) are
   built from ``src/repro_torch/kernels/csrc`` (one nvcc per
   source, in parallel), and ptxas's registers and spill bytes are logged per
   instantiation (a tensor-core instantiation that spills fails: bf16
   attention forward and backward, the TF32 SSD pass and its backward);
2. each CUDA kernel against its plain PyTorch version on the card: the shape
   lists of ``tests/test_kernels.py`` (attention in fp32 and bf16 at its
   ``TOL``, the SSD pass and the whole scan at its atol 1e-4), then the
   serving paths' shapes (gemma-2b attention: head_dim 256, MQA, ragged,
   windowed, prompts of 441 and 39 tokens, decode lengths 0/1/32/1024;
   hymba-1.5b attention: 25 heads over 5, head_dim 64, window 1024, in bf16
   and fp32; qwen3-moe-30b-a3b's 32 heads over 4 and mixtral-8x7b's 32 over
   8 at head_dim 128; mamba2-780m's and hymba-1.5b's SSD at chunk 128 and
   39, and a strong-decay case whose log-decay cumsum falls below -100 in a
   chunk; cross-attention as whisper-tiny and llama-3.2-vision-11b call
   it: flash non-causal with q_offset 0 over 1601 vision keys and over
   fewer encoder rows than queries, decode with every length the whole
   cross cache); and the grouped MoE step (``moe_ep.moe_ep_a2a`` on
   ``torch._grouped_mm``) against the dense oracle, one full-width layer of
   qwen3 at 4 and 441 tokens (one case with an expert that gets no token)
   and of mixtral at 39, at the bf16 ``TOL``; the SSD backward kernel
   against ``ref.ssd_intra_chunk_bwd`` at atol 1e-4 (the reference's shape
   list, mamba2-780m's and hymba-1.5b's training shapes, a 39-token chunk,
   the strong-decay case; two calls give the same bits; and against its
   arithmetic on the CPU, ``ref.ssd_intra_chunk_bwd_tf32``), the SSD
   forward kernel's outputs and the whole scan's outputs at those shapes
   too, and the whole scan's gradients through it against autograd of
   ``ref.ssd_chunked``, with and without an incoming state; then each
   backward launch's device time by kernel name at the two training
   shapes of each backward kernel (``torch.profiler``); the SSD decode
   kernel against ``ref.ssd_decode_step`` at ``SSD_DECODE`` (granite-4.0-
   h-small's 256 rows, mamba2-780m's and hymba-1.5b's heads), x, B and C
   views into one conv output, the state stepped in place; the Mamba-2
   prefill passes (``mamba_prefill.mixer``) against their plain
   composition at ``MAMBA_PREFILL`` (granite-4.0-h-small's 1385 and 4096
   tokens, mamba2-780m's and hymba-1.5b's 512), from zeros and from a
   cache; and decode's two
   launches (split, combine) by name at gemma-2b's serving decode shape
   and at one share of ``decode_32k`` beside the whole call's time, the
   merge's at 2, 4 and 8 ranks beside its bound, and an empty launch's;
3. calibrate and plan, the paper's analyzer loop: ``Profiler.profile_kernels``
   on ``cuda:0`` sweeps the three kernels through ``ops`` in fp32 at the JAX
   package's ``DEFAULT_KERNEL_SHAPES`` and the serving shapes timed in 5,
   keyed to the planner's H100 resource (``gpu_node("h100")``), and each
   kernel's counter must rise by exactly (warmup + repeats) x shapes; the
   fitted ``LearnedCostModel`` goes through a ``CalibrationStore`` and back
   unchanged; the ``CalibratedCostProvider`` must price gemma-2b's
   attention layers from the card's entry, not the datasheet, and backs a
   ``PlanCache`` over ``HiDPPlanner``.  One line per sample (key, kind,
   shape, ms, fitted rate) and, for the serving shapes, the sweep's time
   beside the queued device time of the same call.  Then GPU-tier planning
   and elasticity, on the host: an ``ElasticController`` on the H100 for
   gemma-2b's ``train_4k`` over two 8-GPU hosts (``GPU_MULTI_NODE``),
   driven by a ``FleetController`` over ``paper_cluster(2)`` whose tx2
   leaves and returns, must go 2 -> 1 -> 2 hosts in 2 re-plans; and
   ``plan_gpu`` plans every applicable cell of the 10 configs x 4 shapes x
   (``GPU_NODE``, ``GPU_MULTI_NODE``), one line each (layout, the three
   predicted terms, resident GiB, planning ms on the host);
4. the serving paths at full width, each a ``ServingEngine(max_batch=4,
   max_len=1024)`` on seeded random bf16 weights, every kernel's launch
   counter set to 0 just before the run and read just after:
   - gemma-2b, all 18 layers, 8 requests: flash and decode attention; the
     same requests again through the plan cache (its tenant
     ``block_costs`` of a 4 x 1024 decode step) and a ``FeedbackLoop``
     (1 miss and 7 hits, plus a re-plan per drift event; every decode step
     after the first observed; the same greedy tokens), then a third time
     under fleet churn: a ``PlanCache`` over ``battery_cluster()`` keyed
     on the membership of a ``FleetController`` whose tx2 leaves after
     decode step 8 and returns after step 24, each epoch re-entering
     EXPLORE through ``on_membership_change``, with a ``TelemetryRecorder``
     (exactly 2 re-plans and 2 misses, no tx2 in the plan made while it is
     away, the greedy tokens and flash/decode launch counts of the run
     without churn, the recorder's ``engine.replan`` counters and
     ``fleet.membership`` gauges at epochs 1 and 2), then the paper's
     evaluation layer over these runs (``evaluation_phase``, on the
     host): the churn run's recorder flushed into the port's ``RunStore``
     (a fresh store reads the same canonical lines; ``engine.*`` spans;
     ``report.generate`` and the report CLI exit 0); the counted run's
     launch counts (gated) and decode step (informational) as a regress
     snapshot (the CLI's self-diff exits 0, the flash count doubled
     exits 1); the four ``STRATEGIES`` on the simulator for every
     ``EDGE_MODELS`` entry on ``paper_cluster()`` (HiDP lowest in latency
     and energy; simulated seconds of the cost model, not card
     measurements) and on one H100 priced by the card-calibrated provider
     for gemma-2b's decode step; open-loop load through
     ``OpenLoopHarness`` priced by the calibrated ``PlanCache`` (every
     arrival in one terminal state, one plan resolution per tenant, each
     ``load.request`` critical path summing to its latency) and a
     saturation sweep priced at the counted run's measured seconds a
     request; then prefill-then-decode logits against the full forward
     and a profiler window over decode steps (device-busy share);
   - mamba2-780m, all 48 layers, 8 requests: the SSD kernels (the
     intra-chunk pass and the decode step) and no attention kernel, then
     prefill-then-decode against the full forward and profiler windows over
     decode steps and over one prefill;
   - hymba-1.5b, all 32 layers, 4 requests: all four kernels, and the
     two profiler windows;
   - whisper-tiny, whole (4 encoder and 4 decoder layers), and
     llama-3.2-vision-11b at full width and depth (40 layers: 8 groups of
     4 self layers and a cross layer), 8 requests each: flash exactly 12
     (whisper) and 40 (VLM) calls a prompt, decode 8 and 40 a decode step,
     SSD none; prefill-then-decode against the full forward with random
     frames or vision (VLM gates opened to 1.0), the decode and prefill
     profiler windows, and the VLM's decode step beside its bound;
   - qwen3-moe-30b-a3b, all 48 layers (56.9 GiB of weights, once the
     earlier paths are freed), 8 requests: flash exactly 8 x 48 calls,
     decode 48 per decode step, SSD none; prefill-then-decode against the
     full forward, the same prompt through ``moe_impl="ep_a2a"`` against
     ``"dense"``, the two profiler windows (a decode step runs no long copy
     kernel), a decode step's device and host ms under both lowerings
     beside their bounds, and the peak memory;
   - mixtral-8x7b at full width and 8 of its 32 layers (all 32 do not fit
     the card): prefill-then-decode and ``ep_a2a`` against ``"dense"``;
5. times at the serving shapes: kernel, plain version, one PyTorch library
   call where one computes the same function (``scaled_dot_product_attention``
   for attention, a yardstick the port never calls; none for the SSD pass),
   their ratio and the card's bound (for the SSD pass at every
   ``SSD_PREFILL`` shape; attention also at qwen3's heads); one qwen3 MoE
   layer, grouped and dense, beside its bound; engine tokens/s, prefill
   and decode-step ms.  Kernel times are device times: the timed call waits in
   the stream behind a sleep kernel, so the host's enqueue is not in them
   (the attention lines also give the time with it).  Cross-attention is
   timed the same way: flash at the VLM's 441 x 1601 and whisper's
   441 x 220, decode over 1601 and 512 rows; the flash backward at
   gemma-2b's training shape beside SDPA's backward; the SSD backward at
   mamba2-780m's and hymba-1.5b's training shapes beside its plain
   version (no library call computes it); the SSD decode step at every
   ``SSD_DECODE`` shape beside its bound (bytes) and the plain step with
   its copy of the new state into the cache; each Mamba-2 prefill pass at
   every ``MAMBA_PREFILL`` shape beside its bound, the intra-chunk kernel
   there, and the six launches beside the eager chain they replaced;
6. (run before the times) the training slice: the flash backward kernel
   against ``ref.attention_bwd_naive`` (with the forward's LSE against
   ``ref.attention_lse_naive``) on the reference's shape list in fp32 and
   bf16 and at the training shapes of gemma-2b (B=2, T=1024) and
   hymba-1.5b (B=1, T=2048, window 1024) (checked with the other kernels
   in phase 2; in bf16 also against its arithmetic,
   ``ref.attention_bwd_split``, and two calls give the same bits);
   ``repro_torch.launch.train`` at its defaults
   (reduced gemma-2b, 200 steps: the loss falls, checkpoints every 50
   steps) and a second run resuming from its last checkpoint; gemma-2b at
   full width and 2 layers, loss and gradients through the kernels against
   attention on the plain version; gemma-2b at full width and depth, 5
   steps of ``make_train_step`` (remat, chunked CE, fp32 AdamW state):
   exactly 36 forward and 18 backward flash calls a step, step ms,
   tokens/s, peak memory and the device-busy share of one step; then the
   SSM and hybrid families: mamba2-780m at full width and 2 layers against
   the SSD on its plain version, the trainer CLI with ``--arch
   mamba2-780m``, and 5 full-depth steps each of mamba2-780m (B=2,
   T=1024: exactly 96 forward and 48 backward SSD calls a step) and
   hymba-1.5b (B=1, T=2048: 64 and 32 SSD calls, 64 and 32 flash calls);
   the loss must fall in each of the three full-depth runs.  Then MoE
   training: ``torch._grouped_mm``'s gradients (bf16 rows against an fp32
   expert stack through its bf16 cast, empty groups among them) against a
   loop of per-expert products; one qwen3-moe-30b-a3b MoE layer at full
   width over B=2 x T=1024 tokens, the gradients of a random cotangent
   (router, w_gate, w_up, w_down, x) through ``moe_ep_a2a`` against
   ``moe_dense`` (relative norm 1e-2) and through its int8 payload against
   the bf16 one (3e-2), and the assignments kept at capacity factor 1.25;
   the model at full width and 2 layers, loss and gradients under
   ``moe_impl="ep_a2a"`` against ``"dense"`` (each token routed apart a
   near tie, leaves at 5e-2); then qwen3-moe-30b-a3b at full width and 3
   of its 48 layers (4 run out of memory in the optimizer step), 5 steps
   under each of ``"ep_a2a"``, ``"ep_a2a_q8"`` and ``"dense"`` from the same
   initialisation: exactly 6 forward and 3 backward flash calls a step, the
   loss falling, step ms, tokens/s, peak memory and one profiled step.
   The flash backward is also checked and timed at qwen3's training shape
   (B=2, T=1024, 32 heads over 4, D=128) beside SDPA's backward;
7. (run after the training slice) the multi-GPU slice over NCCL at world
   1: a process group of one rank (a ``FileStore`` in a temporary
   directory) and a (1, 1) ("data", "model") mesh from
   ``launch.mesh.make_smoke_mesh``; one full-width qwen3-moe-30b-a3b MoE
   layer over B=2 x T=1024 tokens through ``moe_ep``'s multi-rank path
   (the mesh published: dispatch buffers, the all-to-alls over the EP
   group) against the in-process step, in bf16 and int8 (output at the
   bf16 TOL, gradients at 1e-2 by relative norm), and the dispatch
   all-to-all's device time; gemma-2b at full width and depth, 5 steps of
   the unsharded ``make_train_step`` and of the sharded step
   (``sharding.spmd``) under ``P1_pure_dp`` and ``fsdp_all`` from one
   seed: losses at rtol 2e-3 and parameters at atol 3e-3 (the reference's
   tolerances), exactly 36 forward and 18 backward flash calls a step,
   step ms, peak GiB and busy share each; the same under the
   tensor-parallel ``dp_tp`` and ``dp_tp_fsdp`` (at world 1 no activation
   crosses: their cost over the others is DTensor's and the host's);
   qwen3-moe-30b-a3b at full width and 3 of 48 layers, 5 sharded steps
   under ``dp_sp_fsdp_ep``, ``dp_sp_fsdp_ep_q8``, ``dp_tp_ep`` and
   ``dp_tp_ep_q8`` against the in-process ``"ep_a2a"`` and
   ``"ep_a2a_q8"`` runs above; the GPipe pipeline at world 1 against the
   flat stack (gemma-2b at full width, 2 layers) and one pipelined step's
   loss; flash forward and backward at one rank's share of an 8-way
   sequence split of qwen3's step (128 queries over 1024 keys, offsets 0
   and 896) against their plain versions, timed beside SDPA; and the
   dry-run's host processes, started before the training slice (beside
   the host-bound serving paths they would slow them) and read after the
   times of phase 5: gemma-2b's two world-1 cells' predicted peak beside
   the measured one (the four of ``DENSE_LAYOUTS``), and ``train_4k`` of
   every arch on both GPU meshes,
   one line a cell beside the planner's predicted resident GiB and
   collective ms;
8. (run after the multi-GPU phase) tensor-parallel serving: the decode
   kernel at each of 8 shares of a 128 x 32768 cache (each share's
   ``k_offset``, its rows' log-sum-exp), the shares merged by
   ``decode_attention.merge``, against the kernel on the whole cache and
   ``ref.decode_attention_naive`` at the bf16 ``TOL`` and each (sequence,
   head) row within 1e-2 by relative norm (``TP_ROW_RTOL``), with gemma-2b's
   heads and with gemma3-1b's at its window of 512; the combine kernel at
   both its call sites, at each head dim of the kernels' dispatch list in
   bf16 and fp32: the decode call at the shapes whose ``split_plan`` gives
   2, 9, 32 and 128 splits (``COMBINE_SPLITS``; random lengths that leave
   splits empty, an empty row) against ``ref.decode_attention_split`` and
   ``ref.decode_attention_naive`` at ``TOL`` and its LSE against the split
   version's, and the merge of 1, 2, 4 and 8 ranks (``MERGE_RANKS``; a
   quarter of the ranks empty, rows where every rank is) against
   ``ref.decode_merge`` at ``TOL`` and per row at ``TP_ROW_RTOL``, an empty
   row exactly 0; one share at full lengths and the merge timed beside
   their bounds; gemma-2b at full width
   and depth through ``spmd.make_sharded_prefill`` and
   ``make_sharded_decode`` under ``dp_tp`` at world 1 over NCCL (B=16 x
   S=32768 of cache, a 1024-token prompt, 8 decode steps): logits equal
   the unsharded steps', exactly 18 flash calls and 18 decode calls a
   step, step ms, busy share and peak beside the dry-run's of the same
   cell; then world 2 on the one card (two processes over gloo, full
   width, 2 layers), where gemma's one KV head puts the cache's sequence
   over ``model``: logits within 1e-1 of the unsharded steps', 16 merges.
9. tensor-parallel training at world 2 on the one card (two processes
   over gloo on a (1, 2) mesh): gemma-2b and mamba2-780m at full width
   and 2 layers, B=2 x T=1024, 2 ``dp_tp`` steps against 2 unsharded
   steps on each rank: losses at rtol 2e-3, the first clip norm at 1e-2
   (bf16 partial sums across ranks), each rank's shards of the final
   parameters at atol 2 x 3e-3, and exactly the unsharded step's launches
   a step on each rank (gemma: every rank runs all heads through its one
   KV head; mamba2: the SSD pass on 24 of 48 heads).
   The dry-run's serving cells (``decode_32k`` of every arch on
   ``GPU_NODE``, mistral-large-123b's ``prefill_32k``) start after it and
   must trace ``ok``; so must its tensor-parallel training cells
   (``train_4k`` of every arch under a forced ``dp_tp``, and ``dp_tp_ep``
   for the MoE archs, each beside the planner's resident estimate),
   traced in four host processes at the lowest priority from right after
   the build (about 1250 s of host time in all).

The last two lines are the ``{"kernels": [...]}`` record (seven kernel
libraries, and the merge's entry point) and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.core import (ANALYTIC, EDGE_MODELS,  # noqa: E402
                              MODEL_DELTA, STRATEGIES, Cluster, HiDPPlanner,
                              PlannerConfig, battery_cluster, gpu_node,
                              node_as_resource, paper_cluster, plan_to_dict,
                              processors_as_resources, simulate)
from repro_torch.fleet import ChurnTrace, FleetController  # noqa: E402
from repro_torch.kernels import _build, ops, ref, ssd_decode  # noqa: E402
from repro_torch.kernels import mamba_prefill  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.load import (ArrivalTrace, FixedServiceModel,  # noqa: E402
                              LoadConfig, OpenLoopHarness, PlanServiceModel,
                              TenantSpec, mix_capacity, saturation_sweep)
from repro_torch.models import ShapeConfig, build_model  # noqa: E402
from repro_torch.models import SHAPES as CELLS  # noqa: E402
from repro_torch.models import shape_applicable  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe_ep  # noqa: E402
from repro_torch.profiling import (DEFAULT_KERNEL_SHAPES,  # noqa: E402
                                   CalibratedCostProvider, CalibrationStore,
                                   FeedbackLoop, LearnedCostModel, Profiler)
from repro_torch.profiling.profiler import kernel_call  # noqa: E402
from repro_torch.runtime import ElasticController  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.plan_cache import PlanCache  # noqa: E402
from repro_torch.sharding.plan import (GPU_MULTI_NODE, GPU_NODE,  # noqa: E402
                                       H100, MeshDesc, ShardingPlan,
                                       plan_gpu)
from repro_torch.telemetry import (RunStore, TelemetryRecorder,  # noqa: E402
                                   regress, report, trace)
from repro_torch.training import checkpoint as train_ckpt  # noqa: E402
from repro_torch.training import optimizer as train_optim  # noqa: E402
from repro_torch.training import train_loop  # noqa: E402
from repro_torch.training import tree as train_tree  # noqa: E402
from repro_torch.training.data import SyntheticDataset  # noqa: E402

# tests/test_kernels.py's lists (that module imports jax); a CPU test holds
# these copies equal to it.
SHAPES = [
    # (b, tq, tk, hq, hkv, d, window, causal, bq, bk)
    (1, 128, 128, 4, 4, 64, None, True, 64, 64),
    (2, 64, 64, 8, 2, 32, None, True, 16, 32),
    (2, 37, 53, 6, 3, 16, 12, True, 16, 16),
    (1, 32, 32, 4, 1, 128, None, False, 32, 16),
    (3, 1, 96, 8, 4, 64, None, True, 16, 32),
    (2, 80, 80, 5, 5, 48, 24, True, 32, 32),
]
DECODE_SHAPES = [
    # (b, s, hq, hkv, d, window, bk)
    (2, 128, 8, 2, 64, None, 32),
    (3, 96, 4, 4, 32, 24, 32),
    (1, 64, 8, 1, 128, None, 64),
    (4, 256, 12, 3, 64, 100, 128),
]
SSD_SHAPES = [(1, 64, 4, 8, 16, 16), (2, 48, 2, 16, 8, 8),
              (1, 33, 3, 8, 4, 16), (2, 128, 8, 16, 32, 32)]
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SSD_ATOL = 1e-4

# gemma-2b attention: 8 query heads over one kv head, head_dim 256
HQ, HKV, HD = 8, 1, 256
# hymba-1.5b attention: 25 query heads over 5 kv heads, head_dim 64, every
# layer windowed at 1024
HYMBA_ATTN = (25, 5, 64, 1024)
# qwen3-moe-30b-a3b attention: 32 query heads over 4 kv heads, head_dim 128,
# no window; mixtral-8x7b: 32 over 8, head_dim 128, every layer windowed at
# 4096
QWEN3_ATTN = (32, 4, 128, None)
MIXTRAL_ATTN = (32, 8, 128, 4096)
QWEN3, MIXTRAL = "qwen3-moe-30b-a3b", "mixtral-8x7b"
# mixtral-8x7b runs at full width and 8 of its 32 layers: its 86.99 GiB of
# bf16 weights at full depth do not fit the card's 80 GB (8 layers: 22.1 GiB)
MIXTRAL_LAYERS = 8
# the grouped MoE step against the dense oracle, one layer at full width:
# (arch, tokens, expert forced to get no token or None).  qwen3's 4 decode
# tokens route 32 assignments over 128 experts, so most groups are empty
# there too.
MOE_CASES = [(QWEN3, 4, None), (QWEN3, 441, None), (QWEN3, 441, 0),
             (MIXTRAL, 39, None)]
# the engine's longest and shortest prompts: ragged q and kv tiles
RAGGED_PREFILL = (441, 39)
# prefill (B, T, window): the engine prefills one prompt of 32..512 tokens
# (the first entry, recorded in the kernels line); the windowed case is
# gemma3's 512-token local layer
PREFILL = [(1, 512, None), (1, 128, None), (4, 512, None), (2, 1024, 512)]
# decode (lengths, window) over a (4, 1024) cache; 0 is an empty slot.  The
# first entry holds the engine's lengths (prompts of up to 512 tokens plus
# 32 new ones) and is recorded in the kernels line.
DECODE_LENS = [([544, 400, 256, 96], None), ([1024, 700, 33, 1], None),
               ([1024, 517, 2, 0], 512), ([0, 1, 32, 1024], None)]
# the SSD pass at the serving widths, (b, t, nh, hd, n, chunk): a 512-token
# prompt (four chunks of 128, the first entry is recorded in the kernels
# line) and a 39-token one (one short chunk), for mamba2-780m (48 heads,
# d_state 128) and hymba-1.5b (50 heads, d_state 16)
SSD_PREFILL = [(1, 512, 48, 64, 128, 128), (1, 39, 48, 64, 128, 128),
               (1, 512, 50, 64, 16, 128), (1, 39, 50, 64, 16, 128)]
# the SSD decode step at the serving widths, (b, nh, hd, n): granite-4.0-h-
# small's 256 rows of 128 heads (the benchmark cell's decode; timed first
# and recorded in the kernels line), mamba2-780m's 48 heads and hymba-1.5b's
# d_state 16 at 64 rows
SSD_DECODE = [(256, 128, 64, 128), (64, 48, 64, 128), (64, 50, 64, 16)]
# its tolerances (tests/test_torch_ssd_decode_chip.py): the state rounded
# as the plain version rounds it (room for one ulp of exp(dt A)), y's sum
# in another order (one bf16 ulp, 2^-8 relative)
SSD_DECODE_RTOL = {"state": 1e-6, torch.float32: 1e-5,
                   torch.bfloat16: 2 ** -7}
# the Mamba-2 mixer's prefill passes at the serving widths, (t, nh, hd, n,
# chunk, conv bias): granite-4.0-h-small's prompts of 1385 tokens (the
# benchmark mix's median, recorded in the kernels line) and 4096 (its
# longest), mamba2-780m's and hymba-1.5b's of 512
MAMBA_PREFILL = [(1385, 128, 64, 128, 256, True),
                 (4096, 128, 64, 128, 256, True),
                 (512, 48, 64, 128, 128, False),
                 (512, 50, 64, 16, 128, False)]
# their tolerances (tests/test_torch_mamba_prefill_chip.py): the output
# within two bf16 ulps (2^-7 relative at least), the final state 1e-5
MAMBA_PREFILL_RTOL = {"y": 2 ** -6, "state": 1e-5}
# the SSM and hybrid training cells, B x T per step.  hymba-1.5b trains on
# 2048 tokens so that its window of 1024 masks keys in the flash forward
# and backward (at T=1024 it never would)
SSM_TRAIN_BATCH = {"mamba2-780m": (2, 1024), "hymba-1.5b": (1, 2048)}
# the SSD pass at those shapes, (b, t, nh, hd, n, chunk): mamba2-780m's
# eight chunks (timed and recorded in the kernels line) and hymba-1.5b's
# sixteen chunks of its 50-head, d_state 16 branch
SSD_TRAIN = [(2, 1024, 48, 64, 128, 128), (1, 2048, 50, 64, 16, 128)]
# strong decay: mamba2 widths with A scaled by 20, so that the log-decay
# cumsum falls below -100 inside a chunk and exp(dacs_i - dacs_j) overflows
# for j > i (the kernel selects before the exp)
STRONG_DECAY, STRONG_DECAY_A = (1, 256, 48, 64, 128, 128), 20.0
# cross-attention, non-causal with q_offset 0 and no lengths, as the models
# call it: (b, tq, tk, hq, hkv, d).  llama-3.2-vision-11b's 441- and 39-token
# prompts over its 1601 vision tokens (not a multiple of the 64-key tile),
# and whisper-tiny's decoder over its plen // 2 encoder rows (Tq > Tk).  The
# first of each model is timed.
CROSS_SHAPES = [(1, 441, 1601, 32, 8, 128), (1, 39, 1601, 32, 8, 128),
                (1, 441, 220, 6, 6, 64), (1, 39, 19, 6, 6, 64)]
# decode over a static cross cache, every length the whole cache
# (b, s, hq, hkv, d): the VLM's 1601 vision rows (not a multiple of the
# 32-key tile) and whisper-tiny's max_len // 2 encoder rows
CROSS_DECODE_SHAPES = [(4, 1601, 32, 8, 128), (4, 512, 6, 6, 64)]
WHISPER, VLM = "whisper-tiny", "llama-3.2-vision-11b"
MAX_BATCH, MAX_LEN, N_REQUESTS, MAX_NEW = 4, 1024, 8, 32
HYBRID_REQUESTS = 4
# the churn phase's trace: tx2 leaves the battery fleet and comes back; the
# fleet advances to CHURN_AT[i][1] right after decode step CHURN_AT[i][0]
CHURN = [(1.0, "tx2", "leave"), (2.0, "tx2", "join")]
CHURN_AT = ((8, 1.5), (24, 2.5))
# published dense peaks of one H100 SXM (NVIDIA data sheet): bf16 and TF32
# tensor cores, memory
PEAK_BF16_FLOPS, PEAK_TF32_FLOPS, PEAK_BYTES = 989e12, 495e12, 3.35e12
# fp32 outside the tensor cores (the same data sheet)
PEAK_FP32_FLOPS = 67e12
# each kernel's wrapper module, whose ``launches`` counts its calls that
# launched the kernel (a decode-attention call is two launches: split and
# combine)
COUNTERS = {"flash_attention": fa, "decode_attention": da,
            "ssd_intra_chunk": ssd_scan, "ssd_decode": ssd_decode,
            "mamba_prefill": mamba_prefill}
# the kernel kind each counter's calls are swept under by
# ``Profiler.profile_kernels``
SWEEP_KINDS = {"attn": "flash_attention", "decode": "decode_attention",
               "ssd": "ssd_intra_chunk"}
# the calibration sweep: the JAX package's DEFAULT_KERNEL_SHAPES plus the
# serving shapes timed below, in the sweep's layouts ((B, T, H, D) with one
# head count for attention, so gemma-2b's 8 query heads at head_dim 256;
# (B, T, NH, HD, N) for the SSD scan, mamba2-780m's widths over a 512-token
# prompt)
SWEEP_SERVING = {"attn": ((1, 512, HQ, HD),),
                 "decode": ((MAX_BATCH, MAX_LEN, HQ, HD),),
                 "ssd": ((1, 512, 48, 64, 128),)}


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def _randn(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _check(name, got, want, tol, rtol=None) -> float:
    """|got - want| <= tol + rtol * |want| element-wise (rtol defaults to
    tol), and got finite; returns the largest |got - want|."""
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    bound = tol + (tol if rtol is None else rtol) * want.float().abs()
    if not bool(torch.isfinite(got.float()).all()) or bool((err > bound).any()):
        raise AssertionError(f"{name}: max |err| {err.max().item():.3e} over "
                             f"tolerance {tol}")
    return err.max().item()


def flash_case(b, tq, tk, hq, hkv, d, window, causal, dtype, lens, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = _randn((b, tq, hq, d), dtype, gen)
    k = _randn((b, tk, hkv, d), dtype, gen)
    v = _randn((b, tk, hkv, d), dtype, gen)
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    kw = dict(causal=causal, window=window, q_offset=tk - tq, lengths=lens)
    return (q, k, v), kw


def decode_case(b, s, hq, hkv, d, dtype, lens, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = _randn((b, 1, hq, d), dtype, gen)
    kc = _randn((b, s, hkv, d), dtype, gen)
    vc = _randn((b, s, hkv, d), dtype, gen)
    return (q, kc, vc), torch.tensor(lens, dtype=torch.int32, device="cuda")


def ssd_case(b, t, nh, hd, n, seed, a_scale=1.0):
    """(x, dt, A, B, C, D) drawn like tests/test_kernels.py::_mk_ssd, A
    multiplied by ``a_scale``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    return (rn(b, t, nh, hd) * 0.5,
            torch.nn.functional.softplus(rn(b, t, nh)) * 0.1,
            -torch.exp(rn(nh)) * a_scale, rn(b, t, n) * 0.3,
            rn(b, t, n) * 0.3, torch.full((nh,), 0.1, device="cuda"))


def check_ssd(shape, seed, a_scale=1.0) -> float:
    """The SSD kernel against its plain version, and the whole scan around
    it against ``ref.ssd_chunked`` with and without an incoming state, at
    atol 1e-4; returns the kernel's largest error."""
    b, t, nh, hd, n, chunk = shape
    x, dt, A, B, C, D = ssd_case(b, t, nh, hd, n, seed, a_scale)
    ops_ = ssd_scan.chunk_operands(x, dt, A, B, C, chunk)
    got = ssd_scan.ssd_intra_chunk(*ops_, nh=nh, hd=hd)
    want = ref.ssd_intra_chunk(*ops_, nh=nh, hd=hd)
    err = max(_check(f"ssd_intra_chunk {shape} {part}", g, w, SSD_ATOL, 0.0)
              for part, g, w in zip(("y_diag", "states"), got, want))
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    h0 = torch.randn((b, nh, hd, n), generator=gen, device="cuda") * 0.1
    for h in (None, h0):
        got = ssd_scan.ssd(x, dt, A, B, C, D, chunk=chunk, h0=h)
        want = ref.ssd_chunked(x, dt, A, B, C, D, chunk=chunk, h0=h)
        for part, g, w in zip(("y", "state"), got, want):
            _check(f"ssd {shape} h0={h is not None} {part}", g, w, SSD_ATOL,
                   0.0)
    return err


def _bwd_case(ops_, nh, hd, seed):
    """Seeded gradients (dy, dstates) of the pass's two outputs."""
    b, nc, c, _ = ops_[0].shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn((b, nc, c, nh * hd), generator=gen, device="cuda"),
            torch.randn((b, nc, nh, ops_[2].shape[-1], hd), generator=gen,
                        device="cuda"))


def check_ssd_bwd(shape, seed, a_scale=1.0) -> tuple[float, float]:
    """The SSD forward kernel's two outputs (y_diag, states) against
    ``ref.ssd_intra_chunk`` at this shape, and the backward kernel against
    ``ref.ssd_intra_chunk_bwd`` from the same operands and seeded output
    gradients, both at atol 1e-4 (two backward calls give the same bits: no
    atomics), and against its arithmetic ``ref.ssd_intra_chunk_bwd_tf32``
    at atol 1e-4; then the whole scan through ``SSDIntraChunkFn`` on the kernels
    against ``ref.ssd_chunked``, with and without an incoming state: its
    outputs (y, final state) at atol 1e-4, and its gradients (x, dt, A, B,
    C, D, h0) through ``torch.autograd.grad`` at atol 1e-4 plus 1e-4 of each
    gradient's largest element: A's gradient sums over every position and
    head column of a head (2 x 1024 x 64 terms at mamba2-780m's training
    shape), so fp32 sums in another order part by more than 1e-4 where the
    gradient is large (2.4e-4 seen there).  Returns the forward kernel's and
    the backward kernel's largest errors."""
    b, t, nh, hd, n, chunk = shape
    x, dt, A, B, C, D = ssd_case(b, t, nh, hd, n, seed, a_scale)
    ops_ = ssd_scan.chunk_operands(x, dt, A, B, C, chunk)
    got = ssd_scan.ssd_intra_chunk(*ops_, nh=nh, hd=hd)
    want = ref.ssd_intra_chunk(*ops_, nh=nh, hd=hd)
    fwd_err = max(_check(f"ssd_intra_chunk {shape} {part}", g, w, SSD_ATOL,
                         0.0)
                  for part, g, w in zip(("y_diag", "states"), got, want))
    dy, dstates = _bwd_case(ops_, nh, hd, seed + 1)
    got = ssd_scan.ssd_intra_chunk_bwd(*ops_, dy, dstates, nh=nh, hd=hd)
    want = ref.ssd_intra_chunk_bwd(*ops_, dy, dstates, nh=nh, hd=hd)
    err = max(_check(f"ssd_intra_chunk_bwd {shape} {part}", g, w, SSD_ATOL,
                     0.0)
              for part, g, w in zip(("dxdt", "ddacs", "dB", "dC"), got,
                                    want))
    again = ssd_scan.ssd_intra_chunk_bwd(*ops_, dy, dstates, nh=nh, hd=hd)
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
        raise AssertionError(f"ssd_intra_chunk_bwd {shape}: two calls part")
    model = ref.ssd_intra_chunk_bwd_tf32(*ops_, dy, dstates, nh=nh, hd=hd)
    for part, g, w in zip(("dxdt", "ddacs", "dB", "dC"), got, model):
        _check(f"ssd_intra_chunk_bwd {shape} {part} vs its arithmetic", g, w,
               SSD_ATOL, 0.0)
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    h0 = torch.randn((b, nh, hd, n), generator=gen, device="cuda") * 0.1
    gy = torch.randn(x.shape, generator=gen, device="cuda")
    gh = torch.randn(h0.shape, generator=gen, device="cuda")
    for h in (None, h0):
        leaves = [v.clone().requires_grad_(True)
                  for v in (x, dt, A, B, C, D, h0)]
        outs, grads = [], []
        for fn in (ssd_scan.ssd, ref.ssd_chunked):
            out = fn(*leaves[:6], chunk=chunk,
                     h0=None if h is None else leaves[6])
            outs.append(out)
            grads.append(torch.autograd.grad(
                out, leaves[:6 if h is None else 7], (gy, gh)))
        for part, g, w in zip(("y", "state"), *outs):
            _check(f"ssd {shape} h0={h is not None} {part}", g.detach(),
                   w.detach(), SSD_ATOL, 0.0)
        for name, g, w in zip(("x", "dt", "A", "B", "C", "D", "h0"),
                              *grads):
            scale = w.abs().max().item()
            _check(f"ssd grad {shape} h0={h is not None} d{name} (largest "
                   f"{scale:.3e})", g, w, SSD_ATOL * (1 + scale), 0.0)
    return fwd_err, err


def check_ssd_backward() -> float:
    """The SSD forward and backward kernels at the reference's shape list,
    the training shapes of mamba2-780m and hymba-1.5b, a ragged 39-token
    chunk and the strong-decay case; returns the backward's largest error
    at the training shapes."""
    before = ssd_scan.launches, ssd_scan.bwd_launches
    for i, shape in enumerate(SSD_SHAPES):
        check_ssd_bwd(shape, 1800 + i)
    log(f"ssd backward vs plain, reference shape list: {len(SSD_SHAPES)} "
        f"cases within atol {SSD_ATOL}, forward outputs and whole-scan "
        "gradients with and without h0")
    worst = 0.0
    for i, shape in enumerate(SSD_TRAIN):
        fwd, err = check_ssd_bwd(shape, 1850 + i)
        log(f"  ssd fwd/bwd {shape} training: max|err| {fwd:.3e} / "
            f"{err:.3e}")
        worst = max(worst, err)
    fwd, err = check_ssd_bwd(SSD_PREFILL[1], 1870)
    log(f"  ssd fwd/bwd {SSD_PREFILL[1]} ragged chunk: max|err| {fwd:.3e} / "
        f"{err:.3e}")
    fwd, err = check_ssd_bwd(STRONG_DECAY, 1880, STRONG_DECAY_A)
    log(f"  ssd fwd/bwd {STRONG_DECAY} strong decay (A x {STRONG_DECAY_A}): "
        f"max|err| {fwd:.3e} / {err:.3e}")
    if ssd_scan.bwd_launches == before[1] or ssd_scan.launches == before[0]:
        raise AssertionError("the SSD gradient checks launched no kernel")
    torch.cuda.synchronize()
    return worst


def ssd_decode_case(shape, dtype, seed):
    """(h, x, dt, A, B, C, D) for one decode step, drawn like
    ``ssd_case``; x, B and C views into one (b, 1, nh*hd + 2n) tensor of
    ``dtype``, as the mixer passes them from its conv output."""
    b, nh, hd, n = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*s):
        return torch.randn(s, generator=gen, device="cuda")
    conv_out = torch.cat([rn(b, 1, nh * hd) * 0.5, rn(b, 1, 2 * n) * 0.3],
                         -1).to(dtype)
    xs, B, C = torch.split(conv_out, [nh * hd, n, n], -1)
    dt = torch.nn.functional.softplus(rn(b, 1, nh))[:, 0] * 0.1
    return (rn(b, nh, hd, n) * 0.1, xs.reshape(b, 1, nh, hd)[:, 0], dt,
            -torch.exp(rn(nh)), B[:, 0], C[:, 0],
            torch.full((nh,), 0.1, device="cuda"))


def check_ssd_decode() -> float:
    """The SSD decode kernel against ``ref.ssd_decode_step`` at every
    ``SSD_DECODE`` shape, x in bf16 and fp32: the state stepped in place
    (the same storage) and y, at ``SSD_DECODE_RTOL``, one launch a call;
    returns the state's largest error."""
    before, worst = ssd_decode.launches, 0.0
    for i, shape in enumerate(SSD_DECODE):
        for dtype in (torch.bfloat16, torch.float32):
            h, *rest = ssd_decode_case(shape, dtype, 1900 + i)
            want_y, want_h = ref.ssd_decode_step(h, *rest)
            ptr = h.data_ptr()
            y = ssd_decode.ssd_decode_step_(h, *rest)
            if h.data_ptr() != ptr or y.dtype != dtype:
                raise AssertionError(f"ssd_decode {shape}: not in place")
            err = _check(f"ssd_decode {shape} {dtype} state", h, want_h,
                         1e-7, SSD_DECODE_RTOL["state"])
            y_err = _check(f"ssd_decode {shape} {dtype} y", y, want_y, 1e-5,
                           SSD_DECODE_RTOL[dtype])
            log(f"  ssd decode {shape} x {dtype}: state max|err| {err:.3e}, "
                f"y max|err| {y_err:.3e}")
            worst = max(worst, err)
    if ssd_decode.launches != before + 2 * len(SSD_DECODE):
        raise AssertionError(f"ssd_decode launched "
                             f"{ssd_decode.launches - before} times, not "
                             f"{2 * len(SSD_DECODE)}")
    return worst


def check_serving_attention(hq, hkv, hd, window, prefill, decode_lens,
                            seed, tag) -> tuple[float, float]:
    """Flash and decode attention at one model's serving heads against their
    plain versions, in bf16 and fp32; prefill (b, t) over t tokens with
    lengths t, 3t/4, ..., decode over a (4, 1024) cache.  Returns the
    largest bf16 errors (flash, decode)."""
    worst = [0.0, 0.0]
    for i, ((b, t), dtype) in enumerate(
            (c, dt) for c in prefill for dt in TOL):
        lens = [t, t * 3 // 4, t // 2, t // 4][:b]
        args, kw = flash_case(b, t, t, hq, hkv, hd, window, True, dtype, lens,
                              seed + i)
        err = _check(f"flash {tag} B={b} T={t} window={window} {dtype}",
                     fa.flash_attention(*args, **kw),
                     ref.attention_naive(*args, **kw), TOL[dtype])
        log(f"  flash   {tag} B={b} T={t:4d} window={window} {dtype}: "
            f"max|err| {err:.3e}")
        if dtype == torch.bfloat16:
            worst[0] = max(worst[0], err)
    for i, (lens, dtype) in enumerate(
            (c, dt) for c in decode_lens for dt in TOL):
        args, lt = decode_case(MAX_BATCH, MAX_LEN, hq, hkv, hd, dtype, lens,
                               seed + 50 + i)
        err = _check(f"decode {tag} lens={lens} window={window} {dtype}",
                     da.decode_attention(*args, lt, window=window),
                     ref.decode_attention_naive(*args, lt, window=window),
                     TOL[dtype])
        log(f"  decode  {tag} B=4 S=1024 lens={lens} window={window} "
            f"{dtype}: max|err| {err:.3e}")
        if dtype == torch.bfloat16:
            worst[1] = max(worst[1], err)
    return worst[0], worst[1]


def check_kernels() -> dict:
    """Every kernel against its plain version; returns the largest error at
    the main path's shapes per kernel."""
    n = 0
    for i, (b, tq, tk, hq, hkv, d, win, caus, _, _) in enumerate(SHAPES):
        for dtype in TOL:
            lens = [tk] + [max(tk * 2 // 3, 1)] * (b - 1)
            args, kw = flash_case(b, tq, tk, hq, hkv, d, win, caus, dtype,
                                  lens, i)
            _check(f"flash {SHAPES[i]} {dtype}", fa.flash_attention(*args, **kw),
                   ref.attention_naive(*args, **kw), TOL[dtype])
            n += 1
    for i, (b, s, hq, hkv, d, win, _) in enumerate(DECODE_SHAPES):
        for dtype in TOL:
            lens = [s] + [max(s // 3, 1)] * (b - 1)
            args, lens = decode_case(b, s, hq, hkv, d, dtype, lens, 100 + i)
            _check(f"decode {DECODE_SHAPES[i]} {dtype}",
                   da.decode_attention(*args, lens, window=win),
                   ref.decode_attention_naive(*args, lens, window=win),
                   TOL[dtype])
            n += 1
    for i, shape in enumerate(SSD_SHAPES):
        check_ssd(shape, 600 + i)
        n += 1
    log(f"kernels vs plain, reference shape lists: {n} cases within TOL "
        f"(attention) and atol {SSD_ATOL} (SSD)")
    worst = {"flash_attention": 0.0, "decode_attention": 0.0,
             "ssd_intra_chunk": 0.0}
    cases = [(b, t, w, torch.bfloat16) for b, t, w in PREFILL]
    cases.append((1, 128, None, torch.float32))
    for i, (b, t, win, dtype) in enumerate(cases):
        lens = [t, t * 3 // 4, t // 2, t // 4][:b]
        args, kw = flash_case(b, t, t, HQ, HKV, HD, win, True, dtype, lens,
                              200 + i)
        err = _check(f"flash gemma-2b B={b} T={t} window={win} {dtype}",
                     fa.flash_attention(*args, **kw),
                     ref.attention_naive(*args, **kw), TOL[dtype])
        log(f"  flash   B={b} T={t:4d} window={win} {dtype}: "
            f"max|err| {err:.3e}")
        if dtype == torch.bfloat16:
            worst["flash_attention"] = max(worst["flash_attention"], err)
    for i, (lens, win) in enumerate(DECODE_LENS):
        for dtype in TOL:
            args, lt = decode_case(MAX_BATCH, MAX_LEN, HQ, HKV, HD, dtype,
                                   lens, 300 + i)
            err = _check(f"decode gemma-2b lens={lens} window={win} {dtype}",
                         da.decode_attention(*args, lt, window=win),
                         ref.decode_attention_naive(*args, lt, window=win),
                         TOL[dtype])
            log(f"  decode  B=4 S=1024 lens={lens} window={win} {dtype}: "
                f"max|err| {err:.3e}")
            if dtype == torch.bfloat16:
                worst["decode_attention"] = max(worst["decode_attention"],
                                                err)
    gemma_flash, _ = check_serving_attention(
        HQ, HKV, HD, None, [(1, t) for t in RAGGED_PREFILL], [], 850,
        "gemma-2b")
    worst["flash_attention"] = max(worst["flash_attention"], gemma_flash)
    hymba_flash, hymba_decode = check_serving_attention(
        *HYMBA_ATTN, [(1, t) for t in RAGGED_PREFILL],
        [DECODE_LENS[0][0], DECODE_LENS[3][0]], 900, "hymba-1.5b")
    worst["flash_attention"] = max(worst["flash_attention"], hymba_flash)
    worst["decode_attention"] = max(worst["decode_attention"], hymba_decode)
    for heads, prefill, lens, seed, tag in (
            (QWEN3_ATTN, RAGGED_PREFILL, [DECODE_LENS[0][0],
                                          DECODE_LENS[1][0]], 950, QWEN3),
            (MIXTRAL_ATTN, RAGGED_PREFILL[:1], [DECODE_LENS[0][0]], 1000,
             MIXTRAL)):
        flash, decode = check_serving_attention(
            *heads, [(1, t) for t in prefill], lens, seed, tag)
        worst["flash_attention"] = max(worst["flash_attention"], flash)
        worst["decode_attention"] = max(worst["decode_attention"], decode)
    for i, shape in enumerate(SSD_PREFILL):
        err = check_ssd(shape, 700 + i)
        log(f"  ssd     {shape}: max|err| {err:.3e}")
        worst["ssd_intra_chunk"] = max(worst["ssd_intra_chunk"], err)
    b, t, nh, hd, n, chunk = STRONG_DECAY
    x, dt, A = ssd_case(b, t, nh, hd, n, 750, STRONG_DECAY_A)[:3]
    low = float(torch.cumsum(dt.reshape(b, -1, chunk, nh) * A, 2).min())
    if low >= -100:
        raise AssertionError(f"strong-decay case reaches only {low:.1f}")
    err = check_ssd(STRONG_DECAY, 750, STRONG_DECAY_A)
    log(f"  ssd     {STRONG_DECAY} strong decay (A x {STRONG_DECAY_A}, "
        f"log-decay down to {low:.1f}): max|err| {err:.3e}")
    flash, decode = check_cross()
    worst["flash_attention"] = max(worst["flash_attention"], flash)
    worst["decode_attention"] = max(worst["decode_attention"], decode)
    torch.cuda.synchronize()
    return worst


def cross_case(b, tq, tk, hq, hkv, d, dtype, seed):
    """q (b, tq, hq, d) and cross k/v (b, tk, hkv, d), and the keywords the
    models' cross-attention passes."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return ((_randn((b, tq, hq, d), dtype, gen),
             _randn((b, tk, hkv, d), dtype, gen),
             _randn((b, tk, hkv, d), dtype, gen)),
            dict(causal=False, window=None, q_offset=0, lengths=None))


def check_cross() -> tuple[float, float]:
    """Both attention kernels at the cross-attention shapes of whisper-tiny
    and llama-3.2-vision-11b against their plain versions, in bf16 and fp32:
    flash non-causal with q_offset 0 and no lengths (Tq above and below Tk),
    decode with every length the whole cache.  Returns the largest bf16
    errors (flash, decode)."""
    worst = [0.0, 0.0]
    for i, (shape, dtype) in enumerate(
            (c, dt) for c in CROSS_SHAPES for dt in TOL):
        args, kw = cross_case(*shape, dtype, 1300 + i)
        err = _check(f"flash cross {shape} {dtype}",
                     fa.flash_attention(*args, **kw),
                     ref.attention_naive(*args, **kw), TOL[dtype])
        log(f"  flash   cross (b, tq, tk, hq, hkv, d) = {shape} {dtype}: "
            f"max|err| {err:.3e}")
        if dtype == torch.bfloat16:
            worst[0] = max(worst[0], err)
    for i, ((b, s, hq, hkv, d), dtype) in enumerate(
            (c, dt) for c in CROSS_DECODE_SHAPES for dt in TOL):
        args, lt = decode_case(b, s, hq, hkv, d, dtype, [s] * b, 1350 + i)
        err = _check(f"decode cross B={b} S={s} {dtype}",
                     da.decode_attention(*args, lt),
                     ref.decode_attention_naive(*args, lt), TOL[dtype])
        log(f"  decode  cross B={b} S={s} heads {hq}/{hkv} D={d} lengths = "
            f"S {dtype}: max|err| {err:.3e}")
        if dtype == torch.bfloat16:
            worst[1] = max(worst[1], err)
    return worst[0], worst[1]


def moe_layer(cfg, seed: int) -> dict:
    """One layer's MoE parameters at full width in bf16, drawn as the port's
    init draws them: N(0, 1/fan_in), the fan-in each stack's second-last
    axis."""
    m = cfg.moe
    d, e, f = cfg.d_model, m.num_experts, m.d_ff_expert
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shapes = {"router": (d, e), "w_gate": (e, d, f), "w_up": (e, d, f),
              "w_down": (e, f, d)}
    return {k: (torch.randn(s, generator=gen, device="cuda")
                / s[-2] ** 0.5).bfloat16() for k, s in shapes.items()}


def moe_input(cfg, p: dict, t: int, seed: int, empty: int | None
              ) -> torch.Tensor:
    """(1, t, d) bf16 activations; with ``empty``, positive ones and that
    expert's router column at -100, so that it wins no token."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = _randn((1, t, cfg.d_model), torch.bfloat16, gen)
    if empty is not None:
        x = x.abs()
        p["router"][:, empty] = -100.0
    return x


def check_moe() -> float:
    """The grouped MoE step (``moe_ep.moe_ep_a2a``: sort by expert, three
    ``torch._grouped_mm`` products) against the dense oracle
    (``layers.moe_dense``) on the card, one full-width layer of each MoE
    arch, at the bf16 TOL; returns the largest error."""
    worst = 0.0
    for aid in dict.fromkeys(a for a, _, _ in MOE_CASES):
        cfg = get_config(aid)
        e = cfg.moe.num_experts
        for i, (_, t, empty) in enumerate(c for c in MOE_CASES
                                          if c[0] == aid):
            p = moe_layer(cfg, 1100 + i)
            x = moe_input(cfg, p, t, 1150 + i, empty)
            _, idx = L.moe_router(cfg.moe, p["router"], x.reshape(t, -1))
            n_empty = e - int(idx.unique().numel())
            if empty is not None and bool((idx == empty).any()):
                raise AssertionError(f"moe {aid} T={t}: expert {empty} was "
                                     "routed a token")
            if t * cfg.moe.top_k < e and n_empty == 0:
                raise AssertionError(f"moe {aid} T={t}: no empty expert")
            err = _check(f"moe ep_a2a vs dense {aid} T={t}",
                         moe_ep.moe_ep_a2a(cfg, p, x),
                         L.moe_dense(cfg, p, x), TOL[torch.bfloat16])
            log(f"  moe     {aid} E={e} top-{cfg.moe.top_k} "
                f"d={cfg.d_model} f={cfg.moe.d_ff_expert} T={t:3d}: "
                f"{n_empty} experts without a token"
                f"{'' if empty is None else f' (expert {empty} forced)'}; "
                f"grouped vs dense max|err| {err:.3e}")
            worst = max(worst, err)
            del p, x
        torch.cuda.empty_cache()
    return worst


def drive_main_path(model, params, prompts, **engine_kw) -> dict:
    """One engine run over ``prompts`` (``engine_kw`` reaches the engine:
    a plan cache, a feedback loop); every count is reset just before and
    read just after."""
    eng = ServingEngine(model, params, max_batch=MAX_BATCH, max_len=MAX_LEN,
                        **engine_kw)
    rids = [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    for mod in COUNTERS.values():
        mod.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: mod.launches for k, mod in COUNTERS.items()}
    return dict(eng=eng, rids=rids, done=done, wall=wall, launches=launches)


def check_engine(run, cfg, n: int, kernels) -> int:
    """All ``n`` requests answered with MAX_NEW in-vocab tokens each; the
    kernels named in ``kernels`` launched in the run and no other."""
    done, rids = run["done"], run["rids"]
    if len(done) != n or sorted(done) != sorted(rids):
        raise AssertionError(f"served {len(done)} of {n} requests")
    tokens = 0
    for rid in rids:
        gen = done[rid].generated
        if not done[rid].done or len(gen) != MAX_NEW:
            raise AssertionError(f"request {rid} ended with {len(gen)} tokens")
        if not all(0 <= t < cfg.vocab for t in gen):
            raise AssertionError(f"request {rid}: token out of [0, vocab)")
        tokens += len(gen)
    for name, count in run["launches"].items():
        if name in kernels and count <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
        if name not in kernels and count != 0:
            raise AssertionError(f"{name} launched {count} times on a path "
                                 "that does not run it")
    return tokens


def check_prefill_then_decode(model, params, cfg, limit: float,
                              extra: dict | None = None) -> float:
    """Prefill P tokens, decode one, compare with the full forward at P:
    5e-2 in relative norm, ``limit`` element-wise.  ``extra`` holds the stub
    frontends' input (``frames`` or ``vision``), given to the prefill and
    the full forwards alike.  Logs beside it how far the forward over P
    tokens and over P + 1 tokens part at position P - 1: 0 means the
    prompt's positions are computed exactly alike, and the error is the
    decode step's own arithmetic."""
    b, s = 2, 256
    p = s - 1
    extra = extra or {}
    gen = torch.Generator(device="cuda").manual_seed(7)
    toks = torch.randint(0, cfg.vocab, (b, s), generator=gen, device="cuda")
    # MoE layers on the dense oracle, the full forwards' lowering: top-k
    # routing parts at near ties between two paths (mixtral's position P
    # under the routed lowering at both ends: at layer 3 a gap of 4e-4 sent
    # it to expert 4 in the decode step and 5 in the full forward)
    _, pcache = model.apply_prefill(params, {
        **extra, "tokens": toks[:, :p],
        "lengths": torch.full((b,), p, dtype=torch.int32, device="cuda")},
        moe_impl="dense")
    cache = model.init_cache(b, s)
    for k, v in pcache.items():
        if k in ("k", "v"):                 # positions: the prompt's prefix
            cache[k][..., :p, :, :] = v
        else:                               # SSM state, conv context, cross
            cache[k].copy_(v)               # K/V: whole
    got, _ = model.apply_decode(params, cache, {
        "tokens": toks[:, p:],
        "lengths": torch.full((b,), p + 1, dtype=torch.int32,
                              device="cuda")}, moe_impl="dense")
    full = model.apply_train(params, {**extra, "tokens": toks})
    want = full[:, p]
    floor = (model.apply_train(params, {**extra, "tokens": toks[:, :p]})
             [:, p - 1] - full[:, p - 1]).abs().max().item()
    rel = ((got[:, 0] - want).norm() / want.norm()).item()
    top = (got[:, 0] - want).abs().max().item()
    log(f"prefill-then-decode vs full forward: relative error {rel:.3e}, "
        f"largest element {top:.3e}; forward over P vs P + 1 tokens at "
        f"P - 1: {floor:.3e}")
    if rel > 5e-2:
        raise AssertionError(f"prefill-then-decode: relative error {rel}")
    return _check("prefill-then-decode vs full forward", got[:, 0], want,
                  limit)


# Element-wise limits of the prefill-then-decode check, and why they are not
# the 5e-2 of tests/test_arch_smoke.py (which the reduced 2-layer configs
# hold in tests/test_torch_model.py and tests/test_torch_ssm.py).  On an
# H100 the forward over 255 and over 256 tokens agree exactly at position
# 254, so the prompt's cache is exact; the error is the decode step's.  Its
# GEMMs run on B = 2 rows where the full forward's run on 512, cuBLAS runs
# other kernels for them (skinny ``nvjet_tst_*x8_*`` ones in the decode
# profile), their bf16 outputs round differently here and there, and that
# compounds over the layers: 6.25e-2 seen over gemma-2b's 18 layers,
# 1.31e-1 over mamba2-780m's 48 (relative error 3.35e-2), where the SSD
# state also enters the decode step from the kernel's chunked sums.
# The MoE archs add a discontinuity: a token whose k-th and (k+1)-th router
# probabilities nearly tie can pick another expert when its input moves by
# a bf16 rounding, and over qwen3-moe-30b-a3b's 48 layers of top-8 of 128
# that happens somewhere.  1.875e-1 was seen there (relative error 4.2e-2),
# over gemma-2b's 1e-1, so qwen3 is held to mamba2-780m's 2e-1, the bound of
# the other 48-layer path; mixtral-8x7b at 8 layers to gemma-2b's.  The same
# bounds hold ``check_moe_impls``.
# whisper-tiny and llama-3.2-vision-11b run it with random frames or vision
# and open gates, held to gemma-2b's bound.
PTD_LIMIT = {"gemma-2b": 1e-1, "mamba2-780m": 2e-1, QWEN3: 2e-1,
             MIXTRAL: 1e-1, WHISPER: 1e-1, VLM: 1e-1}


OUR_KERNELS = ("flash_bf16", "flash_f32", "decode_split", "decode_combine",
               "ssd_intra_chunk_kernel", "bwd_delta", "bwd_dkdv", "bwd_dq",
               "bwd_dkdv_wg", "bwd_dkdv_sum", "bwd_dq_wg", "ssd_bwd_scores",
               "ssd_bwd_head", "ssd_bwd_sum", "ssd_bwd_reduce")


def _is_copy(name: str) -> bool:
    """A copy kernel: aten's copies say "copy" in their names.  A CUTLASS
    GEMM (``torch._grouped_mm``'s) names its copy atoms among its template
    arguments and is no copy."""
    low = name.lower()
    return "copy" in low and "gemm" not in low


def _profile(fn, reps: int) -> dict | None:
    """``fn`` run ``reps`` times under torch.profiler; per run: the host
    clock (``wall_ms``), the kernels' device time (``device_ms``), the
    hand-written kernels' share, kernel time by name, and the longest single
    copy kernel (``copy_ms``, its name ``copy``).  None where the profiler
    saw no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    by_name: dict[str, float] = {}
    copy = ("", 0.0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            dur = (e.time_range.end - e.time_range.start) / 1e3
            by_name[e.name] = by_name.get(e.name, 0.0) + dur / reps
            if _is_copy(e.name) and dur > copy[1]:
                copy = (e.name, dur)
    if not by_name:
        return None
    return dict(wall_ms=wall_ms, device_ms=sum(by_name.values()),
                ours_ms=sum(v for k, v in by_name.items()
                            if any(o in k for o in OUR_KERNELS)),
                by_name=by_name, copy=copy[0], copy_ms=copy[1])


def _profiled(fn, reps: int, what: str, r: dict | None = None) -> str:
    """``fn`` run ``reps`` times under torch.profiler (or ``r``, such a
    run's ``_profile``): the kernels' device time per run against the host
    clock, the hand-written kernels' share, the top kernels and the longest
    copy kernel."""
    if r is None:
        r = _profile(fn, reps)
    if r is None:
        return (f"{what}: device time not measured (the profiler saw no "
                "kernels)")
    wall_ms, device_ms = r["wall_ms"], r["device_ms"]
    top = sorted(r["by_name"].items(), key=lambda kv: -kv[1])[:4]
    return (f"{what} {wall_ms:.3f} ms on the host clock, kernels "
            f"{device_ms:.3f} ms on the device (busy {device_ms / wall_ms:.1%}"
            f", idle {1 - device_ms / wall_ms:.1%}), {len(r['by_name'])} "
            f"kernel names, hand-written kernels {r['ours_ms']:.3f} ms; top "
            "kernels: "
            + "; ".join(f"{k[:60]} {v:.3f} ms" for k, v in top)
            + f"; longest copy kernel {r['copy_ms']:.4f} ms "
            f"({r['copy'][:60] or 'none'})")


def decode_breakdown(model, params, prompts, steps: int = 8,
                     max_copy_ms: float | None = None) -> str:
    """Where a decode step's time goes: ``steps`` steps of an engine whose
    four slots are full.  With ``max_copy_ms``, fails if one copy kernel
    takes longer."""
    eng = ServingEngine(model, params, max_batch=MAX_BATCH, max_len=MAX_LEN)
    for p in prompts[:MAX_BATCH]:
        eng.submit(p, max_new_tokens=MAX_NEW)
    eng.step()                                   # admit all four, warm up
    eng.step()
    r = _profile(eng.step, steps)
    if max_copy_ms is not None and r is not None and \
            r["copy_ms"] > max_copy_ms:
        raise AssertionError(f"a decode step runs a copy kernel of "
                             f"{r['copy_ms']:.4f} ms ({r['copy'][:80]}), "
                             f"over {max_copy_ms:.4f} ms")
    return _profiled(eng.step, steps, "decode step", r)


def prefill_breakdown(model, params, prompt, reps: int = 2) -> str:
    """Where a prefill's time goes: ``model.apply_prefill`` of one prompt,
    as the engine's admit calls it (with the stub frontends' input), after a
    warm-up call."""
    batch = {"tokens": torch.as_tensor(prompt[None, :], device="cuda"),
             "lengths": torch.tensor([len(prompt)], dtype=torch.int32,
                                     device="cuda"),
             **stub_inputs(model.cfg, 1, len(prompt), 0)}
    model.apply_prefill(params, batch)
    return _profiled(lambda: model.apply_prefill(params, batch), reps,
                     f"prefill of {len(prompt)} tokens")


# a sleep kernel this long (about a millisecond) keeps the device busy while
# the host enqueues the timed call, so that the events time the device alone
SLEEP_CYCLES = 2_000_000


def time_ms(fn, flush: torch.Tensor | None, reps: int = 20,
            queued: bool = True) -> float:
    """Median over ``reps`` of CUDA-event time around one call, after a
    warm-up call; ``flush`` (a buffer larger than L2) is rewritten before
    each call where the real caller finds its inputs cold.  ``queued``: the
    call is enqueued behind a sleep kernel, so the time is the device's
    (its kernels and the gaps between them); otherwise the device also
    waits for the host to enqueue the call, as a lone call in an idle
    stream does."""
    fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        if queued:
            torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _times(kernel, plain, library, flush) -> dict:
    """Device times of the kernel, its plain version and the library call,
    and the kernel's and the library call's times with the host's enqueue
    (``*_call_ms``)."""
    return dict(
        ms=time_ms(kernel, flush), plain_ms=time_ms(plain, flush),
        library_ms=time_ms(library, flush),
        call_ms=time_ms(kernel, flush, queued=False),
        library_call_ms=time_ms(library, flush, queued=False))


def _bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS
           ) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _sdpa(q, k, v, mask):
    """One library call for the same function (GQA through enable_gqa)."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True)


def time_flash(b, t, win, flush, heads=(HQ, HKV, HD)) -> dict:
    hq, hkv, hd = heads
    lens = [t, t * 3 // 4, t // 2, t // 4][:b]
    args, kw = flash_case(b, t, t, hq, hkv, hd, win, True, torch.bfloat16,
                          lens, 400)
    q, k, v = args
    pos = torch.arange(t, device="cuda")
    mask = (pos[None, :] <= pos[:, None])[None] & \
        (pos[None, None, :] < kw["lengths"][:, None, None].long())
    if win is not None:
        mask &= (pos[None, :] > pos[:, None] - win)[None]
    pairs = float(mask.sum())
    flops = 4.0 * hq * hd * pairs
    nbytes = 2.0 * (2 * q.numel() + k.numel() + v.numel()) + 4 * b
    bound, by = _bound(flops, nbytes)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in args)
    m4 = mask[:, None]
    return dict(
        **_times(lambda: fa.flash_attention(*args, **kw),
                 lambda: ref.attention_naive(*args, **kw),
                 lambda: _sdpa(qt, kt, vt, m4), flush),
        bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes)


def time_decode(lens, win, flush, heads=(HQ, HKV, HD)) -> dict:
    hq, hkv, hd = heads
    args, lt = decode_case(MAX_BATCH, MAX_LEN, hq, hkv, hd, torch.bfloat16,
                           lens, 500)
    q, kc, vc = args
    w = 2 ** 30 if win is None else win
    valid = [max(0, min(n, MAX_LEN) - max(0, n - w)) for n in lens]
    per_pos = 2 * hkv * hd * 2                         # k and v, bf16
    nbytes = float(sum(valid) * per_pos + 2 * 2 * q.numel() + 4 * len(lens))
    flops = 4.0 * hq * hd * sum(valid)
    bound, by = _bound(flops, nbytes)
    pos = torch.arange(MAX_LEN, device="cuda")
    mask = (pos[None] < lt[:, None].long()) & (pos[None] >= lt[:, None] - w)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in args)
    m4 = mask[:, None, None]
    return dict(
        **_times(lambda: da.decode_attention(*args, lt, window=win),
                 lambda: ref.decode_attention_naive(*args, lt, window=win),
                 lambda: _sdpa(qt, kt, vt, m4), flush),
        bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes)


def time_cross_flash(shape, flush) -> dict:
    """Cross-attention prefill at ``shape`` (b, tq, tk, hq, hkv, d): every
    query row against every key, no mask.  ``host_lengths_ms``: the same
    call given its lengths as a host list, copied to the card each call (a
    stream synchronisation), as the wrapper made them for ``lengths=None``
    until it passed the kernel a null pointer instead."""
    b, tq, tk, hq, hkv, d = shape
    args, kw = cross_case(*shape, torch.bfloat16, 1400)
    q, k, v = args
    flops = 4.0 * hq * d * b * tq * tk
    nbytes = 2.0 * (2 * q.numel() + k.numel() + v.numel())
    bound, by = _bound(flops, nbytes)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in args)
    host = {**kw, "lengths": [tk] * b}
    return dict(
        **_times(lambda: fa.flash_attention(*args, **kw),
                 lambda: ref.attention_naive(*args, **kw),
                 lambda: _sdpa(qt, kt, vt, None), flush),
        host_lengths_ms=time_ms(lambda: fa.flash_attention(*args, **host),
                                flush),
        bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes)


def time_cross_decode(shape, flush) -> dict:
    """Decode over a static cross cache at ``shape`` (b, s, hq, hkv, d),
    every length the whole cache."""
    b, s, hq, hkv, d = shape
    args, lt = decode_case(b, s, hq, hkv, d, torch.bfloat16, [s] * b, 1450)
    q, kc, vc = args
    nbytes = 2.0 * (2 * q.numel() + kc.numel() + vc.numel()) + 4 * b
    flops = 4.0 * hq * d * b * s
    bound, by = _bound(flops, nbytes)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in args)
    return dict(
        **_times(lambda: da.decode_attention(*args, lt),
                 lambda: ref.decode_attention_naive(*args, lt),
                 lambda: _sdpa(qt, kt, vt, None), flush),
        bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes)


def _time_line(what: str, r: dict, smi: str) -> str:
    """An attention timing: kernel, plain version and SDPA device ms, their
    ratio, the bound, and the times with the host's enqueue."""
    return (f"time {what}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, "
            f"kernel/sdpa {r['ms'] / r['library_ms']:.2f}, bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']}); with the host's "
            f"enqueue: kernel {r['call_ms']:.4f} ms, sdpa "
            f"{r['library_call_ms']:.4f} ms [{smi}]")


def time_ssd(shape) -> dict:
    """The SSD pass at a serving shape.  Its least work: scores C.B^T once
    per chunk (2 c^2 n), y_diag over the causal pairs only
    (2 nh hd c(c+1)/2) and the states (2 nh c n hd).  The kernel runs these
    fp32 products on the TF32 tensor cores as three TF32 products each
    (3xTF32, which keeps fp32 accuracy), so the operations' bound is 3x the
    FLOPs at the TF32 peak; bytes are each fp32 input read once and each
    output written once."""
    b, t, nh, hd, n, chunk = shape
    ops_ = ssd_scan.chunk_operands(*ssd_case(b, t, nh, hd, n, 800)[:5],
                                   chunk)
    _, nc, c, _ = ops_[0].shape
    pairs = c * (c + 1) / 2
    flops = float(b * nc * (2 * c * c * n + 2 * nh * hd * pairs
                            + 2 * nh * c * n * hd))
    out = b * nc * (c * nh * hd + nh * n * hd)
    nbytes = 4.0 * (sum(o.numel() for o in ops_) + out)
    bound, by = _bound(3 * flops, nbytes, PEAK_TF32_FLOPS)
    return dict(
        ms=time_ms(lambda: ssd_scan.ssd_intra_chunk(*ops_, nh=nh, hd=hd),
                   None),
        plain_ms=time_ms(lambda: ref.ssd_intra_chunk(*ops_, nh=nh, hd=hd),
                         None),
        library_ms=None, bound_ms=bound, bound_by=by, flops=flops,
        bytes=nbytes)


def time_ssd_bwd(shape) -> dict:
    """The SSD backward at a training shape.  Its least work, per chunk:
    the scores C.B^T again (2 c^2 n over the causal pairs' half: 2 pairs
    n), dW = dy.x^T and dxdt's W^T.dy over the causal pairs (2 nh hd pairs
    each), dC = dS.B and dB's dS^T.C (2 pairs n each), and the state
    terms B.dstates and x.dstates^T (2 c n nh hd each); as for the
    forward, fp32 products at fp32 accuracy bound the operations at 3x the
    FLOPs at the TF32 peak (3xTF32).  Bytes: xdt, dacs, B, C, dy and
    dstates read once, dxdt, ddacs, dB and dC written once, fp32."""
    b, t, nh, hd, n, chunk = shape
    ops_ = ssd_scan.chunk_operands(*ssd_case(b, t, nh, hd, n, 810)[:5],
                                   chunk)
    dy, dstates = _bwd_case(ops_, nh, hd, 811)
    _, nc, c, _ = ops_[0].shape
    pairs = c * (c + 1) / 2
    flops = float(b * nc * (2 * pairs * (2 * nh * hd + 3 * n)
                            + 4 * c * n * nh * hd))
    nbytes = 4.0 * (2 * sum(o.numel() for o in ops_) + dy.numel()
                    + dstates.numel())
    bound, by = _bound(3 * flops, nbytes, PEAK_TF32_FLOPS)
    return dict(
        ms=time_ms(lambda: ssd_scan.ssd_intra_chunk_bwd(
            *ops_, dy, dstates, nh=nh, hd=hd), None),
        plain_ms=time_ms(lambda: ref.ssd_intra_chunk_bwd(
            *ops_, dy, dstates, nh=nh, hd=hd), None),
        library_ms=None, bound_ms=bound, bound_by=by, flops=flops,
        bytes=nbytes)


def time_ssd_decode(shape) -> dict:
    """The SSD decode step at a serving shape, x, B and C in bf16.  Its
    least work is bytes: the fp32 state read once and written once, x, B,
    C, dt, A and D read, y written; its operations (two products, a sum and
    the readout's multiply-add per state element, fp32 on the CUDA cores)
    are under 4% of that.  The plain version is the step the mixer ran
    before the kernel: ``ref.ssd_decode_step`` and the new state's copy
    into the cache."""
    b, nh, hd, n = shape
    h, x, dt, A, B, C, D = ssd_decode_case(shape, torch.bfloat16, 1950)
    state = h.numel()
    nbytes = float(2 * 4 * state + 2 * (2 * x.numel() + 2 * b * n)
                   + 4 * (dt.numel() + 2 * nh))
    bound, by = _bound(5.0 * state, nbytes, PEAK_FP32_FLOPS)

    def plain():
        _, h_new = ref.ssd_decode_step(h, x, dt, A, B, C, D)
        h.copy_(h_new)
    return dict(
        ms=time_ms(lambda: ssd_decode.ssd_decode_step_(h, x, dt, A, B, C, D),
                   None),
        plain_ms=time_ms(plain, None), library_ms=None, bound_ms=bound,
        bound_by=by, bytes=nbytes)


def ssd_decode_line(shape, r: dict, smi: str) -> str:
    return (f"time ssd decode {shape}: kernel {r['ms']:.4f} ms "
            f"({100 * r['bound_ms'] / r['ms']:.1f}% of its bound), plain "
            f"{r['plain_ms']:.4f} ms, library none, bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']}: "
            f"{r['bytes'] / 1e9:.4f} GB) [{smi}]")


def mamba_prefill_case(shape, seed, cached):
    """zxbcdt (1, t, 2di + 2n + nh) and one mixer's weights in bf16, as the
    engine serves them, drawn like the chip test's; with ``cached`` a conv
    context and an h0."""
    t, nh, hd, n, _, bias = shape
    di = nh * hd
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bf = torch.bfloat16
    zxbcdt = _randn((1, t, 2 * di + 2 * n + nh), bf, gen)
    p = {"conv": (_randn((4, di + 2 * n), torch.float32, gen) * 0.5).to(bf),
         "dt_bias": (_randn((nh,), torch.float32, gen) * 0.5).to(bf),
         "A_log": torch.log(torch.linspace(1.0, 16.0, nh,
                                           device="cuda")).to(bf),
         "D": _randn((nh,), bf, gen),
         "norm": (_randn((di,), torch.float32, gen) * 0.1).to(bf)}
    if bias:
        p["conv_b"] = (_randn((di + 2 * n,), torch.float32, gen) * 0.1
                       ).to(bf)
    conv = h0 = None
    if cached:
        conv = _randn((1, 3, di + 2 * n), bf, gen)
        h0 = _randn((1, nh, hd, n), torch.float32, gen) * 0.1
    return zxbcdt, p, conv, h0


def _mamba_mixer(shape, zxbcdt, p, conv, h0, passes):
    _, nh, hd, n, chunk, _ = shape
    return mamba_prefill.mixer(zxbcdt, p, hd=hd, n=n, chunk=chunk,
                               eps=1e-5, conv_state=conv, h0=h0,
                               passes=passes)


def check_mamba_prefill() -> float:
    """``mamba_prefill.mixer`` over the five passes against the same
    composition over their plain versions, the intra-chunk kernel on both
    sides, at every ``MAMBA_PREFILL`` shape from zeros and from a cache:
    the output at ``MAMBA_PREFILL_RTOL``, the final state at 1e-5, the conv
    context exact, five launches a call; returns the output's largest
    error."""
    before, worst = mamba_prefill.launches, 0.0
    plain = mamba_prefill.PLAIN._replace(intra=ssd_scan.ssd_intra_chunk_fwd)
    for i, shape in enumerate(MAMBA_PREFILL):
        for cached in (False, True):
            case = mamba_prefill_case(shape, 2000 + i, cached)
            y, h, ctx = _mamba_mixer(shape, *case, mamba_prefill.KERNELS)
            wy, wh, wctx = _mamba_mixer(shape, *case, plain)
            err = _check(f"mamba prefill {shape} y", y, wy, 1e-5,
                         MAMBA_PREFILL_RTOL["y"])
            h_err = _check(f"mamba prefill {shape} state", h, wh, 1e-6,
                           MAMBA_PREFILL_RTOL["state"])
            if not torch.equal(ctx, wctx):
                raise AssertionError(f"mamba prefill {shape}: conv context")
            log(f"  mamba prefill {shape} {'cached' if cached else 'fresh'}"
                f": y max|err| {err:.3e}, state max|err| {h_err:.3e}")
            worst = max(worst, err)
    ran = mamba_prefill.launches - before
    if ran != 5 * 2 * len(MAMBA_PREFILL):
        raise AssertionError(f"mamba_prefill launched {ran} times, not "
                             f"{10 * len(MAMBA_PREFILL)}")
    return worst


@contextlib.contextmanager
def plain_mixer():
    """Every Mamba layer's prefill on the eager path (the code the passes
    replaced), for the comparison runs only."""
    real = L.mamba_prefill_impl
    L.mamba_prefill_impl = lambda p, x: "plain"
    try:
        yield
    finally:
        L.mamba_prefill_impl = real


def time_mamba_prefill(shape) -> dict:
    """Each prefill pass's device time at ``shape`` beside its bound, the
    intra-chunk kernel's, the whole of ``ops.mamba_prefill`` (the six
    launches), and the eager chain it replaced (``mamba_block`` on the
    plain path, less its two projections timed alone), by CUDA events
    behind a sleep kernel and with the host's enqueue.  Bounds: bytes, each
    input read and each output written once, at 3.35 TB/s; the output
    pass's C·h_in (2 t nh hd n FLOP) at the fp32 peak of the CUDA cores,
    where that is larger; the intra-chunk kernel's as ``time_ssd``'s.
    Returns {name: dict(ms, bound_ms, bound_by, bytes)} and the chains'
    times."""
    t, nh, hd, n, chunk, _ = shape
    di, cc = nh * hd, nh * hd + 2 * n
    zxbcdt, p, _, _ = mamba_prefill_case(shape, 2100, False)
    dtr, xbc = zxbcdt[..., 2 * di + 2 * n:], zxbcdt[..., di:2 * di + 2 * n]
    kp = mamba_prefill
    dt, dacs = kp.ssd_dt(dtr, p["dt_bias"], p["A_log"], chunk)
    nc, c = dacs.shape[1:3]
    tp = nc * c
    out, _, xdt, B, C = kp.conv(xbc, p["conv"], p.get("conv_b"), None, dt,
                                hd=hd)
    C = C.reshape(1, nc, c, n)
    ops_ = (xdt.reshape(1, nc, c, di), dacs, B.reshape(1, nc, c, n), C)
    y_diag, states = ssd_scan.ssd_intra_chunk_fwd(*ops_, nh=nh, hd=hd)
    zeros = torch.zeros_like(states)     # a fixed point of the in-place pass
    x = out[..., :di].unflatten(-1, (nh, hd))
    y = kp.output(y_diag, states, dacs, C, x, p["D"])
    y = y.reshape(1, t, di)
    z = zxbcdt[..., :di]
    st = nc * nh * n * hd
    pairs = sum((min(c, t - lo) * (min(c, t - lo) + 1)) / 2
                for lo in range(0, t, c))
    intra_flops = float(2 * n * pairs + 2 * nh * hd * pairs
                        + 2 * nh * t * n * hd)
    parts = {
        "ssd_dt": (lambda: kp.ssd_dt(dtr, p["dt_bias"], p["A_log"], chunk),
                   2 * t * nh + 8 * tp * nh, 0.0),
        "mamba_conv": (lambda: kp.conv(xbc, p["conv"], p.get("conv_b"),
                                       None, dt, hd=hd),
                       2 * 2 * t * cc + 2 * 4 * cc + 4 * tp * nh
                       + 4 * tp * (di + 2 * n) + 2 * 3 * cc, 0.0),
        "ssd_intra_chunk": (lambda: ssd_scan.ssd_intra_chunk_fwd(
            *ops_, nh=nh, hd=hd),
            4 * (2 * tp * di + tp * nh + 2 * tp * n + st), 3 * intra_flops),
        "ssd_states": (lambda: kp.chunk_states(zeros, dacs, None),
                       2 * 4 * st + 4 * nh * hd * n, 0.0),
        "ssd_output": (lambda: kp.output(y_diag, states, dacs, C, x,
                                         p["D"]),
                       4 * (tp * di + st + tp * n + tp * nh)
                       + 2 * 2 * t * di, 2.0 * t * nh * hd * n),
        "gated_rmsnorm": (lambda: kp.gated_norm(y, z, p["norm"], 1e-5),
                          3 * 2 * t * di, 0.0)}
    res = {}
    for name, (fn, nbytes, flops) in parts.items():
        peak = PEAK_TF32_FLOPS if name == "ssd_intra_chunk" else \
            PEAK_FP32_FLOPS
        bound, by = _bound(flops, float(nbytes), peak)
        res[name] = dict(ms=time_ms(fn, None), bound_ms=bound, bound_by=by,
                         bytes=float(nbytes), flops=flops)
    cfg = dataclasses.replace(
        get_config("granite-4.0-h-small"), d_model=di // 2,
        ssm=dataclasses.replace(get_config("granite-4.0-h-small").ssm,
                                d_state=n, head_dim=hd, chunk=chunk,
                                conv_bias=shape[5]))
    gen = torch.Generator(device="cuda").manual_seed(2101)
    d = cfg.d_model
    p["w_in"] = _randn((d, 2 * di + 2 * n + nh), torch.bfloat16, gen)
    p["w_out"] = _randn((di, d), torch.bfloat16, gen)
    xin = _randn((1, t, d), torch.bfloat16, gen)
    ycont = torch.zeros((1, t, di), dtype=torch.bfloat16, device="cuda")

    def fused():
        return ops.mamba_prefill(zxbcdt, p, hd=hd, n=n, chunk=chunk,
                                 eps=1e-5)

    def layer():
        return L.mamba_block(cfg, p, xin, mode="prefill")

    def projections():
        return xin @ p["w_in"], ycont @ p["w_out"]

    with torch.no_grad():
        proj = time_ms(projections, None)
        chains = dict(fused_ms=time_ms(fused, None),
                      fused_call_ms=time_ms(fused, None, queued=False),
                      layer_ms=time_ms(layer, None) - proj)
        with plain_mixer():
            chains.update(plain_ms=time_ms(layer, None) - proj,
                          plain_call_ms=time_ms(layer, None, queued=False)
                          - proj)
    return dict(parts=res, **chains)


def mamba_prefill_lines(shape, r: dict, smi: str) -> list[str]:
    lines = [f"time mamba prefill {shape} {name}: {q['ms']:.4f} ms "
             f"({100 * q['bound_ms'] / q['ms']:.1f}% of its bound "
             f"{q['bound_ms']:.5f} ms, {q['bound_by']}: "
             f"{q['bytes'] / 1e6:.2f} MB, {q['flops'] / 1e9:.3f} GFLOP) "
             f"[{smi}]" for name, q in r["parts"].items()]
    lines.append(
        f"time mamba prefill {shape} chain: the six launches "
        f"{r['fused_ms']:.4f} ms ({r['fused_call_ms']:.4f} with the host's "
        f"enqueue; "
        f"{r['layer_ms']:.4f} in mamba_block less its projections), the "
        f"eager chain they replaced {r['plain_ms']:.4f} ms "
        f"({r['plain_call_ms']:.4f} with the host's enqueue) [{smi}]")
    return lines


def calibrate_and_plan(smi: str) -> dict:
    """The paper's analyzer loop on the card, feeding the planner: the
    kernel sweep (``Profiler.profile_kernels`` on ``cuda:0``, keyed to the
    H100 node's GPU resource) launches each hand-written kernel exactly
    (warmup + repeats) x shapes times; the fitted ``LearnedCostModel``
    goes through a ``CalibrationStore`` and back unchanged; the calibrated
    provider prices gemma-2b's attention layers from the card's entry on
    both planner tiers.  Returns what the planned serving run needs."""
    shapes = {k: DEFAULT_KERNEL_SHAPES[k] + SWEEP_SERVING[k]
              for k in DEFAULT_KERNEL_SHAPES}
    node = gpu_node("h100")                    # the card as a node of one GPU
    cluster = Cluster((node,))
    gpu = processors_as_resources(node)[0]
    key = gpu.profile_key or gpu.name          # what the provider looks up
    prof = Profiler(warmup=2, repeats=5, trim=1)
    for mod in COUNTERS.values():
        mod.launches = 0
    t0 = time.perf_counter()
    samples = prof.profile_kernels(device="cuda:0", shapes=shapes, key=key)
    sweep_s = time.perf_counter() - t0
    launches = {kind: COUNTERS[k].launches for kind, k in SWEEP_KINDS.items()}
    for kind, count in launches.items():
        want = (prof.warmup + prof.repeats) * len(shapes[kind])
        if count != want:
            raise AssertionError(f"the {kind} sweep launched "
                                 f"{SWEEP_KINDS[kind]} {count} times, "
                                 f"expected {want}")
    log(f"calibration sweep on cuda:0 keyed {key!r}: {len(samples)} samples "
        f"in {sweep_s:.3f} s; kernel calls {launches} = (warmup "
        f"{prof.warmup} + repeats {prof.repeats}) x shapes per kind")

    fitted = LearnedCostModel.fit(samples)
    with tempfile.TemporaryDirectory() as tmp:
        store = CalibrationStore(tmp)
        version = store.save(cluster, fitted, note=f"chip_smoke [{smi}]")
        loaded = store.load(cluster, version)
    if loaded.to_json() != fitted.to_json():
        raise AssertionError("the calibration read back from the store "
                             "differs from the one saved")
    log(f"calibration store: saved and reloaded version {version} under "
        f"fingerprint {store.fingerprint(cluster)}, equal JSON")
    order = [(kind, shape) for kind in shapes for shape in shapes[kind]]
    for (kind, shape), s in zip(order, samples):
        if s.kind != kind:
            raise AssertionError(f"sample {s} out of the sweep's order")
        log(f"  sample {s.key} {kind:6s} {'x'.join(map(str, shape)):17s}: "
            f"{1e3 * s.latency_s:.4f} ms, {s.work / s.latency_s / 1e9:.4g} "
            f"GFLOP/s; fitted rate {loaded.rate(key, kind) / 1e9:.4g} "
            f"GFLOP/s [{smi}]")
    for kind, e in sorted(loaded.entries.items()):
        log(f"  fit {kind}: a {e.a:.4e} s/FLOP, b {e.b:.4e} s/byte, c "
            f"{e.c:.4e} s, mape {e.mape:.3f} over {e.n} samples")
    for kind, (shape,) in SWEEP_SERVING.items():
        fn, _, _ = kernel_call(kind, shape, device=torch.device("cuda", 0),
                               seed=prof.seed)
        lat = samples[order.index((kind, shape))].latency_s
        log(f"  {kind:6s} {'x'.join(map(str, shape))} fp32: sweep "
            f"{1e3 * lat:.4f} ms (one call as its caller sees it); queued "
            f"device time {time_ms(fn, None):.4f} ms; lone call "
            f"{time_ms(fn, None, queued=False):.4f} ms [{smi}]")

    provider = CalibratedCostProvider(loaded)
    dag = build_model(get_config("gemma-2b")).block_costs(
        ShapeConfig("serve", MAX_LEN, MAX_BATCH, "decode"))
    attn = [b for b in dag.blocks if b.kind == "attn"]
    if not attn or loaded.entry(key, "attn") is None:
        raise AssertionError("no attention blocks, or no attn entry")
    for r in (node_as_resource(node), gpu):
        if provider.effective_rate(r, "attn") != loaded.rate(key, "attn"):
            raise AssertionError(f"{r.name} is not priced at the card's rate")
        for b in attn:
            if provider.block_time(r, b) == ANALYTIC.compute_time(
                    b.flops, r, b.kind):
                raise AssertionError(f"{r.name} prices {b.name} from the "
                                     "datasheet, not the card's entry")
    per_layer = provider.block_time(gpu, attn[0])
    log(f"calibrated provider: {len(attn)} attention layers of {dag.name} "
        f"priced from ({key!r}, 'attn') on the node and GPU tiers, "
        f"{1e3 * per_layer:.4g} ms a layer (datasheet "
        f"{1e3 * ANALYTIC.compute_time(attn[0].flops, gpu):.4g} ms)")
    datasheet = HiDPPlanner().plan(dag, cluster).predicted_latency
    cache = PlanCache(HiDPPlanner(PlannerConfig(provider=provider)), cluster,
                      version=version)
    return dict(loaded=loaded, version=version, cache=cache, dag=dag,
                datasheet=datasheet)


def serve_planned(model, params, prompts, run, plan, smi: str) -> None:
    """The counted run again, now with submits resolved through the
    calibrated ``PlanCache`` and decode steps fed to a ``FeedbackLoop``: one
    frontier pass on the first submit and a hit for every other (plus one
    re-plan per drift event, if the loop reports one), every decode step
    after the first observed, and the same greedy tokens as the run
    without a cache (on one card the plan does not change the
    computation)."""
    cache = plan["cache"]
    n = len(run["rids"])
    fb = FeedbackLoop(plan["loaded"], calibration_version=plan["version"])
    planned = drive_main_path(model, params, prompts[:n], plan_cache=cache,
                              default_dag=plan["dag"], feedback=fb)
    check_engine(planned, model.cfg, n, ("flash_attention",
                                         "decode_attention"))
    eng = planned["eng"]
    if cache.hits != n - 1 or cache.misses != 1 + eng.replans:
        raise AssertionError(f"plan cache: {cache.misses} misses and "
                             f"{cache.hits} hits for {n} submits and "
                             f"{eng.replans} re-plans")
    if eng.replans != fb.replans:
        raise AssertionError(f"{eng.replans} re-plans for {fb.replans} "
                             "drift events")
    if fb.observations != len(eng.decode_seconds) - 1:
        raise AssertionError(f"the feedback loop observed {fb.observations} "
                             f"of {len(eng.decode_seconds)} decode steps")
    for a, b in zip(run["rids"], planned["rids"]):
        if run["done"][a].generated != planned["done"][b].generated:
            raise AssertionError(f"request {b} emitted other tokens with "
                                 "the plan cache than without")
    p = eng.plan
    tokens = n * MAX_NEW
    log(f"{model.cfg.name} planned run: {n} submits, plan cache "
        f"{cache.misses} miss(es) and {cache.hits} hits, {eng.replans} "
        f"re-plan(s) on drift, feedback observed {fb.observations} of "
        f"{len(eng.decode_seconds)} decode steps, greedy tokens equal to "
        f"the run without a cache; {tokens / planned['wall']:.1f} tok/s "
        f"(without: {tokens / run['wall']:.1f}); plan {p.mode}-mode, "
        f"local plan {plan_to_dict(p)['local_plans'][0]['mode']}-mode, "
        f"predicted {1e3 * p.predicted_latency:.4f} ms a decode step "
        f"(datasheet plan {1e3 * plan['datasheet']:.4f} ms), measured "
        f"median {1e3 * statistics.median(eng.decode_seconds):.4f} ms "
        f"[{smi}]")
    stats = cache.stats()
    log("plan cache stats: " + json.dumps(
        {k: stats[k] for k in ("hits", "misses", "invalidations", "entries",
                               "nbytes", "version", "hit_rate",
                               "fingerprint")}))
    log(f"launches in the planned run: {planned['launches']}")


def serve_churn(model, params, prompts, run, smi: str) -> dict:
    """The counted run again under fleet churn: a ``PlanCache`` over
    ``battery_cluster()`` keyed on the membership of a ``FleetController``
    replaying ``CHURN``, whose epochs re-enter EXPLORE through
    ``on_membership_change``; one ``TelemetryRecorder`` for all three.  The
    fleet advances between ``step()`` calls only, so no re-plan falls
    between a decode step's launch and its sync.  Checks: 2 re-plans, 2
    misses (the first submit and the new membership; the return is a hit),
    no tx2 in the plan made while it is away, the greedy tokens and the
    flash/decode launch counts of the run without churn, and the recorder's
    ``engine.replan`` counters and ``fleet.membership`` gauges."""
    n = len(run["rids"])
    rec = TelemetryRecorder("churn")
    cluster = battery_cluster()
    fleet = FleetController(cluster, ChurnTrace.scripted(CHURN),
                            telemetry=rec)
    cache = PlanCache(HiDPPlanner(), cluster, membership_source=fleet,
                      telemetry=rec)
    dag = model.block_costs(ShapeConfig("serve", MAX_LEN, MAX_BATCH,
                                        "decode"))
    eng = ServingEngine(model, params, max_batch=MAX_BATCH, max_len=MAX_LEN,
                        plan_cache=cache, default_dag=dag, telemetry=rec)
    fleet.on_epoch = eng.on_membership_change
    rids, submit_s = [], []
    for p in prompts[:n]:
        t0 = time.perf_counter()
        rids.append(eng.submit(p, max_new_tokens=MAX_NEW))
        submit_s.append(time.perf_counter() - t0)
    for mod in COUNTERS.values():
        mod.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps, epoch_s, away = 0, [], None
    at = dict(CHURN_AT)
    while eng.queue or eng.active():
        eng.step()                       # ends in a sync: nothing in flight
        steps += 1
        if steps in at:
            t1 = time.perf_counter()
            fleet.advance(at[steps])
            epoch_s.append(time.perf_counter() - t1)
            nodes = {a.node.name for a in eng.plan.global_plan.assignments}
            if at[steps] < CHURN[1][0]:
                away = nodes
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: mod.launches for k, mod in COUNTERS.items()}
    done = eng.completed

    if len(epoch_s) != len(CHURN_AT) or fleet.epoch != 2:
        raise AssertionError(f"the run ended after {steps} steps, before "
                             f"the fleet reached epoch 2 ({fleet.epoch})")
    if eng.replans != 2:
        raise AssertionError(f"{eng.replans} re-plans under churn, not 2")
    if cache.misses != 2 or cache.hits != n:
        raise AssertionError(f"plan cache: {cache.misses} misses and "
                             f"{cache.hits} hits, expected 2 and {n}")
    if away is None or "tx2" in away:
        raise AssertionError(f"the plan made while tx2 was away uses "
                             f"{sorted(away or ())}")
    for a, b in zip(run["rids"], rids):
        if run["done"][a].generated != done[b].generated:
            raise AssertionError(f"request {b} emitted other tokens under "
                                 "churn than without")
    if launches != run["launches"]:
        raise AssertionError(f"launches under churn {launches}, without "
                             f"{run['launches']}")
    replans = [(e.value, e.epoch, e.attrs["reason"]) for e in rec.events
               if e.name == "engine.replan"]
    members = [(e.value, e.epoch) for e in rec.events
               if e.name == "fleet.membership"]
    if replans != [(1.0, 1, "epoch"), (1.0, 2, "epoch")]:
        raise AssertionError(f"engine.replan counters {replans}")
    if members != [(4.0, 1), (5.0, 2)]:
        raise AssertionError(f"fleet.membership gauges {members}")
    resolved = [e.attrs["resolved"] for e in rec.events
                if e.name == "engine.submit"]
    if resolved != ["miss"] + ["hit"] * (n - 1):
        raise AssertionError(f"engine.submit resolutions {resolved}")
    tokens = n * MAX_NEW
    hit_ms = statistics.median(submit_s[1:]) * 1e3
    log(f"{model.cfg.name} churn run: {n} requests, tx2 leaves after "
        f"decode step {CHURN_AT[0][0]} and returns after {CHURN_AT[1][0]} "
        f"of {steps}; {eng.replans} re-plans, plan cache {cache.misses} "
        f"misses and {cache.hits} hits; plan while away on "
        f"{sorted(away)}, after the return on "
        f"{sorted(nodes)}; greedy tokens and launches {launches} equal to "
        f"the run without churn; {tokens / wall:.1f} tok/s (without: "
        f"{tokens / run['wall']:.1f}) [{smi}]")
    log(f"{model.cfg.name} churn run host times: submit on a miss "
        f"{submit_s[0] * 1e3:.3f} ms, median on a hit {hit_ms:.3f} ms; "
        f"epoch re-plan on a miss {epoch_s[0] * 1e3:.3f} ms, on a hit "
        f"{epoch_s[1] * 1e3:.3f} ms; recorder {len(rec.events)} events, "
        f"engine.replan {replans}, fleet.membership {members} [{smi}]")
    return dict(wall=wall, launches=launches, submit_s=submit_s,
                epoch_s=epoch_s, rec=rec)


# the paper's evaluation layer on the card's runs (after ``serve_churn``)
THROUGHPUT_STREAM = 16        # requests 0.2 s apart, fig7's spacing
LOAD_SEED, LOAD_ARRIVALS = 0, 2000
SWEEP_FACTORS = (0.5, 0.9, 1.0, 1.5, 3.0)


def _cli(module: str, *args) -> subprocess.CompletedProcess:
    """``python -m module args`` with the checkout's ``src`` on the path."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(Path(__file__).resolve().parent / "src")
    return subprocess.run([sys.executable, "-m", module, *map(str, args)],
                          env=env, capture_output=True, text=True,
                          timeout=120)


def telemetry_of_churn(rec, store: RunStore, smi: str) -> None:
    """(a) The churn run's recorder flushed into the port's ``RunStore``: a
    fresh store on the same root reads the same canonical lines, the report
    (in process and through its CLI) succeeds, and the run holds ``engine.*``
    spans."""
    n = rec.close(store=store, card=smi, model="gemma-2b")
    lines = store.canonical_lines(rec.run)
    if not lines or RunStore(store.root).canonical_lines(rec.run) != lines:
        raise AssertionError(f"run {rec.run}: {len(lines)} canonical lines, "
                             "read back otherwise by a fresh store")
    spans = store.events(rec.run, kind="span", name="engine.*")
    if not spans:
        raise AssertionError(f"run {rec.run} holds no engine.* span")
    text = report.generate(store, rec.run)
    cli = _cli("repro_torch.telemetry.report", store.root, rec.run)
    if cli.returncode != 0 or f"run {rec.run}" not in cli.stdout:
        raise AssertionError(f"the report CLI exited {cli.returncode}: "
                             f"{cli.stderr[-2000:]}")
    tree = trace.tree_lines(trace.span_trees(store.events(rec.run)))
    summary = report.run_summary(store, rec.run)
    log(f"telemetry: churn run {rec.run!r}, {n} events flushed into a "
        f"RunStore, {len(lines)} canonical lines read back equal by a fresh "
        f"store; {len(spans)} engine.* spans "
        f"({sorted({e.name for e in spans})}); {len(tree)} span-tree lines; "
        f"report {len(text.splitlines())} lines, CLI exit 0 [{smi}]")
    log("telemetry run summary: " + json.dumps(summary, sort_keys=True,
                                               default=str))


def regress_on_card(run, root: Path, smi: str) -> None:
    """(b) The counted run's launches (unit ``count``, gated) and decode
    step (unit ``us``, informational) as a snapshot: the regress CLI's
    self-diff exits 0, and a copy with the flash count doubled exits 1."""
    eng = run["eng"]
    metrics = {f"gemma-2b/launches/{k}": {"value": float(v), "unit": "count",
                                          "direction": "lower"}
               for k, v in run["launches"].items()}
    metrics["gemma-2b/decode_step"] = {
        "value": 1e6 * statistics.median(eng.decode_seconds), "unit": "us",
        "direction": "lower"}
    base = regress.write_snapshot(root / "base.json", metrics, ["chip_smoke"])
    doubled = {k: dict(v) for k, v in metrics.items()}
    doubled["gemma-2b/launches/flash_attention"]["value"] *= 2
    cur = regress.write_snapshot(root / "doubled.json", doubled,
                                 ["chip_smoke"])
    rcs = [_cli("repro_torch.telemetry.regress", base, other).returncode
           for other in (base, cur)]
    entries = regress.diff(regress.load_snapshot(base),
                           regress.load_snapshot(cur)).regressions
    if rcs != [0, 1] or [e.name for e in entries] != [
            "gemma-2b/launches/flash_attention"]:
        raise AssertionError(f"regress CLI exits {rcs} (self, doubled), "
                             f"regressions {[e.name for e in entries]}")
    log(f"regress: snapshot of {len(metrics)} metrics (launches "
        f"{dict(run['launches'])} gated, decode step "
        f"{metrics['gemma-2b/decode_step']['value']:.1f} us informational); "
        f"CLI self-diff exit {rcs[0]}, flash count doubled exit {rcs[1]} "
        f"[{smi}]")


def paper_comparison(plan, run, smi: str) -> None:
    """(c) The paper's §IV-A comparison through the port's simulator, in
    simulated seconds of the cost model (not card measurements): the four
    ``STRATEGIES`` on ``paper_cluster()`` for every ``EDGE_MODELS`` entry,
    HiDP lowest in latency and energy for each; then the four priced by the
    card-calibrated provider on one H100 for gemma-2b's decode step."""
    out = {}
    for name, build in EDGE_MODELS.items():
        dag, delta = build(), MODEL_DELTA[name]
        row = {}
        for s in STRATEGIES:
            one = simulate(paper_cluster(), s, [(0.0, dag, delta)],
                           planning_time=0.0)
            stream = simulate(paper_cluster(), s,
                              [(0.2 * i, dag, delta)
                               for i in range(THROUGHPUT_STREAM)],
                              planning_time=0.0)
            row[s] = (one.records[0].latency, one.energies()[name],
                      THROUGHPUT_STREAM / stream.makespan())
        for i, what in ((0, "latency"), (1, "energy")):
            best = min(row, key=lambda s: row[s][i])
            if best != "hidp":
                raise AssertionError(f"{name}: {best} has the lowest "
                                     f"simulated {what}, not hidp: {row}")
        h = row["hidp"]
        log(f"simulated (cost model, paper_cluster) {name}: hidp latency "
            f"{h[0]:.4f} s, energy {h[1]:.4f} J, throughput {h[2]:.4f} "
            "inferences/s; " + "; ".join(
                f"{s} {row[s][0]:.4f} s, {row[s][1]:.4f} J, "
                f"{row[s][2]:.4f}/s" for s in STRATEGIES if s != "hidp"))
        out[name] = row
    pairs = [(row["hidp"], row[s]) for row in out.values()
             for s in STRATEGIES if s != "hidp"]
    gain = [statistics.mean(1 - h[i] / b[i] for h, b in pairs)
            for i in (0, 1)] + [statistics.mean(h[2] / b[2] - 1
                                                for h, b in pairs)]
    log(f"simulated (cost model): hidp against the three baselines, mean "
        f"over {len(out)} models: latency {gain[0]:.1%} lower, energy "
        f"{gain[1]:.1%} lower, throughput ({THROUGHPUT_STREAM} requests "
        f"0.2 s apart) {gain[2]:.1%} higher (the paper reports 38%, 46% "
        "and 56%)")
    cluster = Cluster((gpu_node("h100"),))
    provider = CalibratedCostProvider(plan["loaded"])
    step = 1e3 * statistics.median(run["eng"].decode_seconds)
    for s in STRATEGIES:
        r = simulate(cluster, s, [(0.0, plan["dag"], 1.0)],
                     provider=provider, planning_time=0.0).records[0]
        log(f"simulated (cost model, one H100, card-calibrated provider) "
            f"gemma-2b decode step under {s}: {r.mode}-mode, planned "
            f"{1e3 * r.predicted_latency:.4f} ms and "
            f"{r.predicted_energy:.4g} J, executed on the datasheet model "
            f"{1e3 * r.latency:.4f} ms; the engine's measured median decode "
            f"step {step:.4f} ms [{smi}]")


def open_loop_load(plan, run, model, store: RunStore, smi: str) -> None:
    """(d) Open-loop load priced by the card: a seeded Poisson trace of
    gemma-2b decode steps and prefills through ``OpenLoopHarness`` with a
    ``PlanServiceModel`` over the calibrated plan cache, recorded into the
    ``RunStore``; then a saturation sweep of whole requests priced at the
    counted run's measured seconds a request (``FixedServiceModel``, one
    lane per engine slot)."""
    prefill = model.block_costs(ShapeConfig("serve", 512, 1, "prefill"))
    specs = {"decode": TenantSpec("decode", dag=plan["dag"], delta=1.0),
             "prefill": TenantSpec("prefill", dag=prefill, delta=1.0)}
    svc = PlanServiceModel(plan["cache"], specs)
    times = {k: svc.service_time(k) for k in specs}
    primed = svc.resolutions
    mix = {"decode": 4.0, "prefill": 1.0}
    cap = mix_capacity(times, mix)
    rates = {k: 0.8 * cap * w / sum(mix.values()) for k, w in mix.items()}
    horizon = LOAD_ARRIVALS / sum(rates.values())
    # each SLO: the tenant's own service and four of the longest ahead
    longest = max(times.values())
    specs = {k: dataclasses.replace(v, slo=times[k] + 4 * longest)
             for k, v in specs.items()}
    tr = ArrivalTrace.poisson(rates, horizon, seed=LOAD_SEED)
    rec = TelemetryRecorder(store.new_run("load"), store=store)
    h = OpenLoopHarness(tr, specs, svc, LoadConfig(queue_capacity=64),
                        telemetry=rec)
    rep = h.run()
    rec.close(card=smi)
    # every arrival ends completed, rejected or shed, exactly once
    if not (rep.conservation_ok() and rep.completed + rep.rejected
            + rep.shed == rep.arrived == len(tr)):
        raise AssertionError(f"open-loop run: {rep}")
    resolved = svc.resolutions - primed
    if resolved != len(specs):
        raise AssertionError(f"{resolved} plan resolutions for "
                             f"{len(specs)} tenants with no churn")
    paths = trace.request_critical_paths(store, rec.run)
    worst = max((abs(p.residual) for p in paths), default=0.0)
    if len(paths) != rep.completed or worst > 1e-9:
        raise AssertionError(f"{len(paths)} load.request critical paths "
                             f"for {rep.completed} completions, largest "
                             f"residual {worst:.3e} s")
    steps_s = 1.0 / statistics.median(run["eng"].decode_seconds)
    log(f"open-loop load (plan-priced, calibrated cache): {len(tr)} "
        f"arrivals over {horizon:.3f} simulated s at 0.8 of capacity "
        f"{cap:.2f}/s (service decode {1e3 * times['decode']:.4f} ms, "
        f"prefill {1e3 * times['prefill']:.4f} ms as planned); completed "
        f"{rep.completed}, rejected {rep.rejected}, shed {rep.shed}, p50 "
        f"{1e3 * rep.percentile(50):.4f} ms, p99 "
        f"{1e3 * rep.percentile(99):.4f} ms, utilization "
        f"{rep.utilization():.4f}; {resolved} plan resolutions; "
        f"{len(paths)} critical paths, largest residual {worst:.3e} s; "
        f"planned decode steps {1 / times['decode']:.2f}/s beside the "
        f"engine's measured {steps_s:.2f}/s [{smi}]")

    n = len(run["rids"])
    per_request = run["wall"] * MAX_BATCH / n      # one lane's seconds
    fixed = FixedServiceModel({"gemma-2b": per_request})
    measured = n / run["wall"]
    cap = mix_capacity({"gemma-2b": per_request}, {"gemma-2b": 1.0},
                       servers=MAX_BATCH)
    base = ArrivalTrace.poisson({"gemma-2b": measured}, 200 / measured,
                                seed=LOAD_SEED + 1)
    rec = TelemetryRecorder(store.new_run("sweep"), store=store)
    points = saturation_sweep(
        base, [TenantSpec("gemma-2b", slo=4 * per_request)], fixed,
        SWEEP_FACTORS, LoadConfig(servers=MAX_BATCH, queue_capacity=16),
        telemetry=rec)
    rec.close(card=smi)
    for p in points:
        r = p.report
        if not (r.conservation_ok() and r.utilization() <= 1 + 1e-9):
            raise AssertionError(f"sweep at {p.factor}x: {r}")
        log(f"  saturation {p.factor:.2f}x: offered {p.offered:.4f}/s, "
            f"throughput {p.throughput:.4f}/s, goodput {p.goodput:.4f}/s, "
            f"p50 {p.p50:.3f} s, p99 {p.p99:.3f} s, loss "
            f"{p.loss_rate:.4f}")
    log(f"saturation sweep priced by the card: {n} requests in "
        f"{run['wall']:.3f} s on {MAX_BATCH} engine slots = "
        f"{per_request:.4f} s a request a slot; mix_capacity "
        f"{cap:.4f} requests/s beside the engine's measured {measured:.4f} "
        f"requests/s; plateau {points[-1].throughput:.4f}/s at "
        f"{SWEEP_FACTORS[-1]}x [{smi}]")


def evaluation_phase(model, run, churn, plan, smi: str) -> None:
    """The paper's evaluation layer over the card's runs: (a) telemetry of
    the churn run, (b) regress on the counted run, (c) the strategy
    comparison on the simulator, (d) open-loop load priced by the card."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        store = RunStore(Path(tmp) / "telemetry")
        telemetry_of_churn(churn["rec"], store, smi)
        regress_on_card(run, Path(tmp), smi)
        paper_comparison(plan, run, smi)
        open_loop_load(plan, run, model, store, smi)
    log(f"evaluation phase: {time.perf_counter() - t0:.3f} s host [{smi}]")


def plan_elastic(smi: str) -> None:
    """GPU-tier planning: an ``ElasticController`` on the H100 over
    ``GPU_MULTI_NODE`` (two HGX hosts) for gemma-2b's ``train_4k`` cell,
    its world driven by a ``FleetController`` over ``paper_cluster(2)``
    replaying ``CHURN`` (2 -> 1 -> 2 hosts, 2 re-plans), then ``plan_gpu``
    on every applicable cell of ``ARCH_IDS`` x the model ``SHAPES`` x
    (``GPU_NODE``, ``GPU_MULTI_NODE``), one line each.  Planning runs on
    the host: its seconds are host time on this machine, not a measure of
    the card."""
    rec = TelemetryRecorder("elastic")
    ctl = ElasticController(build_model(get_config("gemma-2b")),
                            CELLS["train_4k"], GPU_MULTI_NODE, chip=H100,
                            telemetry=rec)
    worlds = [ctl.initial_plan().mesh.n_pods]
    fleet = FleetController(paper_cluster(2), ChurnTrace.scripted(CHURN),
                            on_epoch=ctl.on_epoch, telemetry=rec)
    for _, now in CHURN_AT:
        fleet.advance(now)
        worlds.append(ctl.current_plan.mesh.n_pods)
    gauges = [e.value for e in rec.events if e.name == "elastic.world"]
    if worlds != [2, 1, 2] or ctl.replans != 2 or gauges != [1.0, 2.0]:
        raise AssertionError(f"elastic world {worlds} (gauges {gauges}) "
                             f"after {ctl.replans} re-plans, expected "
                             "[2, 1, 2] after 2")
    log(f"elastic gemma-2b train_4k on {GPU_MULTI_NODE.shape} H100s: world "
        f"{' -> '.join(map(str, worlds))} hosts, {ctl.replans} re-plans, "
        f"plan {ctl.current_plan.local_layout} "
        f"({ctl.current_plan.global_mode}-mode across hosts)")
    cells = 0
    for aid in ARCH_IDS:
        model = build_model(get_config(aid))
        for sname, shape in CELLS.items():
            if not shape_applicable(model.cfg, shape)[0]:
                continue
            for mesh in (GPU_NODE, GPU_MULTI_NODE):
                p = plan_gpu(model, shape, mesh)
                d = p.predicted
                if not p.local_layout or not d["total"] >= 0 or (
                        d["fits"] and d["resident"] > 0.92 * H100.hbm_per_chip):
                    raise AssertionError(f"plan_gpu {aid} {sname} "
                                         f"{mesh.shape}: {p}")
                cells += 1
                log(f"  plan_gpu {aid:21s} {sname:11s} "
                    f"{'x'.join(map(str, mesh.shape)):6s} "
                    f"{p.global_mode}/{p.local_layout} {p.moe_impl}: "
                    f"compute {d['compute'] * 1e3:.4g} ms, memory "
                    f"{d['memory'] * 1e3:.4g} ms, collective "
                    f"{d['collective'] * 1e3:.4g} ms, resident "
                    f"{d['resident'] / 2**30:.2f} GiB, fits {d['fits']}, "
                    f"planning {p.planning_seconds * 1e3:.3f} ms host "
                    f"[{smi}]")
    log(f"plan_gpu: {cells} cells planned")


def serve(aid: str, n_requests: int, kernels, smi: str):
    """Seeded full-width bf16 weights for ``aid``, a warm-up engine run,
    then the counted run over ``n_requests`` prompts (numpy seed 0, 32..512
    tokens); returns (cfg, model, params, prompts, run)."""
    cfg = get_config(aid)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    log(f"{aid} full width: {cfg.n_layers} layers, {n_params / 1e9:.3f} B "
        f"parameters, init {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(32, 513, size=N_REQUESTS)]
    drive_main_path(model, params, prompts[:2])          # warm-up run
    torch.cuda.reset_peak_memory_stats()
    run = drive_main_path(model, params, prompts[:n_requests])
    tokens = check_engine(run, cfg, n_requests, kernels)
    eng = run["eng"]
    log(f"{aid} engine: {n_requests}/{n_requests} requests, prompt lengths "
        f"{[len(p) for p in prompts[:n_requests]]}, {tokens} tokens in "
        f"{run['wall']:.3f} s = {tokens / run['wall']:.1f} tok/s; "
        f"median prefill {1e3 * statistics.median(eng.prefill_seconds):.3f} "
        f"ms, median decode step "
        f"{1e3 * statistics.median(eng.decode_seconds):.3f} ms over "
        f"{len(eng.decode_seconds)} steps; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{smi}]")
    log(f"{aid} launches per engine run: {run['launches']}")
    return cfg, model, params, prompts, run


def _first_parted(dense, grouped, n_layers: int, start: int
                  ) -> torch.Tensor:
    """Per token: the first of ``n_layers`` recorded layers from ``start``
    at which two runs route it to other experts (-1: never)."""
    first = None
    for layer in range(n_layers):
        a, b = dense[start + layer][0], grouped[start + layer][0]
        parts = (a.sort(-1).values != b.sort(-1).values).any(-1)
        if first is None:
            first = torch.full(parts.shape, -1, dtype=torch.long,
                               device=parts.device)
        first[parts & (first < 0)] = layer
    return first


@contextlib.contextmanager
def grouped_beside_dense(tol: float):
    """While the block runs, every ``layers.moe_dense`` call also runs the
    grouped step (``moe_ep.moe_ep_a2a``) on the same input and holds it to
    the dense output at ``tol``; yields the largest error of each call."""
    errs = []
    real = L.moe_dense

    def spy(cfg, p, x):
        want = real(cfg, p, x)
        errs.append(_check(f"{cfg.name} grouped vs dense on the model's "
                           f"activations, MoE call {len(errs)}",
                           moe_ep.moe_ep_a2a(cfg, p, x), want, tol))
        return want

    L.moe_dense = spy
    try:
        yield errs
    finally:
        L.moe_dense = real


def check_moe_impls(model, params, cfg, prompt, limit: float) -> None:
    """One prompt (a prefill, then one decode step of the same next token
    from each run's own cache) through ``moe_impl="dense"`` (the oracle)
    and ``"ep_a2a"`` (the grouped step) on the same weights.

    In the dense run every MoE layer also runs the grouped step on the very
    same activations, held to the bf16 TOL (``grouped_beside_dense``).  The
    two runs left to themselves part: their MoE outputs differ by bf16
    roundings, a token whose k-th and (k+1)-th router probabilities nearly
    tie then picks another expert in one of them, and from there its hidden
    state (and through attention the later tokens') differs by more than
    rounding.  So the free runs' logits are held to ``limit`` element-wise
    only while no token has been routed apart; otherwise they are logged,
    with how many tokens parted and where."""
    p, nl = len(prompt), cfg.n_layers
    toks = torch.as_tensor(prompt[None, :], device="cuda")
    lens = torch.tensor([p], dtype=torch.int32, device="cuda")
    nxt = None

    def run(impl):
        """The prefill's last logits and the decode step's."""
        nonlocal nxt
        logits, pcache = model.apply_prefill(
            params, {"tokens": toks, "lengths": lens}, moe_impl=impl)
        if nxt is None:
            nxt = torch.argmax(logits[:, -1], -1, keepdim=True).int()
        cache = model.init_cache(1, p + 1)
        for k in ("k", "v"):
            cache[k][:, :, :p] = pcache[k]
        dec, _ = model.apply_decode(
            params, cache, {"tokens": nxt, "lengths": lens + 1},
            moe_impl=impl)
        return logits[:, -1], dec[:, 0]

    out, routes = {}, {}
    for impl in ("dense", "ep_a2a"):
        with recorded_routes() as routes[impl]:
            out[impl] = run(impl)
    with grouped_beside_dense(TOL[torch.bfloat16]) as forced:
        run("dense")
    if len(forced) != 2 * nl:
        raise AssertionError(f"{len(forced)} MoE calls, expected {2 * nl}")
    log(f"{cfg.name} grouped vs dense on the model's activations, every "
        f"layer of a {p}-token prefill and a decode step: max|err| "
        f"{max(forced[:nl]):.3e} and {max(forced[nl:]):.3e} within TOL "
        f"{TOL[torch.bfloat16]}")
    apart = False
    for i, what in enumerate(("prefill", "decode")):
        got, want = out["ep_a2a"][i], out["dense"][i]
        first = _first_parted(routes["dense"], routes["ep_a2a"], nl, i * nl)
        apart = apart or bool((first >= 0).any())
        err = (got - want).abs().max().item()
        rel = ((got - want).norm() / want.norm()).item()
        log(f"{cfg.name} moe_impl ep_a2a vs dense left to themselves, "
            f"{what}: {int((first >= 0).sum())} of {first.numel()} tokens "
            f"routed apart (first at layers "
            f"{sorted(set(first[first >= 0].tolist()))[:6]}...); logits "
            f"max|err| {err:.3e}, relative error {rel:.3e}"
            + ("" if apart else f", within {limit}"))
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{cfg.name} ep_a2a {what}: logits not "
                                 "finite")
        if not apart:
            _check(f"{cfg.name} ep_a2a vs dense {what}", got, want, limit)


@contextlib.contextmanager
def recorded_routes():
    """Per ``layers.moe_router`` call made while the block runs, in call
    order (one per MoE layer of a forward): the expert indices (T, k) and
    each token's gap between its k-th and (k+1)-th router probability
    (T,)."""
    routes = []
    real = L.moe_router

    def spy(spec, router_w, x2d):
        vals, idx = real(spec, router_w, x2d)
        with torch.no_grad():
            top = torch.softmax(x2d.float() @ router_w.float(), -1).topk(
                spec.top_k + 1, -1).values
        routes.append((idx, top[:, -2] - top[:, -1]))
        return vals, idx

    L.moe_router = spy
    try:
        yield routes
    finally:
        L.moe_router = real


def decode_step_bound(cfg, routes, dense: bool, lens) -> dict:
    """Least time of one decode step of len(lens) tokens over the engine's
    cache.  Bytes: every bf16 weight the step reads once (attention, router,
    the experts: all of them for the dense oracle, the ones this step's
    routing touched for the grouped step, the embedding rows and the head),
    the fp32 norms, the valid k/v entries and the new ones written, the
    fp32 logits.  Operations: the products on those tokens (every expert
    for each token in the dense oracle, top-k in the grouped step) at the
    bf16 peak."""
    m = cfg.moe
    d, hq, hkv, hd, nl = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                          cfg.n_layers)
    b = len(lens)
    attn_w = d * hq * hd + 2 * d * hkv * hd + hq * hd * d
    expert_w = 3 * d * m.d_ff_expert
    touched = [m.num_experts if dense else int(r.unique().numel())
               for r, _ in routes]
    if len(touched) != nl:
        raise AssertionError(f"{len(touched)} routed layers of {nl}")
    valid = sum(min(n, MAX_LEN) for n in lens)
    kv = 2 * hkv * hd * 2                        # k and v of a position
    nbytes = (2.0 * (nl * (attn_w + d * m.num_experts)
                     + expert_w * sum(touched) + b * d + d * cfg.vocab)
              + nl * (2 * d * 4 + (valid + b) * kv) + d * 4
              + b * cfg.vocab * 4)
    per_token = m.num_experts if dense else m.top_k
    flops = (nl * (b * (2.0 * attn_w + 2.0 * d * m.num_experts
                        + 2.0 * per_token * expert_w)
                   + 4.0 * hq * hd * valid)
             + 2.0 * b * d * cfg.vocab)
    ms, by = _bound(flops, nbytes)
    return dict(bound_ms=ms, bound_by=by, bytes=nbytes, flops=flops,
                experts=sum(touched) / nl)


def _host_ms(fn, reps: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def time_decode_steps(model, params, cfg, smi: str, reps: int = 5) -> None:
    """One full-width decode step (4 x 1024 cache, the engine's lengths)
    under ``moe_impl="dense"`` and ``"ep_a2a"``, in turns (dense, grouped,
    grouped, dense): device ms (the profiler's kernel time), host ms with
    and without the profiler, and each lowering's bound from this step's
    routing."""
    lens = DECODE_LENS[0][0]
    cache = model.init_cache(MAX_BATCH, MAX_LEN)
    gen = torch.Generator(device="cuda").manual_seed(11)
    batch = {"tokens": torch.randint(0, cfg.vocab, (MAX_BATCH, 1),
                                     generator=gen, device="cuda"),
             "lengths": torch.tensor(lens, dtype=torch.int32,
                                     device="cuda")}

    def step(impl):
        return lambda: model.apply_decode(params, cache, batch,
                                          moe_impl=impl)
    bounds = {}
    for impl in ("dense", "ep_a2a"):
        with recorded_routes() as routes:
            step(impl)()                         # warm-up, and its routing
        bounds[impl] = decode_step_bound(cfg, routes, impl == "dense", lens)
    for impl in ("dense", "ep_a2a", "ep_a2a", "dense"):
        r = _profile(step(impl), reps)
        host = _host_ms(step(impl), reps)
        bd = bounds[impl]
        dev = ("not measured" if r is None else
               f"{r['device_ms']:.3f} ms on the device "
               f"({r['device_ms'] / bd['bound_ms']:.2f}x its bound), "
               f"{r['wall_ms']:.3f} ms on the host clock under the profiler")
        log(f"time {cfg.name} decode step B=4 S=1024 lens={lens} "
            f"moe_impl={impl}: {dev}, {host:.3f} ms on the host clock "
            f"without it; bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}: "
            f"{bd['bytes'] / 1e9:.3f} GB, {bd['flops'] / 1e9:.1f} GFLOP, "
            f"{bd['experts']:.2f} experts read a layer) [{smi}]")


def stub_inputs(cfg, b: int, t: int, seed: int) -> dict:
    """Random stub frontend inputs, N(0, 1) x 0.1 in bf16 as
    tests/test_arch_smoke.py draws them: whisper's (b, max(t // 2, 1), d)
    frames or the VLM's (b, Nv, d) vision embeddings; none for the other
    families.  (The engine feeds zeros, which make every cross K/V, or the
    VLM's cross values, 0.)"""
    if cfg.family not in ("audio", "vlm"):
        return {}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = max(t // 2, 1) if cfg.family == "audio" else cfg.n_vision_tokens
    name = "frames" if cfg.family == "audio" else "vision"
    return {name: _randn((b, rows, cfg.d_model), torch.bfloat16, gen) * 0.1}


def open_gates(params: dict) -> dict:
    """A copy of VLM parameters with both tanh gates of every cross layer at
    1.0, so that the cross branch carries weight (they start at 0)."""
    cross = params["cross"]
    return {**params, "cross": {
        **cross, "gate_attn": torch.ones_like(cross["gate_attn"]),
        "gate_mlp": torch.ones_like(cross["gate_mlp"])}}


def cross_launches(cfg) -> tuple[int, int]:
    """Attention calls per admitted prompt (flash) and per decode step
    (decode): whisper's 4 encoder, 4 self and 4 cross layers, then 4 self
    and 4 cross; the VLM's 32 self and 8 cross layers, both times."""
    if cfg.family == "audio":
        return cfg.encoder_layers + 2 * cfg.n_layers, 2 * cfg.n_layers
    return cfg.n_layers, cfg.n_layers


def vlm_decode_step_bound(cfg, params, lens) -> dict:
    """Least time of one VLM decode step of len(lens) tokens.  Bytes: every
    weight the step reads once (all but the embedding table, of which it
    reads len(lens) rows, and the cross layers' wk/wv, whose K/V is
    cached), the valid self k/v and the new ones written, the whole cross
    cache, the fp32 logits.  Operations: 2 per weight element a token, and
    attention over those keys, at the bf16 peak."""
    b, d = len(lens), cfg.d_model
    g, nv = cfg.n_layers // cfg.cross_attn_every, cfg.n_vision_tokens
    n_self = cfg.n_layers - g
    skip = [params["embed"]["embedding"], params["cross"]["xattn"]["wk"],
            params["cross"]["xattn"]["wv"]]
    read = [x for x in _leaves(params) if not any(x is y for y in skip)]
    w_bytes = sum(x.numel() * x.element_size() for x in read)
    # the products' weights: all but the fp32 norms and the (g,) gates
    w_prod = sum(x.numel() for x in read
                 if x.dtype != torch.float32 and x.dim() > 1)
    valid = sum(min(n, MAX_LEN) for n in lens)
    kv = 2 * cfg.n_kv_heads * cfg.hd * 2           # k and v of a position
    nbytes = (w_bytes + 2.0 * b * d + n_self * (valid + b) * kv
              + g * b * nv * kv + b * cfg.vocab * 4)
    flops = (2.0 * b * w_prod
             + 4.0 * cfg.n_heads * cfg.hd * (n_self * valid + g * b * nv))
    ms, by = _bound(flops, nbytes)
    return dict(bound_ms=ms, bound_by=by, bytes=nbytes, flops=flops,
                weight_bytes=w_bytes)


def time_vlm_decode_step(model, params, cfg, smi: str, reps: int = 5
                         ) -> None:
    """One full-width VLM decode step (4 x 1024 cache, the engine's
    lengths): device ms (the profiler's kernel time) and host ms, beside
    its bound."""
    lens = DECODE_LENS[0][0]
    cache = model.init_cache(MAX_BATCH, MAX_LEN)
    gen = torch.Generator(device="cuda").manual_seed(12)
    batch = {"tokens": torch.randint(0, cfg.vocab, (MAX_BATCH, 1),
                                     generator=gen, device="cuda"),
             "lengths": torch.tensor(lens, dtype=torch.int32,
                                     device="cuda")}

    def step():
        return model.apply_decode(params, cache, batch)
    step()
    bd = vlm_decode_step_bound(cfg, params, lens)
    r = _profile(step, reps)
    host = _host_ms(step, reps)
    dev = ("not measured" if r is None else
           f"{r['device_ms']:.3f} ms on the device "
           f"({r['device_ms'] / bd['bound_ms']:.2f}x its bound), "
           f"{r['wall_ms']:.3f} ms on the host clock under the profiler")
    log(f"time {cfg.name} decode step B=4 S=1024 lens={lens}: {dev}, "
        f"{host:.3f} ms on the host clock without it; bound "
        f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}: {bd['bytes'] / 1e9:.3f}"
        f" GB, of which weights {bd['weight_bytes'] / 1e9:.3f} GB; "
        f"{bd['flops'] / 1e9:.1f} GFLOP) [{smi}]")


def serve_cross_families(smi: str) -> dict:
    """whisper-tiny (whole) and llama-3.2-vision-11b (full width and depth)
    through the engine, each freed before the next path: exact launch
    counts (``cross_launches``; SSD never), prefill-then-decode with random
    frames or vision (and the VLM's gates open) against the full forward,
    the decode and prefill profiler windows, and the VLM's decode step
    against its bound.  Returns each path's launches."""
    out = {}
    for aid in (WHISPER, VLM):
        gc.collect()
        torch.cuda.empty_cache()
        cfg, model, params, prompts, run = serve(
            aid, N_REQUESTS, ("flash_attention", "decode_attention"), smi)
        steps = len(run["eng"].decode_seconds)
        per_prompt, per_step = cross_launches(cfg)
        want = {"flash_attention": N_REQUESTS * per_prompt,
                "decode_attention": steps * per_step, "ssd_intra_chunk": 0,
                "ssd_decode": 0, "mamba_prefill": 0}
        if run["launches"] != want:
            raise AssertionError(f"{aid} launches {run['launches']}, "
                                 f"expected {want}")
        log(f"{aid} launches = {N_REQUESTS} prompts x {per_prompt} of flash, "
            f"{steps} decode steps x {per_step} of decode, no SSD")
        out[aid] = run["launches"]
        del run
        gated = open_gates(params) if cfg.family == "vlm" else params
        err = check_prefill_then_decode(model, gated, cfg, PTD_LIMIT[aid],
                                        stub_inputs(cfg, 2, 256, 17))
        log(f"{aid} prefill-then-decode vs full forward (B=2, P=255, random "
            f"{'frames' if cfg.family == 'audio' else 'vision, gates 1.0'}):"
            f" max|err| {err:.3e} within {PTD_LIMIT[aid]}")
        log(f"{aid} where the time goes: "
            f"{decode_breakdown(model, params, prompts)} [{smi}]")
        log(f"{aid} prefill: {prefill_breakdown(model, params, prompts[0])} "
            f"[{smi}]")
        if cfg.family == "vlm":
            time_vlm_decode_step(model, params, cfg, smi)
        del params, model, gated
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve_qwen3(smi: str) -> None:
    """qwen3-moe-30b-a3b at full width and depth through the engine, once
    the earlier paths are freed: exact launch counts (flash once a layer per
    prompt, decode once a layer per decode step, SSD never),
    prefill-then-decode and the grouped step against the dense oracle,
    the profiler windows (a decode step must run no copy kernel as long as
    a tenth of an expert stack's copy), and the decode step's time under
    both lowerings."""
    gc.collect()
    torch.cuda.empty_cache()
    log(f"before {QWEN3}: {torch.cuda.memory_allocated() / 2**30:.3f} GiB "
        "allocated (the earlier paths' weights, caches and engines freed)")
    cfg, model, params, prompts, run = serve(
        QWEN3, N_REQUESTS, ("flash_attention", "decode_attention"), smi)
    steps = len(run["eng"].decode_seconds)
    want = {"flash_attention": N_REQUESTS * cfg.n_layers,
            "decode_attention": steps * cfg.n_layers, "ssd_intra_chunk": 0,
            "ssd_decode": 0, "mamba_prefill": 0}
    if run["launches"] != want:
        raise AssertionError(f"{QWEN3} launches {run['launches']}, expected "
                             f"{want}")
    log(f"{QWEN3} launches = {N_REQUESTS} prompts x {cfg.n_layers} layers "
        f"of flash, {steps} decode steps x {cfg.n_layers} layers of decode, "
        "no SSD")
    del run
    err = check_prefill_then_decode(model, params, cfg, PTD_LIMIT[QWEN3])
    log(f"{QWEN3} prefill-then-decode vs full forward (B=2, P=255): "
        f"max|err| {err:.3e} within {PTD_LIMIT[QWEN3]}")
    check_moe_impls(model, params, cfg, prompts[0], PTD_LIMIT[QWEN3])
    m = cfg.moe
    copy_ms = (0.1 * 2 * m.num_experts * cfg.d_model * m.d_ff_expert * 2
               / PEAK_BYTES * 1e3)
    log(f"{QWEN3} where the time goes: "
        f"{decode_breakdown(model, params, prompts, max_copy_ms=copy_ms)} "
        f"(no copy kernel over {copy_ms:.4f} ms) [{smi}]")
    log(f"{QWEN3} prefill: {prefill_breakdown(model, params, prompts[0])} "
        f"[{smi}]")
    time_decode_steps(model, params, cfg, smi)
    log(f"{QWEN3} peak memory over the path: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{smi}]")
    del params, model
    gc.collect()
    torch.cuda.empty_cache()


def check_mixtral(smi: str) -> None:
    """mixtral-8x7b at full width and ``MIXTRAL_LAYERS`` of its layers:
    prefill-then-decode against the full forward, and the grouped step
    against the dense oracle on one prompt (the engine's first)."""
    full = get_config(MIXTRAL)
    cfg = dataclasses.replace(full, n_layers=MIXTRAL_LAYERS)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n = sum(x.numel() for x in _leaves(params))
    log(f"{MIXTRAL} full width, {cfg.n_layers} of {full.n_layers} layers "
        f"(all {full.n_layers}: {full.params_total() * 2 / 2**30:.2f} GiB "
        f"in bf16): {n / 1e9:.3f} B parameters, "
        f"{2 * n / 2**30:.2f} GiB, init {time.perf_counter() - t0:.1f} s")
    err = check_prefill_then_decode(model, params, cfg, PTD_LIMIT[MIXTRAL])
    log(f"{MIXTRAL} prefill-then-decode vs full forward (B=2, P=255): "
        f"max|err| {err:.3e} within {PTD_LIMIT[MIXTRAL]}")
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, size=int(
        rng.integers(32, 513, size=N_REQUESTS)[0])).astype(np.int32)
    check_moe_impls(model, params, cfg, prompt, PTD_LIMIT[MIXTRAL])
    del params, model
    gc.collect()
    torch.cuda.empty_cache()


def time_moe_layer(t: int, smi: str) -> None:
    """One full-width qwen3 MoE layer over ``t`` tokens: the grouped step,
    its gate product alone (one ``torch._grouped_mm``) and the dense
    oracle, in device ms, each beside its bound (bytes: the tokens in and
    out, the router, the experts each reads; operations: the products)."""
    cfg = get_config(QWEN3)
    m = cfg.moe
    d, e, f, k = cfg.d_model, m.num_experts, m.d_ff_expert, m.top_k
    p = moe_layer(cfg, 1200)
    x = moe_input(cfg, p, t, 1201, None)
    _, idx = L.moe_router(m, p["router"], x.reshape(t, d))
    flat = idx.reshape(-1)
    touched = int(flat.unique().numel())
    srt, order = torch.sort(flat, stable=True)
    offs = torch.searchsorted(srt, torch.arange(e, dtype=srt.dtype,
                                                device="cuda"),
                              right=True).to(torch.int32)
    xs = x.reshape(t, d)[order // k]
    gate_bound = _bound(2.0 * t * k * d * f,
                        2.0 * (t * k * d + touched * d * f + t * k * f))
    rows = {"grouped": t * k, "dense": t * e}
    reads = {"grouped": touched, "dense": e}
    fns = {"grouped": lambda: moe_ep.moe_ep_a2a(cfg, p, x),
           "dense": lambda: L.moe_dense(cfg, p, x)}
    parts = []
    for name in ("grouped", "dense"):
        bound = _bound(2.0 * t * d * e + 2.0 * rows[name] * 3 * d * f,
                       2.0 * (2 * t * d + d * e + reads[name] * 3 * d * f))
        ms = time_ms(fns[name], None)
        parts.append(f"{name} {ms:.4f} ms (bound {bound[0]:.4f} ms, "
                     f"{bound[1]}; {ms / bound[0]:.2f}x)")
    ms = time_ms(lambda: torch._grouped_mm(xs, p["w_gate"], offs=offs), None)
    log(f"time moe layer {QWEN3} T={t}: {touched} of {e} experts routed; "
        + ", ".join(parts) + f"; the gate's torch._grouped_mm alone "
        f"{ms:.4f} ms (bound {gate_bound[0]:.4f} ms, {gate_bound[1]}; "
        f"{ms / gate_bound[0]:.2f}x) [{smi}]")
    del p, x, xs


# --------------------------------------------------------------------------
# Training: the backward kernel, the trainer CLI, gemma-2b at full width
# --------------------------------------------------------------------------

# gemma-2b's training shape: a batch of 2 sequences of 1024 tokens
TRAIN_B, TRAIN_T = 2, 1024
TRAIN_STEPS = 5
GRAD_CHECK_LAYERS = 2
# the backward kernel against ref.attention_bwd_naive, both from the same
# forward output and LSE: fp32 sums run in another order over up to Tq
# query rows (dK, dV) or Tk keys (dQ); in bf16 the kernel also rounds P and
# dS to bf16 for their products (the plain version keeps them fp32), and
# both round dQ/dK/dV once
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# one full-width train step through the kernels against the same step with
# attention on the plain versions (autograd of ref.attention_naive), leaf by
# leaf in relative norm: the wgmma forward rounds P to bf16 for its PV
# product and takes exp2 on ex2.approx, where the plain version keeps fp32
GRAD_CHECK_TOL = 5e-2


def _counts() -> dict:
    return {"flash_attention": fa.launches,
            "flash_attention_bwd": fa.bwd_launches,
            "ssd_intra_chunk": ssd_scan.launches,
            "ssd_intra_chunk_bwd": ssd_scan.bwd_launches}


def _zero_counts() -> None:
    fa.launches = fa.bwd_launches = 0
    ssd_scan.launches = ssd_scan.bwd_launches = 0


def _step_launches(cfg, layers: int | None = None) -> dict:
    """The kernel calls of one train step (remat on): a forward call per
    layer and per remat recompute, a backward call per layer, for flash
    where the family attends and for the SSD pass where it has SSM
    layers."""
    n = cfg.n_layers if layers is None else layers
    attn = n if cfg.family != "ssm" else 0
    ssm = n if cfg.family in ("ssm", "hybrid") else 0
    return {"flash_attention": 2 * attn, "flash_attention_bwd": attn,
            "ssd_intra_chunk": 2 * ssm, "ssd_intra_chunk_bwd": ssm}


def check_flash_bwd(b, tq, tk, hq, hkv, d, win, caus, dtype, lens, seed,
                    tag) -> float:
    """The forward's LSE and output against ``ref.attention_lse_naive``
    (``TOL``), then dQ/dK/dV of the backward kernel against
    ``ref.attention_bwd_naive`` from the kernel's own output and LSE
    (``BWD_TOL``); two calls give the same bits (no atomics); in bf16 also
    against the kernel's arithmetic ``ref.attention_bwd_split``
    (``BWD_TOL``).  Returns the backward's largest error against the plain
    version."""
    args, kw = flash_case(b, tq, tk, hq, hkv, d, win, caus, dtype, lens,
                          seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 5000)
    do = _randn((b, tq, hq, d), dtype, gen)
    o, lse = fa.flash_attention_fwd(*args, with_lse=True, **kw)
    want_o, want_lse = ref.attention_lse_naive(*args, **kw)
    _check(f"flash out {tag}", o, want_o, TOL[dtype])
    _check(f"flash lse {tag}", lse, want_lse, TOL[dtype])
    got = fa.flash_attention_bwd(*args, o, lse, do, **kw)
    want = ref.attention_bwd_naive(*args, o, lse, do, **kw)
    err = max(_check(f"flash bwd {tag} d{n}", g, w, BWD_TOL[dtype])
              for n, g, w in zip("qkv", got, want))
    again = fa.flash_attention_bwd(*args, o, lse, do, **kw)
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
        raise AssertionError(f"flash bwd {tag}: two calls part")
    if dtype == torch.bfloat16:
        model = ref.attention_bwd_split(*args, o, lse, do, **kw)
        for n, g, w in zip("qkv", got, model):
            _check(f"flash bwd {tag} d{n} vs its arithmetic", g, w,
                   BWD_TOL[dtype])
    return err


def check_backward() -> float:
    """The backward kernel on the reference's shape list in fp32 and bf16,
    and at the training shapes, in bf16 and fp32, every key valid, as
    training calls it: gemma-2b's (B=2, T=1024, causal, 8 heads over 1,
    D=256), hymba-1.5b's (B=1, T=2048, causal, 25 heads over 5, D=64,
    window 1024, which masks keys) and qwen3-moe-30b-a3b's (B=2, T=1024,
    causal, 32 heads over 4, D=128); returns the largest error at the
    training shapes in bf16."""
    worst = {dt: 0.0 for dt in TOL}
    for i, (b, tq, tk, hq, hkv, d, win, caus, _, _) in enumerate(SHAPES):
        for dtype in TOL:
            lens = [tk] + [max(tk * 2 // 3, 1)] * (b - 1)
            err = check_flash_bwd(b, tq, tk, hq, hkv, d, win, caus, dtype,
                                  lens, 1500 + i, f"{SHAPES[i]} {dtype}")
            worst[dtype] = max(worst[dtype], err)
    log(f"flash backward vs plain, reference shape list: {2 * len(SHAPES)} "
        f"cases; largest max|err| fp32 {worst[torch.float32]:.3e} (tol "
        f"{BWD_TOL[torch.float32]}), bf16 {worst[torch.bfloat16]:.3e} (tol "
        f"{BWD_TOL[torch.bfloat16]})")
    train = {}
    for dtype in TOL:
        train[dtype] = check_flash_bwd(
            TRAIN_B, TRAIN_T, TRAIN_T, HQ, HKV, HD, None, True, dtype,
            [TRAIN_T] * TRAIN_B, 1600, f"gemma-2b training {dtype}")
        log(f"  flash bwd gemma-2b training B={TRAIN_B} T={TRAIN_T} "
            f"{dtype}: max|err| {train[dtype]:.3e} (tol {BWD_TOL[dtype]})")
    hq, hkv, hd, win = HYMBA_ATTN
    b, t = SSM_TRAIN_BATCH["hymba-1.5b"]
    for dtype in TOL:
        err = check_flash_bwd(b, t, t, hq, hkv, hd, win, True, dtype, [t] * b,
                              1650, f"hymba-1.5b training {dtype}")
        log(f"  flash bwd hymba-1.5b training B={b} T={t} window={win} "
            f"{dtype}: max|err| {err:.3e} (tol {BWD_TOL[dtype]})")
        train[dtype] = max(train[dtype], err)
    hq, hkv, hd, _ = QWEN3_ATTN
    for dtype in TOL:
        err = check_flash_bwd(TRAIN_B, TRAIN_T, TRAIN_T, hq, hkv, hd, None,
                              True, dtype, [TRAIN_T] * TRAIN_B, 1680,
                              f"{QWEN3} training {dtype}")
        log(f"  flash bwd {QWEN3} training B={TRAIN_B} T={TRAIN_T} heads "
            f"{hq}/{hkv} D={hd} {dtype}: max|err| {err:.3e} (tol "
            f"{BWD_TOL[dtype]})")
        train[dtype] = max(train[dtype], err)
    torch.cuda.synchronize()
    return train[torch.bfloat16]


def _by_name(r: dict | None) -> str:
    """A ``_profile`` result's device ms a call by kernel name."""
    if r is None:
        return "not measured (the profiler saw no kernels)"
    return "; ".join(f"{k[:40]} {v:.4f} ms" for k, v in r["by_name"].items())


def decode_launch_times(smi: str) -> None:
    """Decode's two launches (split, combine), each its own device time by
    kernel name (``torch.profiler`` over 20 calls back to back, ms a
    call), beside the whole call's device time (CUDA events, queued, L2
    flushed before each call) at gemma-2b's serving decode shape (B=4,
    S=1024, the engine's lengths ``DECODE_LENS[0]``) and at one share of
    ``decode_32k`` (B=128, the last 4096 of 32768 rows, every row valid,
    the LSE output); then the merge's one launch by name and its call's
    device time at 2, 4 and 8 ranks of B=128, Hq=8, D=256 bf16, beside its
    bound; and the same two readings of an empty launch
    (``torch.cuda._sleep(0)``), the floor under both.
    ``scripts/decode_combine_ab.py`` runs this function's source against
    another checkout's kernels too."""
    def own(r, key):
        if r is None:
            return "not measured (the profiler saw no kernels)"
        return f"{sum(v for k, v in r['by_name'].items() if key in k):.5f} ms"

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    lens = DECODE_LENS[0][0]
    args, lt = decode_case(MAX_BATCH, MAX_LEN, HQ, HKV, HD, torch.bfloat16,
                           lens, 500)
    b, s = TP_DECODE
    m = s // TP_SHARES
    gen = torch.Generator(device="cuda").manual_seed(2600)
    q = _randn((b, 1, HQ, HD), torch.bfloat16, gen)
    ks = _randn((b, m, HKV, HD), torch.bfloat16, gen)
    vs = _randn((b, m, HKV, HD), torch.bfloat16, gen)
    full = torch.full((b,), s, dtype=torch.int32, device="cuda")
    for tag, fn, ns in (
            (f"gemma-2b serving decode B={MAX_BATCH} S={MAX_LEN} "
             f"lens={lens}", lambda: da.decode_attention(*args, lt),
             da.split_plan(MAX_BATCH, HKV, MAX_LEN, None)),
            (f"one share of decode_32k B={b} rows {m} k_offset {s - m}",
             lambda: da.decode_attention(q, ks, vs, full, k_offset=s - m,
                                         return_lse=True),
             da.split_plan(b, HKV, m, None))):
        r = _profile(fn, 20)
        log(f"decode launches, {tag} ({ns} splits): split "
            f"{own(r, 'decode_split')}, combine {own(r, 'decode_combine')} "
            f"by name; the whole call {time_ms(fn, flush):.5f} ms [{smi}]")
    outs = _randn((b, HQ, TP_SHARES, HD), torch.bfloat16, gen)
    lses = torch.randn((b, HQ, TP_SHARES), generator=gen, device="cuda")
    for r in (2, 4, TP_SHARES):
        o, l = outs[:, :, :r].contiguous(), lses[..., :r].contiguous()
        bound = _bound(3.0 * o.numel(), 2.0 * o.numel() + 4.0 * l.numel()
                       + 2.0 * b * HQ * HD)
        p = _profile(lambda: da.merge(o, l), 20)
        log(f"merge launch, R={r} B={b} Hq={HQ} D={HD} bf16: "
            f"{own(p, 'decode_combine')} by name; the call "
            f"{time_ms(lambda: da.merge(o, l), None):.5f} ms; bound "
            f"{bound[0]:.5f} ms ({bound[1]}) [{smi}]")
    empty = _profile(lambda: torch.cuda._sleep(0), 20)
    log(f"an empty launch: {own(empty, 'spin')} by name; the call "
        f"{time_ms(lambda: torch.cuda._sleep(0), None):.5f} ms [{smi}]")


def bwd_launch_times(smi: str) -> None:
    """Each backward launch's device time by kernel name (``torch.profiler``
    over 5 calls, ms a call) at the training shapes of both backward
    kernels: flash at gemma-2b's (B=2, T=1024), hymba-1.5b's (B=1, T=2048,
    window 1024) and qwen3-moe-30b-a3b's (B=2, T=1024, 32 heads over 4,
    D=128) in bf16, with ``bwd_plan``'s splits; the SSD pass
    at mamba2-780m's and hymba-1.5b's, with its head groups."""
    hq, hkv, hd, win = HYMBA_ATTN
    hb, ht = SSM_TRAIN_BATCH["hymba-1.5b"]
    for tag, b, t, (nq, nkv, d), w in (
            ("gemma-2b", TRAIN_B, TRAIN_T, (HQ, HKV, HD), None),
            ("hymba-1.5b", hb, ht, (hq, hkv, hd), win),
            (QWEN3, TRAIN_B, TRAIN_T, QWEN3_ATTN[:3], None)):
        args, kw = flash_case(b, t, t, nq, nkv, d, w, True, torch.bfloat16,
                              [t] * b, 1750)
        gen = torch.Generator(device="cuda").manual_seed(1751)
        do = _randn(args[0].shape, torch.bfloat16, gen)
        o, lse = fa.flash_attention_fwd(*args, with_lse=True, **kw)
        plan = fa.bwd_plan(b, t, t, nq, nkv, d, causal=True, window=w)
        r = _profile(lambda: fa.flash_attention_bwd(*args, o, lse, do, **kw),
                     5)
        log(f"flash bwd launches, {tag} training B={b} T={t} window={w} "
            f"(splits {plan['splits']}, {plan['blocks']} dK/dV blocks): "
            f"{_by_name(r)} [{smi}]")
    for tag, shape in zip(SSM_TRAIN_BATCH, SSD_TRAIN):
        b, t, nh, hd, n, chunk = shape
        ops_ = ssd_scan.chunk_operands(*ssd_case(b, t, nh, hd, n, 1760)[:5],
                                       chunk)
        dy, dstates = _bwd_case(ops_, nh, hd, 1761)
        plan = ssd_scan.bwd_plan(b, *ops_[0].shape[1:3], nh, n, hd)
        r = _profile(lambda: ssd_scan.ssd_intra_chunk_bwd(
            *ops_, dy, dstates, nh=nh, hd=hd), 5)
        log(f"ssd bwd launches, {tag} training {shape} (heads per group "
            f"{plan['heads_per_group']}, {plan['blocks']} head blocks): "
            f"{_by_name(r)} [{smi}]")


def time_flash_bwd(flush, heads=(HQ, HKV, HD)) -> dict:
    """The backward at a training shape (B=2, T=1024, causal; gemma-2b's
    heads unless ``heads`` = (hq, hkv, d) says otherwise): kernel, plain
    version and SDPA's backward (autograd through
    ``scaled_dot_product_attention``, the graph kept, only the backward
    timed), device ms.  Its least work: the five products (S, dP, dV, dQ,
    dK), 2 D FLOPs each per causal (query, key) pair and head; bytes: q, k,
    v, o, dO read once and dq, dk, dv written once in bf16, the LSE in
    fp32."""
    hq, hkv, hd = heads
    args, kw = flash_case(TRAIN_B, TRAIN_T, TRAIN_T, hq, hkv, hd, None, True,
                          torch.bfloat16, [TRAIN_T] * TRAIN_B, 1700)
    q, k, v = args
    gen = torch.Generator(device="cuda").manual_seed(1701)
    do = _randn(q.shape, torch.bfloat16, gen)
    o, lse = fa.flash_attention_fwd(*args, with_lse=True, **kw)
    pairs = TRAIN_B * TRAIN_T * (TRAIN_T + 1) / 2
    flops = 10.0 * hq * hd * pairs
    nbytes = 2.0 * (4 * q.numel() + 4 * k.numel()) + 4.0 * lse.numel()
    bound, by = _bound(flops, nbytes)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in args)
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    return dict(
        **_times(lambda: fa.flash_attention_bwd(*args, o, lse, do, **kw),
                 lambda: ref.attention_bwd_naive(*args, o, lse, do, **kw),
                 lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                             retain_graph=True), flush),
        bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes)


def run_trainer(smi: str) -> None:
    """``repro_torch.launch.train`` at its defaults on the card (reduced
    gemma-2b, d_model 256, 8 layers, 200 steps of 8 x 256, a checkpoint every
    50 steps): the loss must fall (the CLI's own check) and the last
    checkpoint be step 200.  A second run over the same directory with 400
    steps must resume there and end at step 600."""
    with tempfile.TemporaryDirectory() as d:
        _zero_counts()
        first = train_cli.main(["--ckpt-dir", d])
        counts = _counts()
        latest = train_ckpt.latest(d)
        if first["step"] != 200 or not latest or \
                not latest.endswith("ckpt_00000200.msgpack"):
            raise AssertionError(f"trainer ended at step {first['step']}, "
                                 f"last checkpoint {latest}")
        if counts != {k: 200 * v for k, v in _step_launches(
                get_config("gemma-2b"), 8).items()}:
            raise AssertionError(f"trainer launches {counts}, expected "
                                 "16 forward and 8 backward flash calls a "
                                 "step")
        log(f"trainer (defaults): 200 steps of 8 x 256 in "
            f"{first['seconds']:.2f} s = "
            f"{8 * 256 * 200 / first['seconds']:.0f} tok/s; loss first5 "
            f"{[round(x, 3) for x in first['first5']]} last5 "
            f"{[round(x, 3) for x in first['last5']]}; checkpoints "
            f"{sorted(os.listdir(d))}; launches {counts} [{smi}]")
        second = train_cli.main(["--ckpt-dir", d, "--steps", "400"])
        if second["step"] != 600 or second["steps_run"] != 400:
            raise AssertionError(f"the resumed run ended at step "
                                 f"{second['step']} after "
                                 f"{second['steps_run']} steps")
        log(f"trainer resumed from step 200: 400 more steps to step "
            f"{second['step']} in {second['seconds']:.2f} s; loss first5 "
            f"{[round(x, 3) for x in second['first5']]} last5 "
            f"{[round(x, 3) for x in second['last5']]}")


def run_ssm_trainer(smi: str) -> None:
    """``repro_torch.launch.train --arch mamba2-780m`` at its other defaults
    (d_model 256, 8 layers, the reduced SSM spec: 32 heads of head_dim 16,
    d_state 8, chunk 8; 200 steps of 8 x 256): the loss must fall (the
    CLI's own check), through exactly 16 forward and 8 backward SSD calls a
    step."""
    with tempfile.TemporaryDirectory() as d:
        _zero_counts()
        out = train_cli.main(["--arch", "mamba2-780m", "--ckpt-dir", d])
        counts = _counts()
        want = {k: out["steps_run"] * v for k, v in _step_launches(
            get_config("mamba2-780m"), 8).items()}
        if out["step"] != 200 or counts != want:
            raise AssertionError(f"mamba2-780m trainer ended at step "
                                 f"{out['step']} with launches {counts}, "
                                 f"expected {want}")
        log(f"trainer --arch mamba2-780m: 200 steps of 8 x 256 in "
            f"{out['seconds']:.2f} s = "
            f"{8 * 256 * 200 / out['seconds']:.0f} tok/s; loss first5 "
            f"{[round(x, 3) for x in out['first5']]} last5 "
            f"{[round(x, 3) for x in out['last5']]}; launches {counts} "
            f"[{smi}]")


@contextlib.contextmanager
def plain_ssd():
    """``ops.ssd`` on the plain version (torch's autograd of
    ``ref.ssd_chunked``) for the comparison run only."""
    kernel = ops.ssd
    ops.ssd = ref.ssd_chunked
    try:
        yield
    finally:
        ops.ssd = kernel


@contextlib.contextmanager
def plain_attention():
    """``ops.flash_attention`` on the plain version (torch's autograd of
    ``ref.attention_naive``) for the comparison run only."""
    kernel = ops.flash_attention

    def plain(q, k, v, *, causal=True, window=None, q_offset=0,
              lengths=None, **_):
        return ref.attention_naive(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, lengths=lengths)

    ops.flash_attention = plain
    try:
        yield
    finally:
        ops.flash_attention = kernel


def _train_batch(cfg, seed: int, b: int = TRAIN_B, t: int = TRAIN_T
                 ) -> dict:
    batch = next(iter(SyntheticDataset(cfg, b, t, seed=seed)))
    return {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}


def _loss_and_grads(model, params, batch):
    ps = train_tree.map(lambda p: p.detach().requires_grad_(True), params)
    loss = train_loop.loss_fn(model, ps, batch)
    grads = torch.autograd.grad(loss, train_tree.leaves(ps))
    return loss.detach(), grads


def check_train_grads(smi: str, aid: str = "gemma-2b",
                      plain=plain_attention, batch=(TRAIN_B, TRAIN_T)
                      ) -> float:
    """``aid`` at full width and ``GRAD_CHECK_LAYERS`` layers: loss and
    gradients of ``loss_fn`` (remat, chunked CE) through the kernels
    against the same with ``plain`` putting the kernel under test on its
    plain version; returns the worst leaf's relative-norm error."""
    cfg = dataclasses.replace(get_config(aid), n_layers=GRAD_CHECK_LAYERS)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    tb = _train_batch(cfg, 1, *batch)
    _zero_counts()
    loss, grads = _loss_and_grads(model, params, tb)
    counts = _counts()
    want = _step_launches(cfg)
    if counts != want:
        raise AssertionError(f"gradient check launches {counts}, expected "
                             f"{want}")
    with plain():
        ploss, pgrads = _loss_and_grads(model, params, tb)
    if _counts() != want:
        raise AssertionError("the plain run launched a kernel under test")
    errs = [float((g.float() - w.float()).norm() / w.float().norm())
            for g, w in zip(grads, pgrads)]
    lerr = abs(float(loss) - float(ploss)) / abs(float(ploss))
    if not all(np.isfinite(errs)) or max(errs) > GRAD_CHECK_TOL or \
            lerr > 1e-2:
        raise AssertionError(f"{aid} kernel vs plain gradients: loss rel "
                             f"{lerr:.3e}, leaves {errs}")
    log(f"{aid} full width, {GRAD_CHECK_LAYERS} layers, B={batch[0]} "
        f"T={batch[1]}: loss {float(loss):.5f} through the kernels, "
        f"{float(ploss):.5f} on the plain version (rel {lerr:.2e}); "
        f"{len(errs)} gradient leaves, worst relative-norm error "
        f"{max(errs):.3e} (tol {GRAD_CHECK_TOL}); launches {counts} [{smi}]")
    del params, grads, pgrads
    return max(errs)


def train_full_depth(smi: str, aid: str = "gemma-2b",
                     batch=(TRAIN_B, TRAIN_T), layers: int | None = None,
                     moe_impl: str = "dense") -> dict:
    """``aid`` at full width and depth, or ``layers`` of its layers (fp32
    weights with fp32 AdamW state): ``TRAIN_STEPS`` steps of
    ``make_train_step`` (remat on, the MoE layers lowered as ``moe_impl``
    says) on ``SyntheticDataset`` at ``batch`` (B, T), exact kernel calls
    per step (``_step_launches``), then one more step under the profiler
    for the device-busy share.  The loss must fall over the steps.  Returns
    the step's numbers."""
    cfg = get_config(aid)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    b, t = batch
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    opt = train_optim.init(params)
    torch.cuda.synchronize()
    n = sum(x.numel() for x in train_tree.leaves(params))
    tag = aid if cfg.family != "moe" else f"{aid} moe_impl={moe_impl}"
    log(f"{tag} training: {cfg.n_layers} layers, {n / 1e9:.3f} B fp32 "
        f"parameters, AdamW state fp32, init {time.perf_counter() - t0:.1f}"
        f" s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    plan = ShardingPlan(arch=cfg.name, shape="train", mesh=GPU_NODE,
                        global_mode="data", local_layout="single",
                        batch_axes=(), remat=True, moe_impl=moe_impl)
    # the reference's OptConfig defaults (lr 3e-4 after 100 warm-up steps)
    step = train_loop.make_train_step(model, train_optim.OptConfig(), plan)
    data = iter(SyntheticDataset(cfg, b, t, seed=2))
    want = _step_launches(cfg)
    torch.cuda.reset_peak_memory_stats()
    times, losses, total = [], [], {k: 0 for k in want}
    for _ in range(TRAIN_STEPS):
        tb = {k: torch.as_tensor(v, device="cuda")
              for k, v in next(data).items()}
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, tb)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = _counts()
        if counts != want:
            raise AssertionError(f"{tag} train step launches {counts}, "
                                 f"expected {want}")
        for k in total:
            total[k] += counts[k]
        losses.append(float(metrics["loss"]))
    if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        raise AssertionError(f"{tag} train losses {losses}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = statistics.median(times)
    tb = {k: torch.as_tensor(v, device="cuda") for k, v in next(data).items()}
    state = [params, opt]

    def one_step():
        state[0], state[1], _ = step(state[0], state[1], tb)

    r = _profile(one_step, 1)
    busy = None if r is None else r["device_ms"] / r["wall_ms"]
    log(f"{tag} train step (B={b}, T={t}, remat, chunked CE):"
        f" {TRAIN_STEPS} steps, median {1e3 * med:.1f} ms "
        f"(steps {[round(1e3 * x, 1) for x in times]} ms) = "
        f"{b * t / med:.0f} tok/s; losses "
        f"{[round(x, 4) for x in losses]}; peak {peak:.2f} GiB; launches "
        f"per step {want} [{smi}]")
    log(f"{tag} train step: {_profiled(one_step, 1, 'train step', r)} "
        f"[{smi}]")
    if r is not None:
        top = sorted(r["by_name"].items(), key=lambda kv: -kv[1])[:12]
        log(f"{tag} train step, device ms by kernel: " + "; ".join(
            f"{k[:70]} {v:.3f}" for k, v in top))
    del params, opt, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return dict(step_ms=1e3 * med, tok_s=b * t / med, peak_gib=peak,
                busy=busy, launches=total, losses=losses)



# --------------------------------------------------------------------------
# MoE training: qwen3-moe-30b-a3b at full width under the three lowerings
# --------------------------------------------------------------------------

# qwen3-moe-30b-a3b trains at full width and 3 of its 48 layers.  One layer
# holds 623.1 M parameters (603.98 M of them experts), the untied embedding
# and head 622.3 M; at 16 bytes a parameter (fp32 weights, gradients and
# both AdamW moments) 3 layers are 37.1 GiB of state.  4 layers (46.4 GiB)
# run out of the card's memory in the optimizer step: ``apply_updates``
# makes the new parameters beside the old ones and each leaf's fp32
# temporaries (3 GiB for one stacked expert leaf of 4 layers) beside them
QWEN3_TRAIN_LAYERS = 3
# the lowerings trained, each from the same seeded initialisation; their
# runs' numbers by lowering, for the multi-GPU phase's comparison
TRAIN_MOE_IMPLS = ("ep_a2a", "ep_a2a_q8", "dense")
MOE_TRAIN_RUNS: dict = {}
# one MoE layer's gradients, leaf by leaf in relative norm, on the same
# activations and routing: the grouped step against the dense oracle at
# tests/test_torch_moe_train.py's LAYER_GRAD_TOL (about twice the
# reference's own ep-against-dense gap), and the int8 payload against the
# bf16 one at its Q8_TOL (four int8 round trips, each within half a step of
# its row's largest entry)
MOE_LAYER_TOL, MOE_Q8_TOL = 1e-2, 3e-2
# the grouped product's gradients against a loop of per-expert products:
# (rows per expert) at qwen3's widths, empty groups among them
GROUPED_ROWS = (300, 0, 129, 0, 512, 77, 0, 1006)


def check_grouped_mm_grads() -> None:
    """``torch._grouped_mm`` under autograd on the card, as the grouped step
    calls it: bf16 rows (n, d) against an expert stack (E, d, f) cast from
    fp32 leaves, the groups' int32 end offsets, some groups empty.  dX and
    the fp32 stack's gradient (through the cast) against autograd of a loop
    of per-expert bf16 products on the same operands, at the bf16 TOL."""
    cfg = get_config(QWEN3)
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    e, n = len(GROUPED_ROWS), sum(GROUPED_ROWS)
    gen = torch.Generator(device="cuda").manual_seed(1900)
    x = _randn((n, d), torch.bfloat16, gen)
    w = torch.randn((e, d, f), generator=gen, device="cuda") / d ** 0.5
    dy = _randn((n, f), torch.bfloat16, gen)
    offs = torch.tensor(GROUPED_ROWS, device="cuda").cumsum(0).to(
        torch.int32)

    def grads(fn):
        xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = fn(xs, ws.to(torch.bfloat16))
        return (y, *torch.autograd.grad(y, (xs, ws), dy))

    got = grads(lambda xs, ws: torch._grouped_mm(xs, ws, offs=offs))
    bounds = [0, *offs.tolist()]
    want = grads(lambda xs, ws: torch.cat([
        xs[lo:hi] @ ws[i] for i, (lo, hi) in enumerate(zip(bounds,
                                                            bounds[1:]))]))
    if got[2].dtype != torch.float32:
        raise AssertionError(f"the stack's gradient is {got[2].dtype}")
    errs = [_check(f"grouped_mm {what}", g, wt, TOL[torch.bfloat16])
            for what, g, wt in zip(("out", "dX", "dW"), got, want)]
    empty = [i for i, r in enumerate(GROUPED_ROWS) if not r]
    if bool(got[2][empty].any()):
        raise AssertionError("an empty group's weights got a gradient")
    log(f"torch._grouped_mm under autograd (torch {torch.__version__}): "
        f"{n} bf16 rows x {e} experts ({len(empty)} empty) of {d} x {f}, "
        f"fp32 leaves: out, dX, dW against a per-expert loop max|err| "
        + ", ".join(f"{x_:.3e}" for x_ in errs)
        + f" (TOL {TOL[torch.bfloat16]}); empty groups' dW exactly 0")


def check_moe_layer_grads(smi: str) -> None:
    """One qwen3 MoE layer at full width over B x T = 2048 tokens: the
    gradients of a seeded random cotangent (router, w_gate, w_up, w_down as
    fp32 leaves, x in bf16) through ``moe_ep_a2a`` against ``moe_dense``
    (``MOE_LAYER_TOL``) and through the int8 payload against the bf16 one
    (``MOE_Q8_TOL``), leaf by leaf in relative norm.  All three route with
    the port's ``moe_router`` on the same activations, so they route
    alike."""
    cfg = get_config(QWEN3)
    m = cfg.moe
    names = ("router", "w_gate", "w_up", "w_down")
    p32 = {k: v.float() for k, v in moe_layer(cfg, 1950).items()}
    gen = torch.Generator(device="cuda").manual_seed(1951)
    x = _randn((TRAIN_B, TRAIN_T, cfg.d_model), torch.bfloat16, gen)
    ct = _randn(x.shape, torch.bfloat16, gen)
    fns = {"dense": lambda ps, xs: L.moe_dense(cfg, ps, xs),
           "ep_a2a": lambda ps, xs: moe_ep.moe_ep_a2a(cfg, ps, xs),
           "ep_a2a_q8": lambda ps, xs: moe_ep.moe_ep_a2a(
               cfg, ps, xs, a2a_dtype="int8")}
    g = {}
    for impl, fn in fns.items():
        ps = {k: v.clone().requires_grad_(True) for k, v in p32.items()}
        xs = x.clone().requires_grad_(True)
        out = torch.autograd.grad(fn(ps, xs), [ps[k] for k in names] + [xs],
                                  ct)
        g[impl] = dict(zip(names + ("x",), out))
    for impl, against, tol in (("ep_a2a", "dense", MOE_LAYER_TOL),
                               ("ep_a2a_q8", "ep_a2a", MOE_Q8_TOL)):
        errs = {k: float((v.float() - g[against][k].float()).norm()
                         / g[against][k].float().norm())
                for k, v in g[impl].items()}
        if not all(bool(torch.isfinite(v).all()) for v in g[impl].values()) \
                or not max(errs.values()) <= tol:
            raise AssertionError(f"{QWEN3} MoE layer gradients {impl} vs "
                                 f"{against}: {errs} (tol {tol})")
        log(f"{QWEN3} one MoE layer at full width, T={x.shape[0] * x.shape[1]}"
            f": gradients {impl} vs {against}, relative norm "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f" (tol {tol}) [{smi}]")
    t = x.shape[0] * x.shape[1]
    cap = moe_ep.capacity(t, m.top_k, m.capacity_factor)
    log(f"{QWEN3} capacity at factor {m.capacity_factor}: "
        f"{min(t * m.top_k, cap)} of the {t * m.top_k} assignments kept "
        f"(cap {cap})")
    del g, p32


# a token that two lowerings route to other experts must have its k-th and
# (k+1)-th router probabilities closer than this at the layer where they
# part, in the dense run
MOE_NEAR_TIE = 1e-3


def check_moe_model_grads(smi: str) -> None:
    """qwen3-moe-30b-a3b at full width and ``GRAD_CHECK_LAYERS`` layers:
    loss and gradients of ``loss_fn`` (remat, chunked CE) on one B=2 x
    T=1024 batch under ``moe_impl="ep_a2a"`` against ``"dense"``, the flash
    kernels in both runs.  The two lowerings round differently, so a token
    may be routed apart in a later layer; each such token must be a near
    tie (``MOE_NEAR_TIE``) where it parts.  Leaves are held by relative
    norm at ``GRAD_CHECK_TOL``, the loss at 1e-2 relative."""
    cfg = dataclasses.replace(get_config(QWEN3), n_layers=GRAD_CHECK_LAYERS)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    tb = _train_batch(cfg, 1)
    out = {}
    for impl in ("ep_a2a", "dense"):
        _zero_counts()
        with recorded_routes() as calls:
            ps = train_tree.map(lambda p: p.detach().requires_grad_(True),
                                params)
            loss = train_loop.loss_fn(model, ps, tb, moe_impl=impl)
            grads = torch.autograd.grad(loss, train_tree.leaves(ps))
        if _counts() != _step_launches(cfg):
            raise AssertionError(f"{QWEN3} {impl} gradient check launches "
                                 f"{_counts()}, expected "
                                 f"{_step_launches(cfg)}")
        # the forward's calls, one a layer (the remat recomputes follow)
        out[impl] = (loss.detach(), grads, calls[:cfg.n_layers])
    (lg, gg, rg), (ld, gd, rd) = out["ep_a2a"], out["dense"]
    parted, ties = 0, []
    seen = torch.zeros_like(rd[0][1], dtype=torch.bool)
    for (ig, _), (idd, gap) in zip(rg, rd):
        part = (ig.sort(-1).values != idd.sort(-1).values).any(-1) & ~seen
        parted += int(part.sum())
        ties.extend(gap[part].tolist())
        seen |= part
    if ties and max(ties) >= MOE_NEAR_TIE:
        raise AssertionError(f"{QWEN3} ep_a2a and dense route a token apart "
                             f"with a gap of {max(ties):.3e} (near tie "
                             f"{MOE_NEAR_TIE})")
    errs = [float((g.float() - w.float()).norm() / w.float().norm())
            for g, w in zip(gg, gd)]
    lerr = abs(float(lg) - float(ld)) / abs(float(ld))
    if not all(np.isfinite(errs)) or max(errs) > GRAD_CHECK_TOL or \
            lerr > 1e-2:
        raise AssertionError(f"{QWEN3} ep_a2a vs dense gradients: loss rel "
                             f"{lerr:.3e}, leaves {errs}")
    log(f"{QWEN3} full width, {GRAD_CHECK_LAYERS} layers, B={TRAIN_B} "
        f"T={TRAIN_T}: loss {float(lg):.5f} under ep_a2a, {float(ld):.5f} "
        f"under dense (rel {lerr:.2e}); {parted} of {seen.numel()} tokens "
        f"routed apart, largest gap among them "
        f"{max(ties) if ties else 0.0:.3e} (near tie {MOE_NEAR_TIE}); "
        f"{len(errs)} gradient leaves, worst relative-norm error "
        f"{max(errs):.3e} (tol {GRAD_CHECK_TOL}) [{smi}]")
    del params, out, gg, gd


def moe_train_phases(smi: str) -> dict:
    """The MoE training slice: ``torch._grouped_mm``'s gradients, one
    full-width qwen3 MoE layer's gradients under the three lowerings, the
    2-layer whole-model check of ``"ep_a2a"`` against ``"dense"``, then
    ``QWEN3_TRAIN_LAYERS`` layers of qwen3-moe-30b-a3b trained
    ``TRAIN_STEPS`` steps under each lowering (exactly 6 forward and 3
    backward flash calls a step, the loss falling).  Returns the flash
    backward's launches of the first run."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    check_grouped_mm_grads()
    check_moe_layer_grads(smi)
    gc.collect()
    torch.cuda.empty_cache()
    check_moe_model_grads(smi)
    launches = None
    for impl in TRAIN_MOE_IMPLS:
        gc.collect()
        torch.cuda.empty_cache()
        r = train_full_depth(smi, QWEN3, layers=QWEN3_TRAIN_LAYERS,
                             moe_impl=impl)
        MOE_TRAIN_RUNS[impl] = dict(r, layers=QWEN3_TRAIN_LAYERS)
        busy = "not measured" if r["busy"] is None else f"{r['busy']:.1%}"
        log(f"{QWEN3} training cell ({QWEN3_TRAIN_LAYERS} of 48 layers, "
            f"moe_impl={impl}): step {r['step_ms']:.1f} ms, "
            f"{r['tok_s']:.0f} tok/s, peak {r['peak_gib']:.2f} GiB, busy "
            f"{busy}, launches in {TRAIN_STEPS} steps {r['launches']} "
            f"[{smi}]")
        launches = launches or r["launches"]
    log(f"{QWEN3} training phases: {time.perf_counter() - t0:.1f} s")
    return launches


def train_phases(smi: str) -> dict:
    """The training slice's main path: the trainer CLI, the full-width
    gradient check and the full-depth run of gemma-2b, then those of the
    SSM and hybrid families (mamba2-780m's gradient check against the SSD
    on its plain version, the CLI with ``--arch mamba2-780m``, and both
    models at full depth, each freed before the next), then the MoE family
    (``moe_train_phases``).  Returns the launch counts of gemma-2b's and
    mamba2-780m's full-depth runs."""
    gc.collect()
    torch.cuda.empty_cache()
    run_trainer(smi)
    check_train_grads(smi)
    gc.collect()
    torch.cuda.empty_cache()
    launches = dict(train_full_depth(smi)["launches"])
    check_train_grads(smi, "mamba2-780m", plain_ssd,
                      SSM_TRAIN_BATCH["mamba2-780m"])
    gc.collect()
    torch.cuda.empty_cache()
    run_ssm_trainer(smi)
    for aid, batch in SSM_TRAIN_BATCH.items():
        r = train_full_depth(smi, aid, batch)
        busy = "not measured" if r["busy"] is None else f"{r['busy']:.1%}"
        log(f"{aid} training cell: step {r['step_ms']:.1f} ms, "
            f"{r['tok_s']:.0f} tok/s, peak {r['peak_gib']:.2f} GiB, busy "
            f"{busy}, launches in {TRAIN_STEPS} steps {r['launches']} "
            f"[{smi}]")
        if aid == "mamba2-780m":
            launches["ssd_intra_chunk_bwd"] = \
                r["launches"]["ssd_intra_chunk_bwd"]
    moe = moe_train_phases(smi)
    log(f"flash backward launches in {TRAIN_STEPS} train steps: gemma-2b "
        f"{launches['flash_attention_bwd']} (the kernels line), {QWEN3} "
        f"({QWEN3_TRAIN_LAYERS} layers) {moe['flash_attention_bwd']}")
    return launches


# --------------------------------------------------------------------------
# Multi-GPU: the sharded paths over NCCL at world 1
# --------------------------------------------------------------------------

# the GPU planner's training layouts at world 1 on a (1, 1) ("data",
# "model") mesh; the MoE ones also name their lowering.  The tensor-parallel
# ones (``dp_tp*``) run every crossing's code over groups of one rank: no
# activation crosses (a split of width 1 is no split), so they measure the
# DTensor and host cost
WORLD_ONE = MeshDesc(("data", "model"), (1, 1))
DENSE_LAYOUTS = ("P1_pure_dp", "fsdp_all", "dp_tp", "dp_tp_fsdp")
EP_LAYOUTS = (("dp_sp_fsdp_ep", "ep_a2a"), ("dp_sp_fsdp_ep_q8", "ep_a2a_q8"),
              ("dp_tp_ep", "ep_a2a"), ("dp_tp_ep_q8", "ep_a2a_q8"))
_SP_EP = dict(batch_axes=("data",), seq_axes=("model",),
              fsdp_axes=("data", "model"))
_TP = dict(batch_axes=("data",), tp_axes=("model",))
# each layout's axes ("unsharded": none, for ``make_train_step``)
LAYOUT_AXES = {"unsharded": dict(batch_axes=()),
               "P1_pure_dp": dict(batch_axes=("data", "model")),
               "fsdp_all": dict(batch_axes=("data", "model"),
                                fsdp_axes=("data", "model")),
               "dp_sp_fsdp_ep": _SP_EP, "dp_sp_fsdp_ep_q8": _SP_EP,
               "dp_tp": _TP, "dp_tp_ep": _TP, "dp_tp_ep_q8": _TP,
               "dp_tp_fsdp": dict(_TP, fsdp_axes=("data",))}
# qwen3-moe-30b-a3b's sharded steps at the MoE training cells' depth
QWEN3_SHARDED_LAYERS = QWEN3_TRAIN_LAYERS
# one full-width qwen3 MoE layer through the all-to-all path: B x T tokens
MOE_A2A_BT = (2, 1024)
# the pipeline against the flat stack: gemma-2b at full width, 2 layers
PIPE_LAYERS, PIPE_MICRO = 2, 2
# tests/test_distributed.py's tolerances for a sharded step against the
# unsharded one, and for the pipeline against the flat stack
STEP_LOSS_RTOL, STEP_PARAM_ATOL, PIPE_TOL = 2e-3, 3e-3, 3e-2
# flash at one rank's share of qwen3's training step under an 8-way
# sequence split: (b, tq, tk, hq, hkv, d) and the queries' offsets (the
# first and the last rank)
CP_SHAPE, CP_OFFSETS = (2, 128, 1024, 32, 4, 128), (0, 896)
# the dry-run's host lines: train_4k on both GPU meshes, each mesh's archs
# in two host processes of about equal trace time (mistral-large-123b and
# qwen3-moe-30b-a3b take 2-2.5 minutes each, with the rest beside them)
DRYRUN_SHAPE = "train_4k"
DRYRUN_SPLIT = (("mistral-large-123b", "mamba2-780m", "hymba-1.5b", "gemma-2b",
                 "whisper-tiny", "gemma3-1b"),
                ("qwen3-moe-30b-a3b", "mixtral-8x7b", "llama-3.2-vision-11b",
                 "minicpm-2b"))
# the dry-run's tensor-parallel training cells: ``DRYRUN_SHAPE`` of every
# arch under a forced ``dp_tp`` on GPU_NODE, and ``dp_tp_ep`` for the MoE
# archs, in four host processes of about equal trace time (alone on the
# card's host: 323-354 s each but gemma-2b's group, 217 s; the plans
# accumulate up to 8 microbatches, each traced)
DRYRUN_TP_SPLIT = (
    (("mamba2-780m", "dp_tp"), ("mistral-large-123b", "dp_tp")),
    (("hymba-1.5b", "dp_tp"), ("qwen3-moe-30b-a3b", "dp_tp"),
     ("whisper-tiny", "dp_tp"), ("gemma3-1b", "dp_tp")),
    (("qwen3-moe-30b-a3b", "dp_tp_ep"), ("mixtral-8x7b", "dp_tp"),
     ("mixtral-8x7b", "dp_tp_ep")),
    (("gemma-2b", "dp_tp"), ("llama-3.2-vision-11b", "dp_tp"),
     ("minicpm-2b", "dp_tp")))
# the dry-run's serving cells on GPU_NODE, in two host processes:
# decode_32k of every arch (tensor-parallel in every plan) and
# mistral-large-123b's prefill_32k (``dp_tp``)
DRYRUN_SERVE_SPLIT = (
    (("mistral-large-123b", "decode_32k"), ("gemma-2b", "decode_32k"),
     ("gemma3-1b", "decode_32k"), ("whisper-tiny", "decode_32k"),
     ("llama-3.2-vision-11b", "decode_32k")),
    (("mistral-large-123b", "prefill_32k"), ("qwen3-moe-30b-a3b",
                                             "decode_32k"),
     ("mixtral-8x7b", "decode_32k"), ("minicpm-2b", "decode_32k"),
     ("mamba2-780m", "decode_32k"), ("hymba-1.5b", "decode_32k")))


def world_one_plan(layout: str, moe_impl: str = "dense",
                   mesh: MeshDesc = WORLD_ONE) -> ShardingPlan:
    """``layout``'s axes (``LAYOUT_AXES``) on ``mesh``, remat on, one
    microbatch."""
    axes = {"tp_axes": (), **LAYOUT_AXES[layout]}
    return ShardingPlan(arch="smoke", shape="train", mesh=mesh,
                        global_mode="data", local_layout=layout,
                        moe_impl=moe_impl, **axes)


@contextlib.contextmanager
def world_one(backend: str = "nccl", device_type: str = "cuda"):
    """A process group of one rank (a ``FileStore`` in a temporary
    directory) and the (1, 1) ("data", "model") mesh over it."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_smoke_mesh

    tmp = tempfile.mkdtemp()
    kw = {"device_id": torch.device("cuda", 0)} if backend == "nccl" else {}
    dist.init_process_group(backend, store=dist.FileStore(
        os.path.join(tmp, "store"), 1), rank=0, world_size=1, **kw)
    try:
        yield make_smoke_mesh((1, 1), ("data", "model"),
                              device_type=device_type)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def _rel(g, w) -> float:
    return float((g.float() - w.float()).norm() / w.float().norm())


def check_moe_a2a(mesh, smi: str) -> None:
    """One full-width qwen3 MoE layer over ``MOE_A2A_BT`` tokens through the
    multi-rank path of ``moe_ep_a2a`` (dispatch buffers, the all-to-alls
    over the EP group, the combine) against the in-process step, in bf16
    and with the int8 payload: the output at the bf16 TOL, the gradients of
    a random cotangent (router, w_gate, w_up, w_down, x) at
    ``MOE_LAYER_TOL``; then the dispatch all-to-all's device time."""
    from repro_torch.sharding import comm
    from repro_torch.sharding import ctx as shard_ctx
    from repro_torch.sharding.specs import Spec
    cfg = get_config(QWEN3)
    b, t = MOE_A2A_BT
    p = moe_layer(cfg, 2300)
    gen = torch.Generator(device="cuda").manual_seed(2301)
    x = _randn((b, t, cfg.d_model), torch.bfloat16, gen)
    cot = _randn((b, t, cfg.d_model), torch.float32, gen)
    act = Spec("data", "model", None)

    def run(a2a, sharded):
        ps = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        xs = x.detach().requires_grad_(True)
        with contextlib.ExitStack() as st:
            if sharded:
                st.enter_context(shard_ctx.plan_specs(act, None, mesh=mesh,
                                                      ep_axis="model"))
            y = moe_ep.moe_ep_a2a(cfg, ps, xs, a2a_dtype=a2a)
        grads = torch.autograd.grad((y.float() * cot).sum(),
                                    [*ps.values(), xs])
        return y.detach(), grads

    for a2a in moe_ep.A2A_DTYPES:
        y0, g0 = run(a2a, False)
        y1, g1 = run(a2a, True)
        err = _check(f"moe a2a multi-rank vs in-process ({a2a})", y1, y0,
                     TOL[torch.bfloat16])
        errs = [_rel(g, w) for g, w in zip(g1, g0)]
        if not all(np.isfinite(errs)) or max(errs) > MOE_LAYER_TOL:
            raise AssertionError(f"moe a2a {a2a} gradients (router, w_gate, "
                                 f"w_up, w_down, x): {errs}")
        log(f"{QWEN3} MoE layer B={b} T={t} through the all-to-all over "
            f"NCCL at world 1, payload {a2a}: output max|err| {err:.3e} "
            f"against the in-process step, gradients' relative-norm errors "
            f"{[f'{e:.2e}' for e in errs]} (tol {MOE_LAYER_TOL}) [{smi}]")
    cap = moe_ep._round_up(max(int(b * t * cfg.moe.top_k
                                   * cfg.moe.capacity_factor), 8), 8)
    group = mesh.get_group("model")
    send = _randn((1, cap, cfg.d_model), torch.bfloat16, gen)
    q, s = moe_ep._quant_i8(send)
    ms = time_ms(lambda: comm.all_to_all_autograd(send, group), None)
    ms8 = time_ms(lambda: (comm.all_to_all(q, group),
                           comm.all_to_all(s, group)), None)
    log(f"{QWEN3} dispatch all-to-all over NCCL at world 1, (1, {cap}, "
        f"{cfg.d_model}): bf16 {ms:.4f} ms ({send.numel() * 2 / 1e6:.1f} "
        f"MB), int8 payload and scales {ms8:.4f} ms [{smi}]")


def _dryrun_proc(code: str) -> subprocess.Popen:
    """A host process of the dry-run (a fake process group of its own; one
    thread: its tensors are abstract)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = str(Path(__file__).resolve().parent / "src")
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


_DRYRUN_WORLD_ONE = """
import json, logging
logging.getLogger("torch.distributed.tensor._redistribute").setLevel(40)
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.models import ShapeConfig, build_model
from repro_torch.sharding import MeshDesc, ShardingPlan
from repro_torch.kernels import ops
ops.set_backend("blocked")
model = build_model(get_config("gemma-2b"))
shape = ShapeConfig("train_smoke", {t}, {b}, "train")
desc = MeshDesc(("data", "model"), (1, 1))
for layout, axes in {layouts}:
    plan = ShardingPlan(arch="smoke", shape="train", mesh=desc,
                        global_mode="data", local_layout=layout, **axes)
    with dryrun.fake_world(desc) as mesh:
        rec = dryrun.trace_cell(model, shape, plan, mesh)
    print(json.dumps(dict(layout=layout, **rec)), flush=True)
"""

_DRYRUN_TP_WORLD_ONE = """
import json, logging
logging.getLogger("torch.distributed.tensor").setLevel(40)
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.models import ShapeConfig, build_model
from repro_torch.sharding import MeshDesc, ShardingPlan
from repro_torch.kernels import ops
ops.set_backend("blocked")
model = build_model(get_config("gemma-2b"))
shape = ShapeConfig("decode_tp", {s}, {b}, "decode")
desc = MeshDesc(("data", "model"), (1, 1))
plan = ShardingPlan(arch="smoke", shape="serve", mesh=desc,
                    global_mode="data", local_layout="dp_tp",
                    batch_axes=("data",), tp_axes=("model",))
with dryrun.fake_world(desc) as mesh:
    rec = dryrun.trace_cell(model, shape, plan, mesh)
print(json.dumps(rec), flush=True)
"""

_DRYRUN_SERVE = """
import json, logging
logging.getLogger("torch.distributed.tensor").setLevel(40)
from repro_torch.launch import dryrun
for arch, shape, *layout in {cells!r}:
    rec = dryrun.run_cell(arch, shape, False, out_dir={out!r},
                          force_layout=layout[0] if layout else None)
    print(json.dumps(rec, default=list), flush=True)
"""

_DRYRUN_TP_CELLS = """
import json, logging, os
os.nice(19)
logging.getLogger("torch.distributed.tensor").setLevel(40)
from repro_torch.launch import dryrun
for arch, layout in {cells!r}:
    rec = dryrun.run_cell(arch, "{shape}", False, force_layout=layout,
                          out_dir={out!r})
    print(json.dumps(rec, default=list), flush=True)
"""

_DRYRUN_CELLS = """
import json, logging
logging.getLogger("torch.distributed.tensor._redistribute").setLevel(40)
from repro_torch.launch import dryrun
for arch in {archs!r}:
    rec = dryrun.run_cell(arch, "{shape}", {multi}, out_dir={out!r})
    print(json.dumps(rec, default=list), flush=True)
"""


def start_dryruns() -> dict:
    """The dry-run's host processes, to run beside the card's work:
    gemma-2b's two world-1 cells of
    ``sharded_gemma`` (at B x T = ``TRAIN_B`` x ``TRAIN_T``), and
    ``DRYRUN_SHAPE`` for every arch on each GPU mesh (``DRYRUN_SPLIT``)."""
    layouts = [(lay, {"tp_axes": (), **LAYOUT_AXES[lay]})
               for lay in DENSE_LAYOUTS]
    out = str(Path(__file__).resolve().parent / "artifacts" / "dryrun_gpu")
    return {"world_one": _dryrun_proc(_DRYRUN_WORLD_ONE.format(
                t=TRAIN_T, b=TRAIN_B, layouts=layouts)),

            **{f"cells_{m}_{i}": _dryrun_proc(_DRYRUN_CELLS.format(
                archs=archs, shape=DRYRUN_SHAPE, multi=m, out=out))
               for m in (False, True)
               for i, archs in enumerate(DRYRUN_SPLIT)},
            "t0": time.perf_counter()}


def start_serving_dryruns() -> dict:
    """The dry-run's serving processes: gemma-2b's world-1 ``dp_tp`` decode
    cell of ``tp_world_one`` (B x S = ``TP_B`` x ``TP_S``), the cells of
    ``DRYRUN_SERVE_SPLIT`` and, in a third process, ``DRYRUN_SP_SERVE``
    (the layouts beside a sequence split or over two axes).  Started after the tensor-parallel phase, beside
    the device-timed kernel phase, so that they load the host neither
    beside the training dry-runs nor beside host-bound steps."""
    out = str(Path(__file__).resolve().parent / "artifacts" / "dryrun_gpu")
    return {"tp_world_one": _dryrun_proc(_DRYRUN_TP_WORLD_ONE.format(
                s=TP_S, b=TP_B)),
            **{f"serve_{i}": _dryrun_proc(_DRYRUN_SERVE.format(
                cells=cells, out=out))
               for i, cells in enumerate(DRYRUN_SERVE_SPLIT
                                         + (DRYRUN_SP_SERVE,))}}


def start_tp_train_dryruns() -> dict:
    """The dry-run's tensor-parallel training cells (``DRYRUN_TP_SPLIT``),
    started right after the build: their traces take about 1250 s of host
    time in all, so they run beside every phase, at the lowest scheduling
    priority (``os.nice(19)``) so that the card's host-bound paths keep
    their cores."""
    out = str(Path(__file__).resolve().parent / "artifacts" / "dryrun_gpu")
    return {f"tp_train_{i}": _dryrun_proc(_DRYRUN_TP_CELLS.format(
                cells=cells, shape=DRYRUN_SHAPE, out=out))
            for i, cells in enumerate(DRYRUN_TP_SPLIT)}


def stop_dryruns(procs: dict) -> None:
    """Ends the dry-run's processes that are still running (a failure
    elsewhere)."""
    for p in procs.values():
        if isinstance(p, subprocess.Popen) and p.poll() is None:
            p.kill()
            p.communicate()


def _finish(proc: subprocess.Popen, what: str, timeout: float) -> list:
    """The JSON lines a dry-run process printed; raises if it failed."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"dry-run {what}: still running after "
                             f"{timeout} s")
    if proc.returncode != 0:
        raise AssertionError(f"dry-run {what} failed: {err[-2000:]}")
    return [json.loads(x) for x in out.splitlines() if x.startswith("{")]


def _train_run(step, state: list, batches, want: dict, tag: str,
               at_end=None) -> dict:
    """``step`` over ``batches`` from ``state`` = [params, opt_state], which
    it empties (so that the caller holds no step's parameters): exact
    kernel calls per step, the losses, step times and the peak memory;
    ``at_end(params)`` on the final parameters (its result ``end``); then
    one more step under the profiler for the busy share."""
    params, opt = state
    state.clear()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for tb in batches:
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, tb)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if _counts() != want:
            raise AssertionError(f"{tag} step launches {_counts()}, "
                                 f"expected {want}")
        losses.append(float(metrics["loss"]))
    if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        raise AssertionError(f"{tag} losses {losses}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    end = None if at_end is None else at_end(params)
    state = [params, opt]
    del params, opt

    def one_step():
        state[0], state[1], _ = step(state[0], state[1], batches[0])

    r = _profile(one_step, 1)
    del state
    return dict(losses=losses, step_ms=1e3 * statistics.median(times),
                times=times, peak_gib=peak, end=end,
                busy=None if r is None else r["device_ms"] / r["wall_ms"])


def _run_line(tag: str, r: dict, smi: str) -> str:
    busy = "not measured" if r["busy"] is None else f"{r['busy']:.1%}"
    return (f"{tag}: {len(r['losses'])} steps, median step "
            f"{r['step_ms']:.1f} ms (steps "
            f"{[round(1e3 * x, 1) for x in r['times']]}), losses "
            f"{[round(x, 5) for x in r['losses']]}, peak {r['peak_gib']:.2f} "
            f"GiB, busy {busy} [{smi}]")


def _compare(tag: str, got: dict, want: dict) -> str:
    """Losses at ``STEP_LOSS_RTOL``; the final parameters' largest error
    (``got["end"]``, where measured) at ``STEP_PARAM_ATOL``."""
    lerr = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                   want["losses"]))
    if lerr > STEP_LOSS_RTOL:
        raise AssertionError(f"{tag} losses {got['losses']} against "
                             f"{want['losses']}")
    out = f"loss rel err {lerr:.2e} (rtol {STEP_LOSS_RTOL})"
    if got.get("end") is not None:
        if got["end"] > STEP_PARAM_ATOL:
            raise AssertionError(f"{tag} parameters part by "
                                 f"{got['end']:.3e}")
        out += (f", parameters max|err| {got['end']:.3e} (atol "
                f"{STEP_PARAM_ATOL})")
    return out


def _param_err(params, want: list) -> float:
    """The largest error of a world-1 DTensor tree against parameters kept
    on the host."""
    return max(float((g.to_local().float() - w.to(g.device).float())
                     .abs().max())
               for g, w in zip(train_tree.leaves(params), want))


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def sharded_gemma(mesh, smi: str) -> dict:
    """gemma-2b at full width and depth, ``TRAIN_STEPS`` steps of the
    unsharded ``make_train_step``, then of the sharded step under each of
    ``DENSE_LAYOUTS`` at world 1, all from the same initialisation and
    batches: exactly 36 forward and 18 backward flash calls a step, losses
    and final parameters against the unsharded run's.  Returns each run's
    numbers by layout ("unsharded" too)."""
    from repro_torch.sharding import specs, spmd
    cfg = get_config("gemma-2b")
    model = build_model(cfg)
    want = _step_launches(cfg)
    data = iter(SyntheticDataset(cfg, TRAIN_B, TRAIN_T, seed=2))
    batches = [{k: torch.as_tensor(v, device="cuda") for k, v in
                next(data).items()} for _ in range(TRAIN_STEPS)]
    oc = train_optim.OptConfig()
    runs = {}

    def init():
        return model.init(torch.Generator(device="cuda").manual_seed(0),
                          device="cuda")

    params = init()
    state = [params, train_optim.init(params)]
    del params
    step = train_loop.make_train_step(model, oc, world_one_plan(
        "unsharded"))
    r = _train_run(step, state, batches, want, "gemma-2b unsharded",
                   lambda p: [x.detach().cpu() for x in train_tree.leaves(p)])
    ref_params = r.pop("end")
    runs["unsharded"] = r
    log(_run_line("gemma-2b unsharded make_train_step", r, smi))
    del step
    _free()
    for layout in DENSE_LAYOUTS:
        plan = world_one_plan(layout)
        params = specs.param_shardings(mesh, init(), plan)
        state = [params, train_optim.init(params)]
        del params
        step = spmd.make_sharded_train_step(model, oc, plan, mesh)
        r = _train_run(step, state, batches, want, f"gemma-2b {layout}",
                       lambda p: _param_err(p, ref_params))
        cmp = _compare(f"gemma-2b {layout}", r, runs["unsharded"])
        runs[layout] = r
        log(_run_line(f"gemma-2b sharded step {layout} (NCCL, world 1)", r,
                      smi) + f"; against the unsharded step: {cmp}; "
            f"launches per step {want}")
        del step
        _free()
    return runs


def sharded_qwen3(mesh, smi: str) -> None:
    """qwen3-moe-30b-a3b at full width and ``QWEN3_SHARDED_LAYERS`` layers,
    ``TRAIN_STEPS`` sharded steps under each of ``EP_LAYOUTS`` at world 1
    (the sequence over "model", the experts behind the all-to-all over
    NCCL), against the in-process steps of the same lowering at the same
    depth from ``moe_train_phases`` (same initialisation and batches)."""
    from repro_torch.sharding import specs, spmd
    cfg = dataclasses.replace(get_config(QWEN3),
                              n_layers=QWEN3_SHARDED_LAYERS)
    model = build_model(cfg)
    want = _step_launches(cfg)
    data = iter(SyntheticDataset(cfg, TRAIN_B, TRAIN_T, seed=2))
    batches = [{k: torch.as_tensor(v, device="cuda") for k, v in
                next(data).items()} for _ in range(TRAIN_STEPS)]
    for layout, impl in EP_LAYOUTS:
        inproc = MOE_TRAIN_RUNS.get(impl)
        if inproc is None or inproc["layers"] != QWEN3_SHARDED_LAYERS:
            raise AssertionError(f"no in-process {impl} run at "
                                 f"{QWEN3_SHARDED_LAYERS} layers")
        plan = world_one_plan(layout, impl)
        params = specs.param_shardings(mesh, model.init(
            torch.Generator(device="cuda").manual_seed(0), device="cuda"),
            plan)
        state = [params, train_optim.init(params)]
        del params
        step = spmd.make_sharded_train_step(model, train_optim.OptConfig(),
                                            plan, mesh)
        r = _train_run(step, state, batches, want, f"{QWEN3} {layout}")
        cmp = _compare(f"{QWEN3} {layout}", r, inproc)
        busy = ("not measured" if inproc["busy"] is None
                else f"{inproc['busy']:.1%}")
        log(_run_line(f"{QWEN3} ({QWEN3_SHARDED_LAYERS} of 48 layers) "
                      f"sharded step {layout} (NCCL, world 1)", r, smi)
            + f"; against the in-process {impl} step (median "
            f"{inproc['step_ms']:.1f} ms, peak {inproc['peak_gib']:.2f} GiB, "
            f"busy {busy}): {cmp}; launches per step {want}")
        del step, r
        _free()


def check_pipeline(smi: str) -> None:
    """The GPipe pipeline at world 1 (one stage over a ("pod",) mesh of 1,
    ``PIPE_MICRO`` microbatches) against the flat stack, gemma-2b at full
    width and ``PIPE_LAYERS`` layers: the hidden states at 3e-2, and one
    pipelined train step's loss against ``make_train_step``'s."""
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import transformer
    from repro_torch.sharding import pipeline
    cfg = dataclasses.replace(get_config("gemma-2b"), n_layers=PIPE_LAYERS)
    model = build_model(cfg)
    pmesh = make_smoke_mesh((1,), ("pod",))
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    tb = _train_batch(cfg, 3)
    with torch.no_grad():
        flat, _ = transformer.forward(cfg, params, tb["tokens"],
                                      mode="train", return_hidden=True)
        staged = pipeline.stage_param_shardings(
            pmesh, pipeline.stage_params(cfg, params, 1))
        _zero_counts()
        hidden = pipeline.pipeline_hidden(cfg, staged, tb["tokens"],
                                          mesh=pmesh, n_stages=1,
                                          microbatches=PIPE_MICRO)
        calls = _counts()["flash_attention"]
    err = _check("pipeline vs flat stack", hidden, flat, PIPE_TOL)
    plan = ShardingPlan(arch=cfg.name, shape="train",
                        mesh=MeshDesc(("pod",), (1,)), global_mode="model",
                        local_layout="pipeline", batch_axes=(), tp_axes=(),
                        pipeline_stages=1, microbatches=PIPE_MICRO,
                        remat=False)
    oc = train_optim.OptConfig()
    step = pipeline.make_pipeline_train_step(model, oc, plan, pmesh)
    _, _, m1 = step(staged, train_optim.init(staged), tb)
    one = train_loop.make_train_step(model, oc, dataclasses.replace(
        plan, microbatches=1))
    _, _, m0 = one(params, train_optim.init(params), tb)
    lerr = abs(float(m1["loss"]) - float(m0["loss"])) / abs(float(m0["loss"]))
    if lerr > STEP_LOSS_RTOL:
        raise AssertionError(f"pipeline step loss {float(m1['loss'])} "
                             f"against {float(m0['loss'])}")
    log(f"gemma-2b pipeline at world 1 ({PIPE_LAYERS} layers, full width, "
        f"{PIPE_MICRO} microbatches of B={TRAIN_B // PIPE_MICRO} T={TRAIN_T}"
        f"): hidden max|err| {err:.3e} against the flat stack (tol "
        f"{PIPE_TOL}); {calls} flash calls; one train step's loss "
        f"{float(m1['loss']):.5f} against {float(m0['loss']):.5f} (rel "
        f"{lerr:.2e}) [{smi}]")
    del params, staged, step
    _free()


def check_context_parallel_flash(smi: str) -> None:
    """Flash forward and backward at one rank's share of qwen3's training
    step under an 8-way sequence split (``CP_SHAPE``: its 128 queries
    against the whole 1024 keys, causal, offset by ``CP_OFFSETS``), against
    the plain versions (LSE, output, dQ/dK/dV), and timed beside SDPA."""
    b, tq, tk, hq, hkv, d = CP_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(2400)
    q = _randn((b, tq, hq, d), torch.bfloat16, gen)
    k = _randn((b, tk, hkv, d), torch.bfloat16, gen)
    v = _randn((b, tk, hkv, d), torch.bfloat16, gen)
    do = _randn((b, tq, hq, d), torch.bfloat16, gen)
    for off in CP_OFFSETS:
        kw = dict(causal=True, q_offset=off)
        o, lse = fa.flash_attention_fwd(q, k, v, with_lse=True, **kw)
        want_o, want_lse = ref.attention_lse_naive(q, k, v, **kw)
        err = max(_check(f"flash cp out q_offset={off}", o, want_o,
                         TOL[torch.bfloat16]),
                  _check(f"flash cp lse q_offset={off}", lse, want_lse,
                         TOL[torch.bfloat16]))
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        want = ref.attention_bwd_naive(q, k, v, o, lse, do, **kw)
        berr = max(_check(f"flash cp bwd q_offset={off} d{n}", g, w,
                          BWD_TOL[torch.bfloat16])
                   for n, g, w in zip("qkv", got, want))
        pairs = b * fa.visible_pairs(tq, tk, causal=True, window=None,
                                     q_offset=off)
        qpos = off + torch.arange(tq, device="cuda")
        mask = (torch.arange(tk, device="cuda")[None, :]
                <= qpos[:, None])[None, None]
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                      for x in (q, k, v))
        sd = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
        dot = do.transpose(1, 2).contiguous()
        f_bound = _bound(4.0 * hq * d * pairs,
                         2.0 * (2 * q.numel() + k.numel() + v.numel()))
        b_bound = _bound(10.0 * hq * d * pairs,
                         2.0 * (4 * q.numel() + 4 * k.numel())
                         + 4.0 * lse.numel())
        fwd = _times(lambda: fa.flash_attention_fwd(q, k, v, **kw),
                     lambda: ref.attention_naive(q, k, v, **kw),
                     lambda: _sdpa(qt.detach(), kt.detach(), vt.detach(),
                                   mask), None)
        bwd = _times(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                    **kw),
                     lambda: ref.attention_bwd_naive(q, k, v, o, lse, do,
                                                     **kw),
                     lambda: torch.autograd.grad(sd, (qt, kt, vt), dot,
                                                 retain_graph=True), None)
        for name, r, (bound, by), e in (("forward", fwd, f_bound, err),
                                        ("backward", bwd, b_bound, berr)):
            r.update(bound_ms=bound, bound_by=by)
            log(f"flash {name} at the context-parallel shape (b, tq, tk, "
                f"hq, hkv, d) = {CP_SHAPE}, q_offset {off}: max|err| "
                f"{e:.3e}; kernel {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, "
                f"bound {bound:.5f} ms ({by}) [{smi}]")


def _cell_line(rec: dict) -> str:
    """A dry-run cell's line: per-GPU peak and the planner's resident GiB,
    FLOPs, collective bytes by kind and the planner's collective ms."""
    if rec["status"] != "ok":
        return (f"dry-run {rec['arch']:22s} {rec['shape']} {rec['mesh']} "
                f"{rec['status']}: {rec.get('reason', '')}")
    pred = rec["plan"]["predicted"]
    coll = rec["collectives"]
    return (f"dry-run {rec['arch']:22s} {rec['shape']} {rec['mesh']}"
            f" {rec['plan']['layout']:16s} "
            f"{rec['memory']['peak_per_device'] / 2**30:.2f} GiB/GPU"
            f" (planner {pred['resident'] / 2**30:.2f}), argument "
            f"{rec['memory']['argument_bytes'] / 1e9:.2f} GB, "
            f"{rec['cost']['flops']:.3e} FLOPs, collectives GB "
            + " ".join(f"{k} {v / 1e9:.3f}" for k, v in coll.items())
            + f" (planner {1e3 * pred['collective']:.1f} ms), "
            f"traced in {rec['seconds']['trace']:.1f} s")


def dryrun_lines(procs: dict, world_one_runs: dict, tp_one: dict,
                 smi: str) -> None:
    """The dry-run's records: gemma-2b's world-1 training cells' (one per
    ``DENSE_LAYOUTS``) and its world-1 ``dp_tp`` decode cell's predicted
    peak beside the measured one (a gap above 20% is logged, not failed),
    then one line per ``DRYRUN_SHAPE`` cell on each GPU mesh, per
    tensor-parallel training cell and per serving cell beside the
    planner's predicted resident GiB and collective ms; a serving or
    tensor-parallel training cell must trace ``ok``."""
    t0 = time.perf_counter()
    for rec in _finish(procs["tp_world_one"], "tp world-1 cell", 600):
        got = tp_one["peak_gib"]
        pred = rec["memory"]["peak_per_device"] / 2**30
        gap = (pred - got) / got
        log(f"dry-run gemma-2b dp_tp decode at world 1 (B={TP_B} S={TP_S}):"
            f" peak_per_device {pred:.2f} GiB against max_memory_allocated "
            f"{got:.2f} GiB measured over the decode steps ({gap:+.1%}"
            f"{', above 20%' if abs(gap) > 0.2 else ''}); argument "
            f"{rec['memory']['argument_bytes'] / 2**30:.2f} GiB, "
            f"{rec['cost']['flops']:.3e} FLOPs [{smi}]")
    for i in range(len(DRYRUN_SERVE_SPLIT) + 1):
        recs = _finish(procs[f"serve_{i}"], "serving cells", 900)
        if i == len(DRYRUN_SERVE_SPLIT) and [
                (r["arch"], r["shape"], r["plan"]["layout"]) for r in recs
                ] != list(DRYRUN_SP_SERVE):
            raise AssertionError("the dry-run's sequence-split and two-axis "
                                 f"cells are not {DRYRUN_SP_SERVE}")
        for rec in recs:
            log(_cell_line(rec))
            if rec["status"] != "ok":
                raise AssertionError(f"dry-run {rec['arch']} {rec['shape']}"
                                     f": {rec['status']}")
    for rec in _finish(procs["world_one"], "world-1 cells", 600):
        got = world_one_runs[rec["layout"]]["peak_gib"]
        pred = rec["memory"]["peak_per_device"] / 2**30
        gap = (pred - got) / got
        log(f"dry-run gemma-2b {rec['layout']} at world 1 (B={TRAIN_B} "
            f"T={TRAIN_T}): peak_per_device {pred:.2f} GiB against "
            f"max_memory_allocated {got:.2f} GiB measured ({gap:+.1%}"
            f"{', above 20%' if abs(gap) > 0.2 else ''}); argument "
            f"{rec['memory']['argument_bytes'] / 2**30:.2f} GiB, "
            f"{rec['cost']['flops']:.3e} FLOPs [{smi}]")
    tp_cells = sorted(c for cells in DRYRUN_TP_SPLIT for c in cells)
    moe = [a for a in ARCH_IDS if get_config(a).moe is not None]
    if tp_cells != sorted([(a, "dp_tp") for a in ARCH_IDS]
                          + [(a, "dp_tp_ep") for a in moe]):
        raise AssertionError(f"DRYRUN_TP_SPLIT is not every arch's dp_tp "
                             f"cell and the MoE archs' dp_tp_ep")
    for i in range(len(DRYRUN_TP_SPLIT)):
        for rec in _finish(procs[f"tp_train_{i}"], "tp training cells", 900):
            log(_cell_line(rec) + " [tp training]")
            if rec["status"] != "ok":
                raise AssertionError(f"dry-run {rec['arch']} {rec['shape']} "
                                     f"{rec['plan']['layout']}: "
                                     f"{rec['status']}")
    if sorted(a for s in DRYRUN_SPLIT for a in s) != sorted(ARCH_IDS):
        raise AssertionError(f"DRYRUN_SPLIT is not the archs {ARCH_IDS}")
    for m in (False, True):
        recs = [r for i in range(len(DRYRUN_SPLIT)) for r in _finish(
            procs[f"cells_{m}_{i}"], f"{DRYRUN_SHAPE} cells", 900)]
        if len(recs) != len(ARCH_IDS):
            raise AssertionError(f"dry-run gave {len(recs)} cells")
        for rec in recs:
            log(_cell_line(rec))
    log(f"dry-run: its processes done {time.perf_counter() - procs['t0']:.1f}"
        f" s after their start, {time.perf_counter() - t0:.1f} s waited "
        "for them here")


def multi_gpu_phase(smi: str) -> dict:
    """The multi-GPU slice at world 1 over NCCL: the MoE layer's all-to-all
    path, gemma-2b's sharded steps, qwen3's expert-parallel sharded steps,
    the pipeline, flash at the context-parallel shape.  Returns gemma-2b's
    runs by layout (their peaks are held to the dry-run's,
    ``dryrun_lines``)."""
    import logging
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    _free()
    t0 = time.perf_counter()
    with world_one() as mesh:
        log(f"multi-GPU phase: NCCL process group of 1 rank, mesh "
            f"{mesh.mesh_dim_names} {tuple(mesh.shape)}")
        check_moe_a2a(mesh, smi)
        _free()
        runs = sharded_gemma(mesh, smi)
        sharded_qwen3(mesh, smi)
        check_pipeline(smi)
    check_context_parallel_flash(smi)
    log(f"multi-GPU phase: {time.perf_counter() - t0:.1f} s")
    return runs


# --------------------------------------------------------------------------
# Tensor-parallel serving
# --------------------------------------------------------------------------

# the decode kernel at one rank's share of decode_32k: B sequences over a
# cache of S rows cut into TP_SHARES shares, each a rank's under an 8-way
# sequence split, with gemma-2b's heads (8 over 1, head_dim 256) and with
# gemma3-1b's (4 over 1) at its window of 512
TP_SHARES, TP_DECODE = 8, (128, 32768)
TP_HEADS = {"gemma-2b": ((HQ, HKV, HD), None),
            "gemma3-1b": ((4, 1, 256), 512)}
# gemma-2b at full width and depth through the sharded serving steps at
# world 1: a decode cache of TP_B x TP_S rows (9.66 GB, the bytes of one
# GPU's share of decode_32k), a prompt of TP_PROMPT tokens prefilled into
# it, TP_STEPS decode steps from lengths TP_S - TP_STEPS
TP_B, TP_S, TP_PROMPT, TP_STEPS = 16, 32768, 1024, 8
# the same at world 2 on the one card (two processes over gloo): full width,
# TP_W2_LAYERS layers, TP_W2_B sequences; gemma's one KV head puts the
# cache's sequence over "model", so the shares' results are merged
TP_W2_LAYERS, TP_W2_B = 2, 4
# logits of the sharded steps against the unsharded ones (world 1 runs the
# same arithmetic; world 2 adds bf16 partial sums and the merge), and the
# near-tie rule for greedy tokens (tests/test_torch_moe.py's)
TP_LOGITS_TOL = {1: TOL[torch.bfloat16], 2: 1e-1}
# merged shares against the whole-cache kernel and the plain versions, per
# (sequence, head) row: |got - want| / |want| over the row's D values.  The
# element-wise TOL is as large as a long row's values (std about
# sqrt(e / length)); per row, the plain merge of bf16 shares lies within
# this limit of the exact output, while a share's rows offset by one key or
# a share left out put rows outside it
# (tests/test_torch_decode_split.py::test_row_limit_separates_the_merge_from_its_faults)
TP_ROW_RTOL = 1e-2
TP_NEAR_TIE = 5e-2
# the combine kernel at the split counts the serving shapes give, all at
# Hq = 8: split_plan's count -> (B, Hkv, S) of a batch of 128 sequences, a
# GQA group of 2 at B = 4, gemma-2b's serving decode, one long sequence
COMBINE_SPLITS = {2: (128, 1, 256), 9: (4, 4, 1024), 32: (4, 1, 1024),
                  128: (1, 1, 4096)}
# the merge's ranks: worlds 1, 2 and 4 and the 8 shares of decode_32k
MERGE_RANKS = (1, 2, 4, 8)
# a row's log-sum-exp against the split version's, fp32 on both sides
# (scores near 1, so the LSE is log(length) + a few)
LSE_TOL = 1e-4


def tp_plan(mesh_shape) -> ShardingPlan:
    """``dp_tp`` on a ("data", "model") mesh of ``mesh_shape``."""
    return ShardingPlan(arch="smoke", shape="serve",
                        mesh=MeshDesc(("data", "model"), tuple(mesh_shape)),
                        global_mode="data", local_layout="dp_tp",
                        batch_axes=("data",), tp_axes=("model",))


def _tp_counts() -> dict:
    return {"flash_attention": fa.launches, "decode_attention": da.launches,
            "decode_attention_merge": da.merge_launches,
            "ssd_intra_chunk": ssd_scan.launches}


def _tp_zero() -> None:
    fa.launches = da.launches = da.merge_launches = ssd_scan.launches = 0


def _row_check(name, got, want, rtol) -> float:
    """Each (sequence, head) row of ``got`` (B, 1, H, D) within ``rtol`` of
    ``want``'s by relative norm; returns the worst row's."""
    torch.cuda.synchronize()
    g = got.float().flatten(0, -2)
    w = want.float().flatten(0, -2)
    rel = (g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)
    worst = rel.max().item()
    if not worst <= rtol:
        raise AssertionError(f"{name}: a row's |err|/|want| {worst:.3e} over "
                             f"{rtol}")
    return worst


def _shares(q, k, v, lens, window):
    """Every share of the cache through the kernel with its ``k_offset``
    and the LSE output; their (outputs, LSEs) stacked as a gather over the
    ranks gives them."""
    m = k.shape[1] // TP_SHARES
    outs, lses = [], []
    for r in range(TP_SHARES):
        o, lse = da.decode_attention(q, k[:, r * m:(r + 1) * m],
                                     v[:, r * m:(r + 1) * m], lens,
                                     window=window, k_offset=r * m,
                                     return_lse=True)
        outs.append(o[:, 0])
        lses.append(lse)
    return torch.stack(outs, 2), torch.stack(lses, 2)


def _empty_splits(lens, s: int, ns: int) -> int:
    """The (sequence, split) pairs with no valid key."""
    ranges = [da.split_range(int(n), s, None, ns, i)
              for n in lens for i in range(ns)]
    return sum(1 for lo, hi in ranges if hi <= lo)


def check_decode_combine() -> dict:
    """The decode call at each ``COMBINE_SPLITS`` shape, at each head dim
    of the kernels' dispatch list, in bf16 and fp32, with random lengths
    from a numpy seed (sequence 0 empty where B > 1; B = 1 under half the
    cache) that must leave some splits empty: the output against
    ``ref.decode_attention_split`` and ``ref.decode_attention_naive`` at
    ``TOL``, the LSE against the split version's at ``LSE_TOL`` and
    ``NEG_INF`` exactly for an empty sequence.  Returns the largest bf16
    error."""
    from repro_torch.kernels._wrap import HEAD_DIMS
    worst, n = 0.0, 0
    for ns, (b, hkv, s) in COMBINE_SPLITS.items():
        if da.split_plan(b, hkv, s, None) != ns:
            raise AssertionError(f"split_plan({b}, {hkv}, {s}) is "
                                 f"{da.split_plan(b, hkv, s, None)}, not {ns}")
        rng = np.random.default_rng(2700 + ns)
        lens = rng.integers(1, s + 1 if b > 1 else s // 2 + 1, b)
        if b > 1:
            lens[0] = 0
        empty = _empty_splits(lens, s, ns)
        if not empty:
            raise AssertionError(f"lengths {lens} leave no split of {ns} "
                                 "empty")
        for d in HEAD_DIMS:
            for dtype in TOL:
                args, lt = decode_case(b, s, 8, hkv, d, dtype, lens.tolist(),
                                       2700 + d)
                got, lse = da.decode_attention(*args, lt, return_lse=True)
                split, split_lse = ref.decode_attention_split(
                    *args, lt, return_lse=True)
                tag = f"decode combine {ns} splits (B={b}, Hkv={hkv}, S={s}) " \
                    f"D={d} {dtype}"
                err = max(_check(f"{tag} vs split", got, split, TOL[dtype]),
                          _check(f"{tag} vs naive", got,
                                 ref.decode_attention_naive(*args, lt),
                                 TOL[dtype]))
                _check(f"{tag} LSE", lse, split_lse, LSE_TOL, 1e-5)
                if b > 1 and not bool((lse[0] == ref.NEG_INF).all()):
                    raise AssertionError(f"{tag}: an empty sequence's LSE "
                                         "is not NEG_INF")
                if dtype == torch.bfloat16:
                    worst = max(worst, err)
                n += 1
        log(f"  decode combine, {ns} splits (B={b}, Hkv={hkv}, Hq=8, S={s}),"
            f" lengths {lens.tolist()[:6]}{'...' if b > 6 else ''} "
            f"({empty} of {b * ns} splits empty): the dispatch list's D "
            f"{HEAD_DIMS} in bf16 and fp32 within TOL of the split and naive"
            f" versions, LSE within {LSE_TOL}; combine_plan "
            f"{da.combine_plan(b * 8, ns, HEAD_DIMS[-1])} at D={HEAD_DIMS[-1]}")
    log(f"decode combine: {n} cases, largest bf16 max|err| {worst:.3e}")
    return worst


def check_merge_ranks() -> float:
    """``decode_attention.merge`` of each ``MERGE_RANKS`` count of ranks,
    at each head dim of the dispatch list, in bf16 and fp32, B=128, Hq=8:
    random outputs and LSEs (x 3), a quarter of the (row, rank) pairs empty
    (LSE ``NEG_INF``, output 0, as the decode call gives them) and every
    rank of sequence 0 empty; against ``ref.decode_merge`` at ``TOL`` and
    per row at ``TP_ROW_RTOL``, a row whose every rank is empty exactly 0.
    Returns the largest bf16 error."""
    from repro_torch.kernels._wrap import HEAD_DIMS
    b, hq = TP_DECODE[0], 8
    worst = 0.0
    for r in MERGE_RANKS:
        for d in HEAD_DIMS:
            for dtype in TOL:
                gen = torch.Generator(device="cuda").manual_seed(2800 + r * d)
                outs = _randn((b, hq, r, d), dtype, gen)
                lses = 3 * torch.randn((b, hq, r), generator=gen,
                                       device="cuda")
                empty = torch.rand((b, hq, r), generator=gen,
                                   device="cuda") < 0.25
                empty[0] = True
                lses[empty] = ref.NEG_INF
                outs[empty] = 0
                got = da.merge(outs, lses)
                want = ref.decode_merge(outs, lses)
                tag = f"merge of {r} ranks D={d} {dtype}"
                err = _check(tag, got, want, TOL[dtype])
                _row_check(tag, got, want, TP_ROW_RTOL)
                dead = empty.all(-1)
                if bool(got[:, 0][dead].any()):
                    raise AssertionError(f"{tag}: a row with every rank "
                                         "empty is not 0")
                if dtype == torch.bfloat16:
                    worst = max(worst, err)
        log(f"  merge of {r} ranks (B={b}, Hq={hq}): the dispatch list's D "
            f"{HEAD_DIMS} in bf16 and fp32 within TOL of ref.decode_merge, "
            f"each row within {TP_ROW_RTOL}, empty rows 0; combine_plan "
            f"{da.combine_plan(b * hq, r, HEAD_DIMS[-1], 2)} at "
            f"D={HEAD_DIMS[-1]} bf16")
    log(f"merge: {len(MERGE_RANKS) * len(HEAD_DIMS) * len(TOL)} cases, "
        f"largest bf16 max|err| {worst:.3e}")
    return worst


def check_decode_shares(smi: str) -> dict:
    """The decode kernel at each of ``TP_SHARES`` shares of a
    ``TP_DECODE`` cache (random lengths from a numpy seed), the shares
    merged by ``decode_attention.merge``, against the kernel on the whole
    cache and ``ref.decode_attention_naive`` at the bf16 ``TOL``, for each
    of ``TP_HEADS``; then one share's call at full lengths and the merge
    timed beside their bounds; before them the combine kernel's held cases
    at both its call sites
    (``check_decode_combine``, ``check_merge_ranks``).  Returns the merge's
    record (its kernel line), the share's and the held cases' largest bf16
    errors."""
    b, s = TP_DECODE
    m = s // TP_SHARES
    tol = TOL[torch.bfloat16]
    out: dict = {"combine": check_decode_combine(),
                 "merge_ranks": check_merge_ranks()}
    for seed, (aid, ((hq, hkv, d), window)) in enumerate(TP_HEADS.items()):
        gen = torch.Generator(device="cuda").manual_seed(2500 + seed)
        q = _randn((b, 1, hq, d), torch.bfloat16, gen)
        k = _randn((b, s, hkv, d), torch.bfloat16, gen)
        v = _randn((b, s, hkv, d), torch.bfloat16, gen)
        lens = torch.from_numpy(np.random.default_rng(2500 + seed).integers(
            1, s + 1, b).astype(np.int32)).cuda()
        outs, lses = _shares(q, k, v, lens, window)
        empty = float((lses <= ref.NEG_INF / 2).float().mean())
        merged = da.merge(outs, lses)
        whole = da.decode_attention(q, k, v, lens, window=window)
        naive = ref.decode_attention_naive(q, k, v, lens, window=window)
        plain = ref.decode_merge(outs, lses)
        pairs = ((f"{aid} shares merged vs whole kernel", whole),
                 (f"{aid} shares merged vs plain", naive),
                 (f"{aid} merge vs its plain version", plain))
        err = max(_check(tag, merged, want, tol) for tag, want in pairs)
        rows = [_row_check(tag, merged, want, TP_ROW_RTOL)
                for tag, want in pairs]
        del naive
        log(f"decode at {TP_SHARES} shares of {m} rows, {aid}'s heads "
            f"({hq}/{hkv}, D={d}) window {window}, B={b}, random lengths: "
            f"merged max|err| {err:.3e} against the whole-cache kernel, "
            f"ref.decode_attention_naive and ref.decode_merge (TOL {tol}); "
            f"worst row |err|/|want| {rows[0]:.3e}, {rows[1]:.3e}, "
            f"{rows[2]:.3e} (limit {TP_ROW_RTOL}); {empty:.1%} of the (row, "
            f"share) pairs had no valid key")
        out[aid] = err
        if aid != "gemma-2b":
            continue
        # one share's call at full lengths: the last share, every row valid
        full = torch.full((b,), s, dtype=torch.int32, device="cuda")
        off = (TP_SHARES - 1) * m
        ks, vs = k[:, off:], v[:, off:]
        flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
        nbytes = 2.0 * (ks.numel() + vs.numel() + 2 * q.numel()) + 4 * hq * b
        share_b = _bound(4.0 * b * hq * d * m, nbytes)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, ks, vs))
        share = _times(lambda: da.decode_attention(
            q, ks, vs, full, k_offset=off, return_lse=True),
            lambda: ref.decode_attention_naive(q, ks, vs, full, k_offset=off,
                                               return_lse=True),
            lambda: _sdpa(qt, kt, vt, None), flush)
        share.update(bound_ms=share_b[0], bound_by=share_b[1])
        whole_b = _bound(4.0 * b * hq * d * s, 2.0 * (k.numel() + v.numel()))
        whole_ms = time_ms(lambda: da.decode_attention(q, k, v, full), flush)
        outs, lses = _shares(q, k, v, full, None)
        mb = _bound(3.0 * outs.numel(), 2.0 * outs.numel() + 4.0 * lses.numel()
                    + 2.0 * q.numel())
        merge = dict(ms=time_ms(lambda: da.merge(outs, lses), None),
                     plain_ms=time_ms(lambda: ref.decode_merge(outs, lses),
                                      None),
                     library_ms=None, bound_ms=mb[0], bound_by=mb[1])
        log(_time_line(f"decode at one share (b, s, hq, hkv, d) = ({b}, {m},"
                       f" {hq}, {hkv}, {d}), k_offset {off}, every row "
                       f"valid, with the LSE output", share, smi)
            + f"; the whole {s}-row cache {whole_ms:.4f} ms (bound "
            f"{whole_b[0]:.5f} ms, {whole_b[1]})")
        log(f"time merge of {TP_SHARES} shares (B={b}, Hq={hq}, D={d}): "
            f"kernel {merge['ms']:.4f} ms, plain {merge['plain_ms']:.4f} ms,"
            f" library none, bound {mb[0]:.5f} ms ({mb[1]}) [{smi}]")
        out.update(share=share, merge=merge, whole_ms=whole_ms)
        del q, k, v, ks, vs, qt, kt, vt, flush
        _free()
    return out


def _tp_cache(model, prompt_cache: dict, b: int, seed: int,
              s: int = TP_S) -> dict:
    """A decode cache of ``s`` rows for ``b`` sequences: the prompt's k/v
    in the first rows of its sequences, seeded N(0, 1) bf16 elsewhere (the
    rows a longer context would have written); the prompt's SSM state and
    conv context where the family has them."""
    cache = model.init_cache(b, s, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for name, v in prompt_cache.items():
        if name in ("k", "v"):
            cache[name].normal_(generator=gen)
            cache[name][:, :v.shape[1], :v.shape[2]] = v
        else:
            cache[name][:, :v.shape[1]] = v
    return cache


def _greedy_check(tag: str, got, want, tol: float) -> float:
    """``got`` logits against ``want`` at ``tol``; the greedy tokens equal
    save where ``want``'s top two lie within ``TP_NEAR_TIE``."""
    err = _check(tag, got, want, tol)
    g, w = got.float().argmax(-1), want.float().argmax(-1)
    top2 = want.float().topk(2, -1).values
    tie = (top2[..., 0] - top2[..., 1]) < TP_NEAR_TIE
    if bool(((g != w) & ~tie).any()):
        raise AssertionError(f"{tag}: greedy tokens part away from a near "
                             "tie")
    return err


def _tp_serve(model, params, mesh, mesh_shape, b: int, seed: int,
              logits_of, plans: tuple | None = None,
              prefill_b: int | None = None, prompt: int = TP_PROMPT,
              steps: int = TP_STEPS, cache_s: int = TP_S) -> dict:
    """The unsharded ``apply_prefill`` of ``prefill_b`` (default ``b``)
    prompts of ``prompt`` tokens, its cache in a ``_tp_cache`` of ``b``
    sequences and ``cache_s`` rows and ``steps`` ``apply_decode`` steps;
    then the same through ``make_sharded_prefill``/``make_sharded_decode``
    on ``mesh`` under ``plans`` (prefill plan, decode plan; ``dp_tp`` for
    both by default), fed the unsharded run's greedy tokens (seeded ones
    for the sequences the prompt did not have), every kernel counter set
    to 0 just before and read just after (the main path).  The unsharded
    prefill runs the Mamba mixer on its eager path, as a sharded one does
    (a split keeps the eager code), so that world 1 compares like with
    like.  ``logits_of``: a sharded step's logits whole.  Returns the
    errors, whether each step's logits equal the unsharded ones to the bit,
    the sharded decode steps' ms, launches and peak."""
    from repro_torch.sharding import specs, spmd
    cfg = model.cfg
    plan_p, plan_d = plans or (tp_plan(mesh_shape),) * 2
    pb = prefill_b or b
    world = mesh_shape[0] * mesh_shape[1]
    tol = TP_LOGITS_TOL[min(world, 2)]
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(
                 0, cfg.vocab, (pb, prompt)).astype(np.int32)).cuda(),
             "lengths": torch.full((pb,), prompt, dtype=torch.int32,
                                   device="cuda")}
    extra = torch.from_numpy(rng.integers(0, cfg.vocab, (b - pb, 1)).astype(
        np.int32)).cuda()
    start = cache_s - steps
    with torch.no_grad():
        with plain_mixer():
            lu, cu = model.apply_prefill(params, batch,
                                         moe_impl=plan_p.moe_impl)
        cache = _tp_cache(model, cu, b, seed, cache_s)
        want = [lu]
        toks = [torch.cat([lu[:, 0].argmax(-1, keepdim=True).to(torch.int32),
                           extra])]
        plain_times = []
        for i in range(steps):
            lens = torch.full((b,), start + i + 1, dtype=torch.int32,
                              device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = model.apply_decode(params, cache,
                                           {"tokens": toks[-1],
                                            "lengths": lens},
                                           moe_impl=plan_d.moe_impl)
            torch.cuda.synchronize()
            plain_times.append(1e3 * (time.perf_counter() - t0))
            want.append(lg)
            toks.append(lg[:, 0].argmax(-1, keepdim=True).to(torch.int32))
    del cache
    _free()
    sp = specs.param_shardings(mesh, params, plan_p)
    prefill = spmd.make_sharded_prefill(model, plan_p, mesh)
    decode = spmd.make_sharded_decode(model, plan_d, mesh)
    torch.cuda.synchronize()
    _tp_zero()
    logits, cs = prefill(sp, batch)
    whole_logits = logits_of(logits)
    errs = [_greedy_check("tp prefill logits", whole_logits, lu, tol)]
    exact = [bool(torch.equal(whole_logits, lu))]
    local = {k: v.to_local() for k, v in cs.items()}
    if world == 1:
        errs.append(max(_check(f"tp prefill cache {k}", local[k], cu[k],
                               TOL[torch.bfloat16]) for k in local))
        exact.append(all(torch.equal(local[k], cu[k]) for k in local))
    whole = _tp_cache(model, cu, b, seed, cache_s)
    if plan_d is not plan_p:
        sp = specs.param_shardings(mesh, params, plan_d)
    dc = specs.cache_shardings(mesh, whole, plan_d)
    del whole, local, cs
    _free()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(steps):
        lens = torch.full((b,), start + i + 1, dtype=torch.int32,
                          device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, dc = decode(sp, dc, {"tokens": toks[i], "lengths": lens})
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        whole_logits = logits_of(logits)
        errs.append(_greedy_check(f"tp decode step {i} logits",
                                  whole_logits, want[i + 1], tol))
        exact.append(bool(torch.equal(whole_logits, want[i + 1])))
    launches = _tp_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    last = {"tokens": toks[steps - 1],
            "lengths": torch.full((b,), cache_s, dtype=torch.int32,
                                  device="cuda")}
    return dict(errs=errs, exact=exact, times=times,
                plain_times=plain_times, launches=launches, peak_gib=peak,
                step=lambda: decode(sp, dc, last), tol=tol)


def tp_world_one(mesh, smi: str) -> dict:
    """gemma-2b at full width and depth through the sharded serving steps
    over NCCL at world 1 (``_tp_serve``): exactly 18 flash calls for the
    prefill and 18 decode calls a step (the cache split by its one KV head
    over a ``model`` of 1: no merge), the decode step's ms, busy share and
    peak."""
    cfg = get_config("gemma-2b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda", dtype=torch.bfloat16)
    r = _tp_serve(model, params, mesh, (1, 1), TP_B, 2600,
                  lambda x: x.to_local())
    want = {"flash_attention": cfg.n_layers,
            "decode_attention": cfg.n_layers * TP_STEPS,
            "decode_attention_merge": 0, "ssd_intra_chunk": 0}
    if r["launches"] != want:
        raise AssertionError(f"tp world 1 launches {r['launches']}, "
                             f"expected {want}")
    p = _profile(r["step"], 1)
    busy = "not measured" if p is None else \
        f"{p['device_ms'] / p['wall_ms']:.1%}"
    log(f"gemma-2b dp_tp at world 1 over NCCL, B={TP_B} x S={TP_S} cache "
        f"(prompt {TP_PROMPT}, {TP_STEPS} decode steps from length "
        f"{TP_S - TP_STEPS}): sharded prefill and decode against the "
        f"unsharded steps max|err| {max(r['errs']):.3e} (tol {r['tol']}, "
        f"greedy tokens equal save near ties); decode step median "
        f"{statistics.median(r['times']):.2f} ms (steps "
        f"{[round(t, 2) for t in r['times']]}; the unsharded step "
        f"{statistics.median(r['plain_times']):.2f} ms), busy {busy}, peak "
        f"{r['peak_gib']:.2f} GiB; launches {r['launches']} [{smi}]")
    r.pop("step")
    del params, model
    _free()
    return r


def tp_world_two_worker(rank: int, d: str) -> None:
    """One of two ranks on the one card over gloo: gemma-2b at full width
    and ``TP_W2_LAYERS`` layers through ``_tp_serve`` on a (1, 2) mesh;
    rank 0 writes its errors, times and launches to ``d``."""
    import logging
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_smoke_mesh
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    torch.cuda.set_device(0)
    _build.build_all(("flash_attention", "decode_attention"))
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=2)
    try:
        mesh = make_smoke_mesh((1, 2), ("data", "model"), device_type="cuda")
        cfg = dataclasses.replace(get_config("gemma-2b"),
                                  n_layers=TP_W2_LAYERS)
        model = build_model(cfg)
        params = model.init(torch.Generator(device="cuda").manual_seed(0),
                            device="cuda", dtype=torch.bfloat16)

        def whole(x):
            # the vocab split over "model": gathered along it by c10d (the
            # functional all-gather DTensor uses crashes under gloo on CUDA)
            loc = x.to_local().contiguous()
            out = loc.new_empty((2, *loc.shape))
            dist.all_gather_into_tensor(out, loc[None])
            return torch.cat(tuple(out), -1)

        r = _tp_serve(model, params, mesh, (1, 2), TP_W2_B, 2700, whole)
        r.pop("step")
        if rank == 0:
            with open(f"{d}/out.json", "w") as f:
                json.dump(r, f)
    finally:
        dist.destroy_process_group()


def tp_world_two(smi: str) -> dict:
    """``tp_world_two_worker`` on two processes: the sequence-split path
    with the real kernels across ranks (k_offset, LSE, the merge), against
    the unsharded steps.  A rank's failure fails the phase."""
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(tp_world_two_worker, args=(d,), nprocs=2,
                           start_method="spawn")
        with open(f"{d}/out.json") as f:
            r = json.load(f)
    want = {"flash_attention": TP_W2_LAYERS,
            "decode_attention": TP_W2_LAYERS * TP_STEPS,
            "decode_attention_merge": TP_W2_LAYERS * TP_STEPS,
            "ssd_intra_chunk": 0}
    if r["launches"] != want:
        raise AssertionError(f"tp world 2 launches {r['launches']}, "
                             f"expected {want}")
    log(f"gemma-2b ({TP_W2_LAYERS} layers) dp_tp at world 2 on one card "
        f"over gloo, B={TP_W2_B} x S={TP_S} cache split along the sequence: "
        f"sharded against unsharded max|err| {max(r['errs']):.3e} (tol "
        f"{r['tol']}, greedy tokens equal save near ties); rank 0's decode "
        f"steps {[round(t, 2) for t in r['times']]} ms (gloo through the "
        f"host; unsharded {statistics.median(r['plain_times']):.2f} ms), "
        f"launches {r['launches']}, {time.perf_counter() - t0:.1f} s "
        f"[{smi}]")
    return r


def tp_serving_phase(smi: str) -> dict:
    """The tensor-parallel serving slice: the decode kernel at the shares
    of a sequence-split cache and their merge, gemma-2b through the sharded
    serving steps at world 1 over NCCL, and at world 2 on the one card over
    gloo.  Returns the records and launches for the kernels line."""
    import logging
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    _free()
    t0 = time.perf_counter()
    shares = check_decode_shares(smi)
    with world_one() as mesh:
        one = tp_world_one(mesh, smi)
    two = tp_world_two(smi)
    log(f"tensor-parallel phase: {time.perf_counter() - t0:.1f} s")
    return dict(shares=shares, one=one, two=two)


# --------------------------------------------------------------------------
# Tensor parallelism beside a sequence split and over two axes
# --------------------------------------------------------------------------

# the layouts of the planners (``sharding.plan``): ``seq_tp`` (prefill, the
# prompt's sequence over "data", tensors over "model"), ``ctx_tp`` and
# ``ctx_tp_ep`` (decode, the cache's sequence over "data", and over "model"
# too where the KV heads do not divide it), ``tp_all`` at B = 1 (tensors
# over ("data", "model")); "dp_tp" as ``tp_plan``
SP_LAYOUTS = {
    "seq_tp": dict(batch_axes=(), seq_axes=("data",), tp_axes=("model",)),
    "ctx_tp": dict(batch_axes=(), seq_axes=("data",), tp_axes=("model",)),
    "ctx_tp_ep": dict(batch_axes=(), seq_axes=("data",), tp_axes=("model",),
                      moe_impl="ep_a2a"),
    "tp_all": dict(batch_axes=(), tp_axes=("data", "model")),
    "dp_tp": dict(batch_axes=("data",), tp_axes=("model",)),
}
# (a) world 1 over NCCL, full width: (arch, layers or None for all, B of
# the decode, B of the prompt, prompt tokens, cache rows, prefill layout,
# decode layout).  gemma-2b's decode on ``tp_world_one``'s TP_B x TP_S
# cache; mamba2-780m after a 4096-token prompt; mixtral-8x7b at the 8 of
# 32 layers its serving path runs (``check_mixtral``)
SP_W1_CASES = (
    ("gemma-2b", None, TP_B, 4, TP_PROMPT, TP_S, "seq_tp", "ctx_tp"),
    ("mamba2-780m", None, 1, 1, 4096, 4096 + TP_STEPS, "tp_all", "tp_all"),
    ("mixtral-8x7b", 8, 4, 4, TP_PROMPT, TP_S, "seq_tp", "ctx_tp_ep"))
# (b) world 4 on the one card (four processes over gloo, a (2, 2) mesh),
# full width, SP_W4_LAYERS layers, SP_W4_STEPS decode steps: gemma-2b's one
# KV head puts the decode cache's sequence over all four ranks (a 4-way
# merge); mixtral-8x7b's heads over "model" and sequence over "data";
# mamba2-780m's 48 SSM heads over 4 ranks; hymba-1.5b's prompt split over
# "data" (the scan's state exchange, the SSD kernel on each rank's chunks)
SP_W4_LAYERS, SP_W4_STEPS, SP_W4_S = 2, 4, 4096
SP_W4_CASES = (
    ("gemma-2b", 4, 4, TP_PROMPT, SP_W4_S, "seq_tp", "ctx_tp"),
    ("mixtral-8x7b", 4, 4, TP_PROMPT, SP_W4_S, "seq_tp", "ctx_tp_ep"),
    ("mamba2-780m", 1, 1, TP_PROMPT, TP_PROMPT + SP_W4_STEPS, "tp_all",
     "tp_all"),
    ("hymba-1.5b", 4, 4, TP_PROMPT, SP_W4_S, "seq_tp", "dp_tp"))
# (c) the dry-run's serving cells under these layouts on GPU_NODE (full
# configs, a third serving process)
DRYRUN_SP_SERVE = (
    ("gemma-2b", "decode_32k", "ctx_tp"),
    ("llama-3.2-vision-11b", "decode_32k", "ctx_tp"),
    ("qwen3-moe-30b-a3b", "decode_32k", "ctx_tp_ep"),
    ("mixtral-8x7b", "decode_32k", "ctx_tp_ep"),
    ("gemma3-1b", "long_500k", "ctx_tp"),
    ("mamba2-780m", "long_500k", "tp_all"),
    ("hymba-1.5b", "long_500k", "tp_all"),
    ("gemma3-1b", "long_500k", "tp_all"),
    ("mixtral-8x7b", "long_500k", "tp_all"))


def sp_plan(layout: str, mesh_shape) -> ShardingPlan:
    """``layout``'s axes (``SP_LAYOUTS``) on a ("data", "model") mesh of
    ``mesh_shape``."""
    return ShardingPlan(arch="smoke", shape="serve",
                        mesh=MeshDesc(("data", "model"), tuple(mesh_shape)),
                        global_mode="data", local_layout=layout,
                        **SP_LAYOUTS[layout])


def _sp_launches(cfg, steps: int, merges: bool) -> dict:
    """The kernel calls one rank makes for a prompt and ``steps`` decode
    steps: a flash call per attention layer of the prompt, an SSD call per
    mixer, a decode call per attention layer and step, and a merge beside
    each where the cache's sequence is split over several ranks."""
    attn = cfg.n_layers if cfg.family != "ssm" else 0
    ssd = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    return {"flash_attention": attn, "decode_attention": attn * steps,
            "decode_attention_merge": attn * steps if merges else 0,
            "ssd_intra_chunk": ssd}


def _sp_model(aid: str, layers: int | None):
    cfg = get_config(aid)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda", dtype=torch.bfloat16)
    return cfg, model, params


def sp_world_one(mesh, smi: str) -> dict:
    """``SP_W1_CASES`` through the sharded serving steps over NCCL at world
    1 (``_tp_serve``): every split has width 1, so the logits and the
    prompt's cache equal the unsharded steps' to the bit; exact launches;
    the decode step's ms, busy share and peak beside the unsharded step's.
    """
    out = {}
    for aid, layers, b, pb, prompt, cache_s, pl, dl in SP_W1_CASES:
        cfg, model, params = _sp_model(aid, layers)
        r = _tp_serve(model, params, mesh, (1, 1), b, 2800, lambda x:
                      x.to_local(), plans=(sp_plan(pl, (1, 1)),
                                           sp_plan(dl, (1, 1))),
                      prefill_b=pb, prompt=prompt, cache_s=cache_s)
        want = _sp_launches(cfg, TP_STEPS, merges=False)
        if r["launches"] != want:
            raise AssertionError(f"{aid} {pl}/{dl} world 1 launches "
                                 f"{r['launches']}, expected {want}")
        if not all(r["exact"]):
            raise AssertionError(f"{aid} {pl}/{dl} world 1: not equal to "
                                 f"the unsharded steps to the bit "
                                 f"({r['exact']}, max|err| "
                                 f"{max(r['errs']):.3e})")
        p = _profile(r["step"], 1)
        busy = "not measured" if p is None else \
            f"{p['device_ms'] / p['wall_ms']:.1%}"
        log(f"{aid}{'' if layers is None else f' ({layers} layers)'} {pl} "
            f"prefill (B={pb} x {prompt}) then {dl} decode (B={b} x "
            f"S={cache_s} cache, {TP_STEPS} steps) at world 1 over NCCL: "
            f"equal to the unsharded steps to the bit; decode step median "
            f"{statistics.median(r['times']):.2f} ms (steps "
            f"{[round(t, 2) for t in r['times']]}; the unsharded step "
            f"{statistics.median(r['plain_times']):.2f} ms), busy {busy}, "
            f"peak {r['peak_gib']:.2f} GiB; launches {r['launches']} [{smi}]")
        r.pop("step")
        out[aid] = r
        del params, model
        _free()
    return out


def _whole(x):
    """A DTensor whole on every rank: every rank's shard all-gathered by
    c10d (DTensor's functional all-gather crashes under gloo on CUDA) and
    put together by its placements, the innermost mesh dim first."""
    import torch.distributed as dist
    mesh = x.device_mesh
    loc = x.to_local().contiguous()
    out = loc.new_empty((dist.get_world_size(), *loc.shape))
    dist.all_gather_into_tensor(out, loc[None])
    t = out.reshape(*mesh.shape, *loc.shape)
    for i in reversed(range(mesh.ndim)):
        parts = t.unbind(i)
        pl = x.placements[i]
        t = torch.cat(parts, i + pl.dim) if pl.is_shard() else parts[0]
    return t


def sp_world_four_worker(rank: int, d: str) -> None:
    """One of four ranks on the one card over gloo: ``SP_W4_CASES`` at full
    width and ``SP_W4_LAYERS`` layers through ``_tp_serve`` on a (2, 2)
    mesh; each rank writes its errors, times and launches to ``d``."""
    import logging
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_smoke_mesh
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    torch.cuda.set_device(0)
    _build.build_all(("flash_attention", "decode_attention",
                      "ssd_intra_chunk"))
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=4)
    try:
        mesh = make_smoke_mesh((2, 2), ("data", "model"), device_type="cuda")
        res = {}
        for aid, b, pb, prompt, cache_s, pl, dl in SP_W4_CASES:
            cfg, model, params = _sp_model(aid, SP_W4_LAYERS)
            r = _tp_serve(model, params, mesh, (2, 2), b, 2900, _whole,
                          plans=(sp_plan(pl, (2, 2)), sp_plan(dl, (2, 2))),
                          prefill_b=pb, prompt=prompt, steps=SP_W4_STEPS,
                          cache_s=cache_s)
            r.pop("step")
            res[aid] = r
            del params, model
            _free()
        with open(f"{d}/out_{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def sp_world_four(smi: str) -> dict:
    """``sp_world_four_worker`` on four processes in one spawn: the
    four-way merge, the heads-and-sequence cache, the two-axis crossings
    and the scan's state exchange with the real kernels across ranks,
    against the unsharded steps at ``TP_LOGITS_TOL[2]``; exact launches on
    every rank.  A rank's failure fails the phase."""
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(sp_world_four_worker, args=(d,), nprocs=4,
                           start_method="spawn")
        ranks = []
        for rank in range(4):
            with open(f"{d}/out_{rank}.json") as f:
                ranks.append(json.load(f))
    for aid, b, pb, prompt, cache_s, pl, dl in SP_W4_CASES:
        cfg = dataclasses.replace(get_config(aid), n_layers=SP_W4_LAYERS)
        plan = sp_plan(dl, (2, 2))
        merges = False
        if cfg.family != "ssm":
            from repro_torch.sharding import specs
            sp = specs.cache_specs_tree(plan.mesh, build_model(cfg)
                                        .cache_specs(ShapeConfig(
                                            "w4", cache_s, b, "decode")),
                                        plan)
            merges = any(specs.axis_sizes(plan.mesh)[a] > 1 for a in
                         specs._entry_axes(sp["k"][-3]))
        want = _sp_launches(cfg, SP_W4_STEPS, merges)
        for rank, res in enumerate(ranks):
            if res[aid]["launches"] != want:
                raise AssertionError(f"{aid} {pl}/{dl} world 4 rank {rank} "
                                     f"launches {res[aid]['launches']}, "
                                     f"expected {want}")
        r = ranks[0][aid]
        log(f"{aid} ({SP_W4_LAYERS} layers) {pl} prefill (B={pb} x {prompt})"
            f" then {dl} decode (B={b} x S={cache_s}) at world 4 on one card "
            f"over gloo, (2, 2) mesh: sharded against unsharded max|err| "
            f"{max(r['errs']):.3e} (tol {r['tol']}, greedy tokens equal "
            f"save near ties); rank 0's decode steps "
            f"{[round(t, 2) for t in r['times']]} ms (gloo through the host;"
            f" unsharded {statistics.median(r['plain_times']):.2f} ms); "
            f"launches {r['launches']} on each of 4 ranks [{smi}]")
    log(f"world 4: {time.perf_counter() - t0:.1f} s")
    return ranks[0]


def sp_tp_serving_phase(smi: str) -> dict:
    """Tensor parallelism beside a sequence split and over two axes:
    ``SP_W1_CASES`` at world 1 over NCCL, ``SP_W4_CASES`` at world 4 on the
    card over gloo.  Returns the records."""
    import logging
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    _free()
    t0 = time.perf_counter()
    with world_one() as mesh:
        one = sp_world_one(mesh, smi)
    four = sp_world_four(smi)
    log(f"sequence-split and two-axis tensor-parallel phase: "
        f"{time.perf_counter() - t0:.1f} s")
    return dict(one=one, four=four)


# --------------------------------------------------------------------------
# Tensor-parallel training at world 2
# --------------------------------------------------------------------------

# ``dp_tp`` training at world 2 on the one card (two processes over gloo on
# a (1, 2) mesh): full width, TP_TRAIN_LAYERS layers, B x T = TRAIN_B x
# TRAIN_T, TP_TRAIN_STEPS steps against the unsharded step on the card.
# gemma-2b: the tied embedding split by vocab (masked lookup, the vocab-split
# cross entropy), q/k/v gathered through its one KV head (every rank runs all
# 8 heads), wo and w_down by rows; mamba2-780m: w_in gathered, the conv by
# channels, the SSD pass on 24 of 48 heads a rank, the gated norm's sum of
# squares all-reduced, w_out by rows
TP_TRAIN_ARCHS = ("gemma-2b", "mamba2-780m")
TP_TRAIN_MESH = MeshDesc(("data", "model"), (1, 2))
TP_TRAIN_LAYERS, TP_TRAIN_STEPS = 2, 2
# tests/_tp_train.py's limit on the first clip norm in bf16: the tp step sums
# bf16 partial products across ranks, so it does not round where the
# unsharded step does (losses and parameters keep STEP_LOSS_RTOL and
# (i + 1) x STEP_PARAM_ATOL)
TP_TRAIN_NORM_RTOL = 1e-2


def _tp_train_run(aid: str, mesh) -> dict:
    """``aid`` at full width and ``TP_TRAIN_LAYERS`` layers on this rank:
    ``TP_TRAIN_STEPS`` unsharded steps, then as many ``dp_tp`` steps over
    ``mesh`` from the same initialisation and batches, every kernel counter
    set to 0 just before each sharded step and read just after.  Returns the
    metrics, the final parameters' largest error on this rank's shards, the
    steps' ms and launches, and the peak memory."""
    from repro_torch.sharding import specs, spmd
    cfg = dataclasses.replace(get_config(aid), n_layers=TP_TRAIN_LAYERS)
    model = build_model(cfg)
    data = iter(SyntheticDataset(cfg, TRAIN_B, TRAIN_T, seed=3))
    batches = [{k: torch.as_tensor(v, device="cuda") for k, v in
                next(data).items()} for _ in range(TP_TRAIN_STEPS)]
    oc = train_optim.OptConfig()

    def init():
        return model.init(torch.Generator(device="cuda").manual_seed(0),
                          device="cuda")

    params = init()
    opt = train_optim.init(params)
    step = train_loop.make_train_step(model, oc, world_one_plan("unsharded"))
    want = []
    for tb in batches:
        params, opt, m = step(params, opt, tb)
        want.append((float(m["loss"]), float(m["grad_norm"])))
    plan = world_one_plan("dp_tp", mesh=TP_TRAIN_MESH)
    ref_shards = specs.param_shardings(mesh, params, plan)
    del params, opt, step
    _free()
    sp = specs.param_shardings(mesh, init(), plan)
    so = train_optim.init(sp)
    sstep = spmd.make_sharded_train_step(model, oc, plan, mesh)
    torch.cuda.reset_peak_memory_stats()
    got, times, launches = [], [], []
    for tb in batches:
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        sp, so, m = sstep(sp, so, tb)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        launches.append(_counts())
        got.append((float(m["loss"]), float(m["grad_norm"])))
    err = max(float((g.to_local().float() - w.to_local().float()).abs()
                    .max()) for g, w in zip(train_tree.leaves(sp),
                                            train_tree.leaves(ref_shards)))
    return dict(want=want, got=got, param_err=err, times=times,
                launches=launches, want_launches=_step_launches(cfg),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def tp_train_world_two_worker(rank: int, d: str) -> None:
    """One of two ranks on the one card over gloo: ``_tp_train_run`` of each
    of ``TP_TRAIN_ARCHS``; writes its results to ``d``."""
    import logging
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_smoke_mesh
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    torch.cuda.set_device(0)
    _build.build_all(("flash_attention", "flash_attention_bwd",
                      "ssd_intra_chunk", "ssd_intra_chunk_bwd"))
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=2)
    try:
        mesh = make_smoke_mesh(TP_TRAIN_MESH.shape, TP_TRAIN_MESH.axes,
                               device_type="cuda")
        out = {aid: _tp_train_run(aid, mesh) for aid in TP_TRAIN_ARCHS}
        with open(f"{d}/rank{rank}.json", "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def tp_train_world_two(smi: str) -> dict:
    """``tp_train_world_two_worker`` on two processes: each rank's losses
    and first clip norm against the unsharded step's, its shards of the
    final parameters, and its exact launches a step (the unsharded step's:
    flash 2 forward and 1 backward a layer under remat, every rank running
    all heads; SSD likewise at half the heads).  A rank's failure fails the
    phase.  Returns rank 0's launches by arch."""
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(tp_train_world_two_worker, args=(d,), nprocs=2,
                           start_method="spawn")
        ranks = []
        for r in range(2):
            with open(f"{d}/rank{r}.json") as f:
                ranks.append(json.load(f))
    for aid in TP_TRAIN_ARCHS:
        for rank, res in enumerate(ranks):
            r = res[aid]
            tag = f"{aid} dp_tp world 2 rank {rank}"
            for i, got in enumerate(r["launches"]):
                if got != r["want_launches"]:
                    raise AssertionError(f"{tag} step {i} launches {got}, "
                                         f"expected {r['want_launches']}")
            lerr = max(abs(g[0] - w[0]) / abs(w[0])
                       for g, w in zip(r["got"], r["want"]))
            nerr = abs(r["got"][0][1] - r["want"][0][1]) / r["want"][0][1]
            limit = TP_TRAIN_STEPS * STEP_PARAM_ATOL
            if not (lerr <= STEP_LOSS_RTOL and nerr <= TP_TRAIN_NORM_RTOL
                    and r["param_err"] < limit):
                raise AssertionError(
                    f"{tag}: losses and norms {r['got']} against "
                    f"{r['want']}, parameters max|err| {r['param_err']:.3e}")
            log(f"{tag} ({TP_TRAIN_LAYERS} layers, full width, B={TRAIN_B} "
                f"T={TRAIN_T}, over gloo on one card): losses "
                f"{[round(g[0], 5) for g in r['got']]} against "
                f"{[round(w[0], 5) for w in r['want']]} (rel {lerr:.2e}, "
                f"rtol {STEP_LOSS_RTOL}), first clip norm "
                f"{r['got'][0][1]:.5f} against {r['want'][0][1]:.5f} (rel "
                f"{nerr:.2e}, rtol {TP_TRAIN_NORM_RTOL}), its shards of the "
                f"final parameters max|err| {r['param_err']:.3e} (atol "
                f"{limit}); steps {[round(t, 1) for t in r['times']]} ms "
                f"(gloo through the host), peak {r['peak_gib']:.2f} GiB, "
                f"launches a step {r['launches'][-1]} [{smi}]")
    log(f"tensor-parallel training at world 2: "
        f"{time.perf_counter() - t0:.1f} s")
    return {aid: ranks[0][aid]["launches"][-1] for aid in TP_TRAIN_ARCHS}


# the tensor-core instantiations, which must not spill (their accumulators
# live in registers): bf16 attention and its backward, and every
# instantiation of the SSD pass and its backward (3xTF32)
TENSOR_CORE_KERNELS = ("flash_bf16", "decode_split_bf16",
                       "ssd_intra_chunk_kernel", "bwd_dkdv_wg", "bwd_dq_wg",
                       "ssd_bwd_scores", "ssd_bwd_head", "ssd_bwd_reduce")


def log_ptxas(kname: str, report: str) -> None:
    """Registers and spill bytes per kernel instantiation from ptxas's
    report; raises if a tensor-core instantiation spills."""
    entries = re.findall(r"Compiling entry function '(\w+)'.*?"
                         r"(\d+) bytes stack frame, (\d+) bytes spill "
                         r"stores.*?Used (\d+) registers", report,
                         flags=re.S)
    # ptxas's advisories (wgmma serialised, ...), by kernel
    advisories = re.findall(r"Performance Loss: (.*) in the function '(\w+)'",
                            report)
    names = [n for n, _, _, _ in entries] + [n for _, n in advisories]
    try:
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True, check=True,
                               timeout=60).stdout.split("\n")
    except (OSError, subprocess.SubprocessError):
        pass                                 # keep the mangled names
    short = [re.sub(r"\(.*", "", n.replace("(anonymous namespace)::", ""))
             for n in names]
    log(f"  ptxas {kname}: {len(entries)} instantiations")
    spilled = []
    for name, sname, (_, stack, spill, regs) in zip(names, short, entries):
        log(f"    {sname}: {regs} registers, {stack} bytes stack frame, "
            f"{spill} bytes spill stores")
        if int(spill) and any(k in name for k in TENSOR_CORE_KERNELS):
            spilled.append(f"{sname} spills {spill} bytes")
    for sname, (what, _) in zip(short[len(entries):], advisories):
        log(f"    advisory {sname}: {what}")
    for line in report.splitlines():
        if "warning" in line.lower():
            log(f"    {line.strip()}")
    if spilled:
        raise AssertionError("; ".join(spilled))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = card()
    name = torch.cuda.get_device_name(0)
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    dryruns: dict = {}
    try:
        return _main(smi, name, dryruns)
    finally:
        stop_dryruns(dryruns)


def _main(smi: str, name: str, dryruns: dict) -> int:
    """The phases; ``dryruns`` receives the dry-run's host processes."""
    # 1. build
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for {len(_build.KERNELS)} "
        f"kernels into {_build.BUILD_DIR}")
    for kname in _build.KERNELS:
        log_ptxas(kname, _build.build_log(kname))
    dryruns.update(start_tp_train_dryruns())

    # 2. kernels against their plain versions; the grouped MoE step against
    # the dense oracle
    worst = check_kernels()
    worst["flash_attention_bwd"] = check_backward()
    worst["ssd_intra_chunk_bwd"] = check_ssd_backward()
    worst["ssd_decode"] = check_ssd_decode()
    log(f"ssd decode vs plain: {2 * len(SSD_DECODE)} cases, state largest "
        f"max|err| {worst['ssd_decode']:.3e}")
    worst["mamba_prefill"] = check_mamba_prefill()
    log(f"mamba prefill passes vs plain: {2 * len(MAMBA_PREFILL)} cases, "
        f"output largest max|err| {worst['mamba_prefill']:.3e}")
    bwd_launch_times(smi)
    decode_launch_times(smi)
    moe_err = check_moe()
    log(f"moe grouped step vs dense oracle: {len(MOE_CASES)} cases, largest "
        f"max|err| {moe_err:.3e} within TOL {TOL[torch.bfloat16]}")

    # 3. calibrate and plan: the kernel sweep calibrates the planner; then
    # GPU-tier planning and elasticity on the host
    plan = calibrate_and_plan(smi)
    plan_elastic(smi)

    # 4. the serving paths at full width; gemma-2b also through the plan
    cfg, model, params, prompts, run = serve(
        "gemma-2b", N_REQUESTS, ("flash_attention", "decode_attention"), smi)
    serve_planned(model, params, prompts, run, plan, smi)
    churn = serve_churn(model, params, prompts, run, smi)
    evaluation_phase(model, run, churn, plan, smi)
    err = check_prefill_then_decode(model, params, cfg, PTD_LIMIT[cfg.name])
    log(f"prefill-then-decode vs full forward (B=2, P=255): max|err| "
        f"{err:.3e} within {PTD_LIMIT[cfg.name]}")
    log(f"where the time goes: {decode_breakdown(model, params, prompts)} "
        f"[{smi}]")
    launches = dict(run["launches"])
    del params, model, run
    torch.cuda.empty_cache()

    cfg, model, params, prompts, run = serve(
        "mamba2-780m", N_REQUESTS,
        ("ssd_intra_chunk", "ssd_decode", "mamba_prefill"), smi)
    err = check_prefill_then_decode(model, params, cfg, PTD_LIMIT[cfg.name])
    log(f"mamba2-780m prefill-then-decode vs full forward (B=2, P=255: a "
        f"full chunk and a padded one): max|err| {err:.3e} within "
        f"{PTD_LIMIT[cfg.name]}")
    log(f"mamba2-780m where the time goes: "
        f"{decode_breakdown(model, params, prompts)} [{smi}]")
    log(f"mamba2-780m prefill: "
        f"{prefill_breakdown(model, params, prompts[0])} [{smi}]")
    for kname in ("ssd_intra_chunk", "ssd_decode", "mamba_prefill"):
        launches[kname] = run["launches"][kname]
    del params, model, run
    torch.cuda.empty_cache()

    cfg, model, params, prompts, run = serve(
        "hymba-1.5b", HYBRID_REQUESTS, tuple(COUNTERS), smi)
    log(f"hymba-1.5b where the time goes: "
        f"{decode_breakdown(model, params, prompts)} [{smi}]")
    log(f"hymba-1.5b prefill: "
        f"{prefill_breakdown(model, params, prompts[0])} [{smi}]")
    del params, model, run
    torch.cuda.empty_cache()

    # the encoder-decoder and VLM families: whisper-tiny whole and
    # llama-3.2-vision-11b at full width and depth, freed before qwen3
    cross = serve_cross_families(smi)
    log(f"launches per engine run: {WHISPER} {cross[WHISPER]}, {VLM} "
        f"{cross[VLM]}")

    # the MoE family: qwen3-moe-30b-a3b at full width and depth through the
    # engine, then mixtral-8x7b at full width and 8 layers
    serve_qwen3(smi)
    check_mixtral(smi)

    # the dry-run's host processes run beside the training slice, the
    # multi-GPU phase and the kernel times (device times, queued behind a
    # sleep kernel): beside the host-bound serving paths they would slow
    # them down
    dryruns.update(start_dryruns())

    # the training slice: the trainer CLI, the full-width gradient check
    # and gemma-2b's full-depth train steps (through the backward kernel)
    trained = train_phases(smi)
    for kname in ("flash_attention_bwd", "ssd_intra_chunk_bwd"):
        launches[kname] = trained[kname]

    # 7. the multi-GPU slice over NCCL at world 1, after the training
    # phases (qwen3's sharded steps are held to their in-process runs)
    world_one_runs = multi_gpu_phase(smi)

    # 8. tensor-parallel serving: the decode kernel at a sequence-split
    # cache's shares and their merge, gemma-2b through the sharded serving
    # steps at world 1 over NCCL and at world 2 on the card over gloo
    tp = tp_serving_phase(smi)
    # 8b. tensor parallelism beside a sequence split and over two axes:
    # seq_tp, ctx_tp, ctx_tp_ep and tp_all at world 1 over NCCL and at
    # world 4 on the card over gloo
    sp_tp_serving_phase(smi)
    # 9. tensor-parallel training at world 2 on the card over gloo
    tp_train_world_two(smi)
    dryruns.update(start_serving_dryruns())

    # 5. times at the main path's shapes
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    records = {}
    hymba_heads, qwen3_heads = HYMBA_ATTN[:3], QWEN3_ATTN[:3]
    for b, t, win, heads in ([(*c, (HQ, HKV, HD)) for c in PREFILL]
                             + [(1, RAGGED_PREFILL[0], HYMBA_ATTN[3],
                                 hymba_heads),
                                (*PREFILL[0], qwen3_heads)]):
        r = time_flash(b, t, win, None, heads)  # q/k/v just produced: warm
        log(_time_line(f"flash  heads={heads} B={b} T={t:4d} window={win}",
                       r, smi))
        records.setdefault("flash_attention", r)
    for shape in (CROSS_SHAPES[0], CROSS_SHAPES[2]):
        r = time_cross_flash(shape, None)       # cross k/v just produced
        log(_time_line(f"flash  cross (b, tq, tk, hq, hkv, d) = {shape}", r,
                       smi) + f"; given host lengths {r['host_lengths_ms']:.4f}"
            " ms")
    for lens, win, heads in ([(*c, (HQ, HKV, HD)) for c in DECODE_LENS[:2]]
                             + [(DECODE_LENS[0][0], HYMBA_ATTN[3],
                                 hymba_heads),
                                (*DECODE_LENS[0], qwen3_heads)]):
        r = time_decode(lens, win, flush, heads)  # cold cache, as in serving
        log(_time_line(f"decode heads={heads} B=4 S=1024 lens={lens} "
                       f"window={win}", r, smi))
        records.setdefault("decode_attention", r)
    for shape in CROSS_DECODE_SHAPES:
        r = time_cross_decode(shape, flush)
        log(_time_line(f"decode cross (b, s, hq, hkv, d) = {shape}, lengths "
                       "= S", r, smi))
    for shape in SSD_PREFILL:
        r = time_ssd(shape)
        log(f"time ssd    {shape}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library none, bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']}: "
            f"{r['flops'] / 1e9:.3f} GFLOP fp32 as 3xTF32, "
            f"{r['bytes'] / 1e6:.2f} MB) [{smi}]")
        records.setdefault("ssd_intra_chunk", r)
    for shape in SSD_DECODE:
        r = time_ssd_decode(shape)
        log(ssd_decode_line(shape, r, smi))
        records.setdefault("ssd_decode", r)
    for shape in MAMBA_PREFILL:
        r = time_mamba_prefill(shape)
        for line in mamba_prefill_lines(shape, r, smi):
            log(line)
        passes = [q for k, q in r["parts"].items() if k != "ssd_intra_chunk"]
        records.setdefault("mamba_prefill", dict(
            ms=sum(q["ms"] for q in passes),
            plain_ms=r["plain_ms"] - r["parts"]["ssd_intra_chunk"]["ms"],
            bound_ms=sum(q["bound_ms"] for q in passes),
            bound_by="bytes and operations", library_ms=None))
    r = time_flash_bwd(None)          # its inputs just produced: warm
    log(_time_line(f"flash backward gemma-2b training B={TRAIN_B} "
                   f"T={TRAIN_T} (library: sdpa's backward)", r, smi))
    records["flash_attention_bwd"] = r
    r = time_flash_bwd(None, QWEN3_ATTN[:3])
    log(_time_line(f"flash backward {QWEN3} training B={TRAIN_B} "
                   f"T={TRAIN_T} heads {QWEN3_ATTN[:3]} (library: sdpa's "
                   "backward)", r, smi))
    for shape in SSD_TRAIN:
        r = time_ssd_bwd(shape)
        log(f"time ssd bwd {shape}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library none, bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']}: "
            f"{r['flops'] / 1e9:.3f} GFLOP fp32 as 3xTF32, "
            f"{r['bytes'] / 1e6:.2f} MB) [{smi}]")
        records.setdefault("ssd_intra_chunk_bwd", r)
    for t in (4, RAGGED_PREFILL[0]):
        time_moe_layer(t, smi)
    # the dry-run's lines, its processes done by now
    dryrun_lines(dryruns, world_one_runs, tp["one"], smi)
    log(f"kernels: {list(_build.KERNELS)}")

    source = {
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:134"),
        "decode_attention": (
            "src/repro_torch/kernels/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention.py:104"),
        "ssd_intra_chunk": ("src/repro_torch/kernels/csrc/ssd_intra_chunk.cu",
                            "src/repro/kernels/ssd_scan.py:69"),
        "flash_attention_bwd": (
            "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "src/repro/kernels/flash_attention.py:134"),
        "ssd_intra_chunk_bwd": (
            "src/repro_torch/kernels/csrc/ssd_intra_chunk_bwd.cu",
            "src/repro/kernels/ssd_scan.py:69"),
        "ssd_decode": ("src/repro_torch/kernels/csrc/ssd_decode.cu",
                       "none: src/repro/kernels/ops.py::ssd_decode_step "
                       "runs outside Pallas"),
        "mamba_prefill": ("src/repro_torch/kernels/csrc/mamba_prefill.cu",
                          "none: the Mamba-2 mixer's glue around the SSD "
                          "kernel runs in XLA (src/repro/models/layers.py, "
                          "src/repro/kernels/ssd_scan.py)")}
    # launches: the attention kernels' from the gemma-2b run, the SSD
    # kernels' (intra-chunk and decode) from the mamba2-780m run (hymba-1.5b's are logged above),
    # the flash backward's from gemma-2b's full-depth train steps, the SSD
    # backward's from mamba2-780m's
    worst["decode_attention"] = max(worst["decode_attention"],
                                    tp["shares"]["combine"])
    kernels = []
    for kname in _build.KERNELS:
        r = records[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": source[kname][0],
            "replaces": source[kname][1],
            "launches": launches[kname],
            "max_abs_err": worst[kname], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    # the merge of a sequence-split cache's shares: the decode source's
    # combine kernel behind its own entry point, on the main path where
    # ranks hold shares (world 2 on the card; at world 1 the cache splits
    # by its one KV head and nothing is merged)
    r = tp["shares"]["merge"]
    kernels.append({
        "name": "decode_attention_merge", "route": "cuda",
        "source": source["decode_attention"][0],
        "replaces": source["decode_attention"][1],
        "launches": tp["two"]["launches"]["decode_attention_merge"],
        "max_abs_err": max(tp["shares"]["gemma-2b"],
                           tp["shares"]["merge_ranks"]), "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


if __name__ == "__main__":
    sys.exit(main())
