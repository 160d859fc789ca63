"""End-to-end training driver, the port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
        --steps 200 --d-model 256 --layers 8 --batch 8 --seq 256

A real training loop (synthetic data, the plan's train step, a
fault-tolerant runner with periodic checkpoints) on one GPU, at a reduced
width by default (about 20M parameters).  It runs on ``cuda`` and raises
without a GPU; ``--device cpu`` runs it on the CPU.  A run that finds a
checkpoint in ``--ckpt-dir`` resumes from it.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
import tempfile
import time

import torch

from repro_torch import device as _device
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import build_model
from repro_torch.runtime.fault_tolerance import (CheckpointPolicy,
                                                 FaultTolerantRunner)
from repro_torch.sharding.plan import SINGLE_POD, ShardingPlan
from repro_torch.training import optimizer as optim
from repro_torch.training import tree
from repro_torch.training.data import SyntheticDataset
from repro_torch.training.train_loop import make_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)

    cfg = get_config(args.arch).reduced()
    cfg = dataclasses.replace(
        cfg, d_model=args.d_model, n_layers=args.layers,
        d_ff=args.d_model * 4, n_heads=max(args.d_model // 64, 1),
        n_kv_heads=max(min(cfg.n_kv_heads or 1, args.d_model // 64), 1),
        head_dim=64, vocab=4096)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    n_params = sum(x.numel() for x in tree.leaves(params))
    print(f"arch={cfg.name} reduced to {n_params / 1e6:.1f}M params; "
          f"{args.steps} steps of {args.batch}x{args.seq} on {dev}")

    schedule = "wsd" if args.arch == "minicpm-2b" else "cosine"
    opt_cfg = optim.OptConfig(lr=args.lr, warmup_steps=20,
                              total_steps=args.steps, schedule=schedule)
    plan = ShardingPlan(arch=cfg.name, shape="train", mesh=SINGLE_POD,
                        global_mode="data", local_layout="host",
                        batch_axes=(), remat=True)
    raw_step = make_train_step(model, opt_cfg, plan)

    def step_fn(state, batch):
        params, opt = state
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        params, opt, metrics = raw_step(params, opt, batch)
        return (params, opt), metrics

    runner = FaultTolerantRunner(
        step_fn=step_fn,
        ckpt_policy=CheckpointPolicy(args.ckpt_dir,
                                     every_steps=args.ckpt_every))
    data = itertools.islice(
        iter(SyntheticDataset(cfg, args.batch, args.seq)), args.steps)
    t0 = time.time()
    state, step, log = runner.run((params, optim.init(params)), data)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    first = [float(m["loss"]) for m in log[:5]]
    last = [float(m["loss"]) for m in log[-5:]]
    print(f"done: {step} steps in {dt:.1f}s "
          f"({args.batch * args.seq * len(log) / dt:.0f} tok/s)")
    print(f"loss: first5={[f'{x:.3f}' for x in first]} "
          f"last5={[f'{x:.3f}' for x in last]}")
    if not sum(last) / len(last) < sum(first) / len(first):
        raise AssertionError("training did not reduce the loss")
    print("loss decreased ✓")
    return {"step": step, "steps_run": len(log), "seconds": dt,
            "first5": first, "last5": last}


if __name__ == "__main__":
    main()
