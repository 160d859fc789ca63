"""End-to-end serving launcher of the port: continuous batching over the
HiDP-planned engine with a mixed stream of requests, on the reduced config.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b --requests 16
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --requests 4
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import build_model
from repro_torch.serving.engine import ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b", choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = _device.resolve(args.device)
    cfg = get_config(args.arch).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    eng = ServingEngine(model, params, max_batch=args.max_batch,
                        max_len=args.max_len, device=dev)
    rng = np.random.default_rng(0)
    t0 = time.time()
    rids = []
    for i in range(args.requests):
        plen = int(rng.integers(4, 24))
        prompt = rng.integers(0, cfg.vocab, size=plen).astype(np.int32)
        rids.append(eng.submit(prompt, max_new_tokens=args.max_new))
    done = eng.run_until_done()
    dt = time.time() - t0
    toks = sum(len(r.generated) for r in done.values())
    print(f"arch={cfg.name}: served {len(done)}/{args.requests} requests, "
          f"{toks} tokens in {dt:.1f}s ({toks / dt:.1f} tok/s) with "
          f"{args.max_batch} slots")
    for rid in rids[:3]:
        print(f"  req{rid}: {done[rid].generated[:10]} ...")
    if len(done) != args.requests:
        raise SystemExit(f"served {len(done)} of {args.requests} requests")


if __name__ == "__main__":
    main()
