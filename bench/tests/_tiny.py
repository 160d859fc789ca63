"""Cells of ``BENCHMARK.json`` cut to a size the CPU runs in seconds: the
same configuration files with every width and count made tiny, the same
mixes with short prompts and answers and four clients."""

import dataclasses

from bench import spec

SHAPES = {"attn": ((1, 16, 2, 16),), "decode": ((1, 16, 2, 16),),
          "ssd": ((1, 16, 2, 8, 8),)}
ARCH = {"moe": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                    head_dim=32, vocab=512,
                    moe={"num_experts": 8, "top_k": 2, "d_ff_expert": 128}),
        "ssm": dict(n_layers=2, d_model=64, vocab=256,
                    ssm={"d_state": 8, "head_dim": 16, "expand": 2,
                         "chunk": 8, "conv_width": 4})}
# the limits a tiny run is held to, by family: the mean served-token gap,
# set between the readings of seeds 1-12 on the CPU, every finished request
# compared: the program's largest (moe 0.00277, ssm 0.00005) against the
# fp8 control's smallest (moe 0.0184, ssm 0.0021).  At this size neither
# the widest gap (moe 0.556 against 0.433) nor the worst request's mean
# (moe 0.093 against 0.080, over requests of 4-12 tokens) separates the
# two: bf16 routing near ties swing them
LIMIT = {"moe": {"mean_logit_gap": 0.005}, "ssm": {"mean_logit_gap": 0.0003}}
# the SSM family's cell, kept under bench/ but not in BENCHMARK.json
# (PERF.md, open questions): its files, read as spec.cell reads a cell's
SSM_CELL = "mamba2-780m.sharegpt_c256"


def _files_cell(name: str):
    conf, mix = name.split(".", 1)
    read = spec._read
    return spec.Cell(name=name,
                     config=read(spec.BENCH / "configs" / f"{conf}.json"),
                     traffic=read(spec.BENCH / "traffic" / f"{mix}.json"),
                     chips=1,
                     limits=read(spec.BENCH / "limits" / f"{name}.json"),
                     end_to_end=(), per_layer=())


def cell(name: str, clients: int = 4):
    c = _files_cell(name) if name == SSM_CELL else spec.cell(name)
    mix = dict(c.traffic, clients=clients, max_len=48, pool=16,
               check_tokens=10 ** 6, check_requests=10 ** 6,
               prompt_tokens={"dist": "loguniform", "min": 8, "max": 32},
               output_tokens={"dist": "uniform", "min": 4, "max": 12})
    conf = dict(c.config, **ARCH[c.config["family"]])
    return dataclasses.replace(c, traffic=mix, config=conf,
                               limits=LIMIT[conf["family"]])


def run(name: str, seed: int = 7, seconds: float = 1.5, trace=False,
        clients: int = 4, **kw):
    from bench import run as bench_run
    import time
    return bench_run.run(cell(name, clients), seed, seconds, trace,
                         device="cpu",
                         t_start=time.perf_counter(),
                         calibration_shapes=SHAPES, **kw)
