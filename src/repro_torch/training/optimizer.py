"""AdamW with cosine / WSD schedules, ported from
``repro.training.optimizer``.

The arithmetic is the reference's, in fp32 and in its order: the clip scale
from one sum over the gradient leaves in ``jax.tree.leaves`` order
(``tree.leaves``), clipping before the moments, ``b ** step`` on an fp32
step, and ``m``/``v`` cast to the state dtype after each update.  WSD
(warmup-stable-decay) is the MiniCPM schedule.

One difference of form: ``apply_updates`` writes the new moments (and the
fp32 master copies) into the tensors of the state it is given and returns
that state with its step advanced.  The reference is functional and its
launcher donates the state to the step (``jax.jit(..., donate_argnums)``);
in place, the step needs no second copy of ``m`` and ``v`` (20 GB at
gemma-2b's full width).  New parameters are new tensors, as in the
reference: a caller may keep the old ones.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from . import tree


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    schedule: str = "cosine"          # "cosine" | "wsd" | "constant"
    decay_fraction: float = 0.1       # WSD: last 10% of steps decay
    state_dtype: str = "float32"      # "float32" | "bfloat16" (memory-bound)


class OptState(NamedTuple):
    step: torch.Tensor                # int32 scalar
    m: Any
    v: Any
    # fp32 master copies when params are stored bf16 (the optimizer updates
    # the master and writes back a bf16 cast)
    master: Any = None


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    if cfg.schedule == "wsd":
        decay_start = cfg.total_steps * (1.0 - cfg.decay_fraction)
        frac = torch.clamp((step - decay_start)
                           / max(cfg.total_steps - decay_start, 1), 0.0, 1.0)
        # exponential-style decay to 10% as in MiniCPM
        return cfg.lr * warm * torch.where(step < decay_start, 1.0,
                                           torch.pow(0.1, frac))
    # cosine
    prog = torch.clamp(step / max(cfg.total_steps, 1), 0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def init(params: Any, state_dtype=torch.float32,
         master: bool = False) -> OptState:
    """Zero moments of ``state_dtype`` (a torch dtype) beside each
    parameter, on its device; with ``master``, fp32 copies of the
    parameters."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=state_dtype, device=p.device)

    mw = (tree.map(lambda p: p.detach().to(torch.float32, copy=True), params)
          if master else None)
    step = torch.zeros((), dtype=torch.int32,
                       device=tree.leaves(params)[0].device)
    return OptState(step=step, m=tree.map(zeros, params),
                    v=tree.map(zeros, params), master=mw)


def global_norm(grads: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree.leaves(grads)))


@torch.no_grad()
def apply_updates(cfg: OptConfig, params: Any, grads: Any,
                  state: OptState) -> tuple[Any, OptState, dict]:
    """One AdamW step with global-norm clipping.  Returns (params, state,
    metrics); the state is ``state`` itself, its moments and master copies
    updated in place (see the module's note)."""
    gnorm = global_norm(grads)
    # a tensor numerator: ``float / tensor`` would round twice (a
    # reciprocal, then a product)
    scale = torch.clamp(torch.full_like(gnorm, cfg.grad_clip)
                        / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = lr_at(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)
    sd = torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32

    def upd(p, g, m, v, mw):
        g = g.to(torch.float32) * scale           # clipped, leaf by leaf
        m_new = (cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g).to(sd)
        v_new = (cfg.b2 * v.to(torch.float32)
                 + (1 - cfg.b2) * g * g).to(sd)
        mh = m_new.to(torch.float32) / b1c
        vh = v_new.to(torch.float32) / b2c
        ref = mw if mw is not None else p
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay \
            * ref.to(torch.float32)
        new_ref = ref.to(torch.float32) - lr * delta
        m.copy_(m_new)
        v.copy_(v_new)
        if mw is not None:
            mw.copy_(new_ref)
        return new_ref.to(p.dtype)

    flat_mw = (tree.leaves(state.master) if state.master is not None
               else [None] * len(tree.leaves(params)))
    new = [upd(p, g, m, v, mw) for p, g, m, v, mw in zip(
        tree.leaves(params), tree.leaves(grads), tree.leaves(state.m),
        tree.leaves(state.v), flat_mw)]
    return tree.unflatten(params, new), state._replace(step=step), \
        {"grad_norm": gnorm, "lr": lr}
