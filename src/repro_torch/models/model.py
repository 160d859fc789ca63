"""The port's model API, ``repro.models.model.Model`` for the dense, SSM and
hybrid families.

``build_model(cfg)`` returns a ``Model`` exposing ``init``, ``init_cache``
and the three step kinds ``apply_train / apply_prefill / apply_decode``.
The analytic ``step_flops`` and ``block_costs`` (the planner bridge) come
with the profiling/planning slice.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import device as _device
from . import transformer
from .config import ArchConfig

FAMILIES = ("dense", "ssm", "hybrid")
# the slice that ports each family the port does not serve yet
_LATER = {"moe": "the MoE slice", "audio": "the encoder-decoder/VLM slice",
          "vlm": "the encoder-decoder/VLM slice"}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    def __post_init__(self):
        if self.cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"{self.cfg.name}: the {self.cfg.family!r} family is ported "
                f"with {_LATER[self.cfg.family]}; this port serves "
                f"{', '.join(FAMILIES)}")

    # ------------------------------------------------------------------ params
    def init(self, generator: torch.Generator, device="cuda",
             dtype: torch.dtype = torch.float32) -> dict:
        """Seeded parameters on ``device``; matmul weights, embeddings and
        the SSM mixer's A_log/D/dt_bias/norm in ``dtype``, norm weights
        fp32.  ``generator`` must live on ``device``."""
        dev = _device.resolve(device)
        return transformer.init_params(self.cfg, generator, dev, dtype)

    def init_cache(self, batch: int, max_len: int, device="cuda") -> dict:
        return transformer.init_cache(self.cfg, batch, max_len,
                                      _device.resolve(device))

    # ------------------------------------------------------------------- steps
    def apply_train(self, params: dict, batch: dict) -> torch.Tensor:
        """Logits (B, T, V) fp32 over the whole sequence."""
        out, _ = transformer.forward(self.cfg, params, batch["tokens"],
                                     mode="train")
        return out

    def apply_prefill(self, params: dict, batch: dict
                      ) -> tuple[torch.Tensor, dict]:
        """Last-position logits (B, 1, V) and the prompt's cache
        (``transformer.forward``)."""
        return transformer.forward(self.cfg, params, batch["tokens"],
                                   mode="prefill",
                                   lengths=batch.get("lengths"),
                                   logits_tail=1)

    def apply_decode(self, params: dict, cache: dict, batch: dict
                     ) -> tuple[torch.Tensor, dict]:
        """One token per sequence at position ``lengths-1``; ``cache`` is
        updated in place and returned."""
        return transformer.forward(self.cfg, params, batch["tokens"],
                                   mode="decode", cache=cache,
                                   lengths=batch["lengths"])


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
