"""Deterministic synthetic data, a copy of ``repro.training.data``.

Seeded token streams with enough structure that the CE loss decreases
(repeated n-gram motifs and a skewed unigram distribution).  numpy only, so
a seed gives the reference's batches byte for byte; the caller moves them to
its device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from repro_torch.models.config import ArchConfig


@dataclasses.dataclass
class SyntheticDataset:
    cfg: ArchConfig
    batch: int
    seq_len: int
    seed: int = 0

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed)
        v = self.cfg.vocab
        # skewed unigram distribution + a bank of motifs to memorise
        probs = 1.0 / np.arange(1, min(v, 4096) + 1) ** 1.1
        probs /= probs.sum()
        motifs = [rng.integers(0, min(v, 4096), size=8) for _ in range(32)]
        while True:
            seq = rng.choice(min(v, 4096), size=(self.batch,
                                                 self.seq_len + 1), p=probs)
            # splice motifs in (predictable continuations)
            for b in range(self.batch):
                for _ in range(self.seq_len // 32):
                    m = motifs[rng.integers(0, len(motifs))]
                    pos = rng.integers(0, self.seq_len - len(m))
                    seq[b, pos:pos + len(m)] = m
            batch = {"tokens": seq[:, :-1].astype(np.int32),
                     "targets": seq[:, 1:].astype(np.int32)}
            if self.cfg.family == "audio":
                batch["frames"] = rng.standard_normal(
                    (self.batch, self.seq_len // 2, self.cfg.d_model)
                ).astype(np.float32) * 0.1
            if self.cfg.family == "vlm":
                batch["vision"] = rng.standard_normal(
                    (self.batch, self.cfg.n_vision_tokens, self.cfg.d_model)
                ).astype(np.float32) * 0.1
            yield batch
