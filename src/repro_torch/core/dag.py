"""The port's copy of ``repro.core.dag``.

DNN-as-DAG representation used by the HiDP partitioners.

The paper models a DNN as a DAG ``D(L_i) = {L1, L2, ..., Li}`` whose nodes are
layers and whose edges are tensors (§III System Model).  Partitioning operates
on *blocks*: contiguous groups of layers (model partitioning, width ``ω``) or
replicated sub-models over split input data (data partitioning, ``σ``
sub-models).

Every block is annotated with the quantities the cost model needs:

* ``flops``        — forward FLOPs for one inference of the block
* ``param_bytes``  — weight bytes that must be resident/transferred to run it
* ``bytes_in``     — activation bytes entering the block (the tensor edge)
* ``bytes_out``    — activation bytes leaving the block

These are filled analytically — from layer hyper-parameters for the paper's
CNNs (``edge_models.py``) and from the LM configs for the TPU tier
(``models/model.py:block_costs``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Sequence


@dataclasses.dataclass(frozen=True)
class Block:
    """One partitionable unit (a layer or fused group of layers)."""

    name: str
    flops: float                 # forward FLOPs for one request through the block
    param_bytes: float           # resident weight bytes
    bytes_in: float              # input activation bytes
    bytes_out: float             # output activation bytes
    # Data partitioning metadata: can the block's *input* be split spatially /
    # batch-wise, and what fraction of bytes_out must be exchanged between
    # neighbouring data partitions to stay exact (halo / boundary rows for
    # convs, zero for pure batch splits, full for attention over shared ctx).
    data_splittable: bool = True
    halo_fraction: float = 0.0
    # Tags used by the local partitioner's affinity table (the TPU analogue of
    # "CPU-friendly layer"): e.g. "attn", "ffn", "moe", "ssm", "conv", "embed".
    kind: str = "generic"

    def scaled(self, fraction: float) -> "Block":
        """A proportional slice of this block (data partitioning)."""
        return dataclasses.replace(
            self,
            flops=self.flops * fraction,
            bytes_in=self.bytes_in * fraction,
            bytes_out=self.bytes_out * fraction,
        )


@dataclasses.dataclass(frozen=True)
class ModelDAG:
    """A linearised DAG: the paper's models (CNN chains and LM stacks) are
    sequential at block granularity, so topological order == list order.

    Residual/branchy interiors (Inception mixed blocks, MoE routers, parallel
    attn+SSM) are *fused into* one Block — partition points only exist at
    block boundaries, exactly as in the paper (blocks are "executable
    groups of layers").
    """

    name: str
    blocks: tuple[Block, ...]
    input_bytes: float           # bytes of one request's input
    output_bytes: float          # bytes of the final prediction

    # ------------------------------------------------------------------ totals
    @property
    def total_flops(self) -> float:
        return sum(b.flops for b in self.blocks)

    @property
    def total_param_bytes(self) -> float:
        return sum(b.param_bytes for b in self.blocks)

    def __len__(self) -> int:
        return len(self.blocks)

    # ------------------------------------------------------------- block maths
    def segment(self, start: int, stop: int) -> Block:
        """Fuse blocks[start:stop] into a single block (a model partition)."""
        if not 0 <= start < stop <= len(self.blocks):
            raise ValueError(f"bad segment [{start}, {stop}) of {len(self.blocks)}")
        seg = self.blocks[start:stop]
        return Block(
            name=f"{self.name}[{start}:{stop}]",
            flops=sum(b.flops for b in seg),
            param_bytes=sum(b.param_bytes for b in seg),
            bytes_in=seg[0].bytes_in,
            bytes_out=seg[-1].bytes_out,
            data_splittable=all(b.data_splittable for b in seg),
            halo_fraction=max(b.halo_fraction for b in seg),
            kind=seg[0].kind if len({b.kind for b in seg}) == 1 else "mixed",
        )

    def dominant_kind(self) -> str:
        """The block kind carrying the most FLOPs — picks the affinity row
        (and the calibration bucket) when collapsing the DAG to one rate."""
        flops_by_kind: dict[str, float] = {}
        for b in self.blocks:
            flops_by_kind[b.kind] = flops_by_kind.get(b.kind, 0.0) + b.flops
        return (max(flops_by_kind, key=flops_by_kind.get)
                if flops_by_kind else "generic")

    def cumulative_flops(self) -> list[float]:
        out, acc = [0.0], 0.0
        for b in self.blocks:
            acc += b.flops
            out.append(acc)
        return out

    def validate(self) -> None:
        """Edge-consistency: bytes_out of block i must equal bytes_in of i+1."""
        for a, b in zip(self.blocks, self.blocks[1:]):
            if not math.isclose(a.bytes_out, b.bytes_in, rel_tol=1e-6):
                raise ValueError(
                    f"DAG {self.name}: edge mismatch {a.name}.bytes_out="
                    f"{a.bytes_out} != {b.name}.bytes_in={b.bytes_in}"
                )


def chain(name: str, blocks: Iterable[Block], input_bytes: float,
          output_bytes: float, *, validate: bool = True) -> ModelDAG:
    dag = ModelDAG(name=name, blocks=tuple(blocks), input_bytes=input_bytes,
                   output_bytes=output_bytes)
    if validate:
        dag.validate()
    return dag


# --------------------------------------------------------------------------
# Partition descriptions (output of the DP partitioners, input to execution)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelPartition:
    """Model partitioning: contiguous stages, pipelined across resources.

    ``boundaries`` are cut points: stage i = blocks[boundaries[i]:boundaries[i+1]].
    ``assignment[i]`` is the index of the resource executing stage i.
    """
    mode: str = dataclasses.field(default="model", init=False)
    boundaries: tuple[int, ...] = ()
    assignment: tuple[int, ...] = ()
    predicted_latency: float = float("inf")

    @property
    def num_stages(self) -> int:
        return len(self.boundaries) - 1


@dataclasses.dataclass(frozen=True)
class DataPartition:
    """Data partitioning: σ parallel sub-models, fractions per resource.

    ``fractions[i]`` is the share of the request's data assigned to resource
    ``assignment[i]``; fractions sum to 1.
    """
    mode: str = dataclasses.field(default="data", init=False)
    fractions: tuple[float, ...] = ()
    assignment: tuple[int, ...] = ()
    predicted_latency: float = float("inf")

    @property
    def num_splits(self) -> int:
        return len(self.fractions)


Partition = ModelPartition | DataPartition
