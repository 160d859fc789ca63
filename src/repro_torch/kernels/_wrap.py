"""Argument checks shared by the CUDA kernel wrappers: each raises on what
its kernel does not take, before a pointer reaches the kernel."""

from __future__ import annotations

import torch

HEAD_DIMS = (16, 32, 48, 64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
NO_WINDOW = 2 ** 30


def check_no_grad(what: str, lifted_by: str, *inputs: torch.Tensor) -> None:
    """Raises where autograd would need a kernel's gradient that the port
    does not have: the output is filled through ctypes and carries no
    ``grad_fn``, so a backward pass through it would drop the gradient of
    every input without a word.  ``lifted_by`` names the work that would
    give the kernel its backward.  Checked before the device, so that a CPU
    tensor shows it too.  Only decode attention refuses: flash attention
    and the SSD intra-chunk pass have their backward kernels."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in inputs):
        raise RuntimeError(
            f"{what}: an input requires grad, and the CUDA kernel has no "
            f"backward pass; {lifted_by} (run the forward under "
            "torch.no_grad() to serve)")


def check_bthd(name: str, x: torch.Tensor, dtype: torch.dtype,
               device: torch.device) -> None:
    """A (B,T,H,D) kernel operand: on ``device``, of ``dtype``, with dense
    head and feature axes (any batch and sequence strides)."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} is {x.dtype}, expected {dtype}")
    if x.dim() != 4:
        raise ValueError(f"{name} must be (B,T,H,D), got {tuple(x.shape)}")
    if x.stride(3) != 1 or x.stride(2) != x.shape[3]:
        raise ValueError(f"{name} needs dense head and feature axes, got "
                         f"strides {x.stride()}")
    # rows are loaded 16 bytes at a time
    per16 = 16 // x.element_size()
    if x.data_ptr() % 16 or x.stride(0) % per16 or x.stride(1) % per16:
        raise ValueError(f"{name} must start on 16 bytes and keep its batch "
                         f"and sequence strides {x.stride()[:2]} multiples "
                         f"of {per16} elements")


def check_lengths(lengths, b: int, device: torch.device) -> torch.Tensor:
    lengths = torch.as_tensor(lengths, device=device)
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be ({b},), got {tuple(lengths.shape)}")
    return lengths.to(torch.int32).contiguous()


def check_common(q: torch.Tensor, window) -> int:
    """Checks shared by both attention kernels; returns the window as the
    kernel's int32 (``NO_WINDOW`` for None)."""
    if q.device.type != "cuda":
        raise ValueError(
            f"the CUDA kernel takes CUDA tensors, got {q.device}; "
            "ops.* sends CPU tensors to the plain version")
    if q.dtype not in DTYPES:
        raise ValueError(f"unsupported dtype {q.dtype}: float32 or bfloat16")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[-1]} not in {HEAD_DIMS}")
    w = NO_WINDOW if window is None else int(window)
    if not -2 ** 31 <= w < 2 ** 31:
        raise ValueError(f"window {w} does not fit the kernel's int32")
    return w


def raise_on_error(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed with cudaError_t {err}")
