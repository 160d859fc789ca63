"""HiDP on PyTorch and CUDA: the port of the ``repro`` package to an NVIDIA
H100.

The package imports ``torch`` and never ``jax``, and nothing of ``repro``: it
keeps its own copies of the configuration dataclasses and of the pure layers
its paths need (the HiDP planner in ``core``, the analyzer in ``profiling``,
the plan cache in ``serving``).  Its layout follows ``repro`` so each
module's counterpart is found under the same name.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""
