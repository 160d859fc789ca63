"""Kernels of the port (attention, the SSD intra-chunk pass and the SSD
decode step): hand-written CUDA for the H100 (``csrc/``), their plain
PyTorch versions (``ref``) and the dispatch the models call (``ops``)."""
