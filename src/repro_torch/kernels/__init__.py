"""Kernels of the port (attention and the SSD intra-chunk pass):
hand-written CUDA for the H100 (``csrc/``), their plain PyTorch versions
(``ref``) and the dispatch the models call (``ops``)."""
