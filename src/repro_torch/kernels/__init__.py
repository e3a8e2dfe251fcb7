"""Attention kernels: hand-written CUDA (``csrc/``) built at first use,
their plain PyTorch versions (``ref``) and the dispatch between them (``ops``)."""
