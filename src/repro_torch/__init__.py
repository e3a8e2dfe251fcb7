"""PyTorch/CUDA port of the ``repro`` package.

It imports nothing of ``repro`` and no JAX. Entry points run on the CUDA
device unless the caller passes ``device="cpu"``; attention runs through
hand-written CUDA kernels on the card and their plain PyTorch versions on
the CPU.
"""
