"""Fused kernels: plain PyTorch twins (``ref.py``), CUDA wrappers
(``kernel.py``, sources in ``repro_torch/csrc``) and tree-level entry
points (``ops.py``). A wrapper runs its plain twin for CPU tensors and
launches its CUDA kernel for CUDA tensors, or raises."""
