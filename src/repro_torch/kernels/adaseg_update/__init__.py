"""Fused LocalAdaSEG extragradient kernels (B1-B4): plain twins, CUDA
wrappers and tree-level entry points."""
