"""Fused LocalAdaSEG extragradient kernels (B1-B3): plain twins, CUDA
wrappers and tree-level entry points."""
