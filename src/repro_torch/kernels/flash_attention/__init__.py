"""Flash-attention forward (B12): the plain twin and the CUDA wrapper."""
