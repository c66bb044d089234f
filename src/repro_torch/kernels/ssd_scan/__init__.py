"""Mamba2 SSD chunked scan (B13): the plain twins and the CUDA wrapper."""
