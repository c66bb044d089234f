"""Fused Line-7 server merge (B5): plain twin, CUDA wrapper and tree-level
entry point."""
