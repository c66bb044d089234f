"""Checkpointing: pytrees in the JAX package's msgpack layout, written and
read without the ``msgpack`` package."""
from .serialize import load_pytree, save_pytree

__all__ = ["load_pytree", "save_pytree"]
