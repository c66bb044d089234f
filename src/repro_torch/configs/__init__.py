"""Architecture configs: a copy of ``repro.configs`` (plain dataclasses, so
the port keeps its own copy instead of importing the JAX package).
``validate()`` and ``layer_kinds()`` behave as there."""
from .base import ArchConfig
from .registry import get_config, list_archs, smoke_config

__all__ = ["ArchConfig", "get_config", "list_archs", "smoke_config"]
