"""Training launcher (port of ``repro.launch``): a :class:`TrainPlan` as a
Parameter-Server engine on the serial path."""
from .train import TrainPlan, make_ps_engine

__all__ = ["TrainPlan", "make_ps_engine"]
