"""Optimizer zoo (the paper's Fig. 4 baselines) and its door into the
port's Parameter-Server runtime: ``MinimaxWorker`` lifts any zoo optimizer
onto ``repro_torch.ps.PSEngine``."""
from .base import (
    MinimaxOptimizer,
    MinimaxWorker,
    OptState,
    average_stacked,
    base_init,
    minibatch,
    run_local,
    run_serial,
)
from .methods import adam_minimax, asmp, segda, sgda, ump

__all__ = [
    "MinimaxOptimizer",
    "MinimaxWorker",
    "OptState",
    "adam_minimax",
    "asmp",
    "average_stacked",
    "base_init",
    "minibatch",
    "run_local",
    "run_serial",
    "segda",
    "sgda",
    "ump",
]
