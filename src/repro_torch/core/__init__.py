"""Core library: LocalAdaSEG on a worker-stacked fleet state."""
from . import projections, tree
from .adaseg import (
    AdaSEGConfig,
    AdaSEGState,
    StepAux,
    eta_of,
    init,
    local_step,
    run_local_adaseg,
    sync_weighted_stacked,
    weighted_worker_average,
)
from .types import MinimaxProblem, draw
from .worker import AdaSEGWorker, LocalWorker

__all__ = [
    "AdaSEGConfig",
    "AdaSEGState",
    "AdaSEGWorker",
    "LocalWorker",
    "MinimaxProblem",
    "StepAux",
    "draw",
    "eta_of",
    "init",
    "local_step",
    "projections",
    "run_local_adaseg",
    "sync_weighted_stacked",
    "tree",
    "weighted_worker_average",
]
