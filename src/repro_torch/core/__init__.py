"""Core library: LocalAdaSEG on a worker-stacked fleet state."""
from . import metrics, projections, tree
from .adaseg import (
    AdaSEGConfig,
    AdaSEGState,
    StepAux,
    eta_of,
    init,
    local_step,
    run_local_adaseg,
    sync_state,
    sync_weighted_stacked,
    weighted_worker_average,
)
from .metrics import kkt_residual
from .types import MinimaxProblem, draw, from_loss
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
    "from_loss",
    "init",
    "kkt_residual",
    "local_step",
    "metrics",
    "projections",
    "run_local_adaseg",
    "sync_state",
    "sync_weighted_stacked",
    "tree",
    "weighted_worker_average",
]
