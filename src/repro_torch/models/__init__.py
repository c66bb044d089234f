"""Models (port of ``repro.models``, training path of decoder-only
stacks): layers, attention with the flash kernel, the Mamba2, RG-LRU and
MoE layers, the transformer, language models as problems and
:class:`ModelWorker`."""
from .problem import make_eval_loss, make_lm_problem, tiny_lm_config
from .transformer import forward, init_model, loss_fn, param_leaves, param_tree
from .worker import ModelWorker

__all__ = [
    "ModelWorker",
    "forward",
    "init_model",
    "loss_fn",
    "make_eval_loss",
    "make_lm_problem",
    "param_leaves",
    "param_tree",
    "tiny_lm_config",
]
