"""Minimax problem instances: the paper's §4.1 bilinear game, the
quadratic saddle, distributionally-robust logistic regression and the §5
WGAN-GP."""
from .bilinear import BilinearGame, game_from_arrays, make_bilinear_game
from .quadratic import (
    QuadraticGame,
    make_quadratic_game,
    quadratic_game_from_arrays,
)
from .robust import (
    RobustLogistic,
    make_robust_logistic,
    robust_logistic_from_arrays,
)
from .wgan import WGANProblem, make_wgan_problem

__all__ = [
    "BilinearGame",
    "QuadraticGame",
    "RobustLogistic",
    "WGANProblem",
    "game_from_arrays",
    "make_bilinear_game",
    "make_quadratic_game",
    "make_robust_logistic",
    "make_wgan_problem",
    "quadratic_game_from_arrays",
    "robust_logistic_from_arrays",
]
