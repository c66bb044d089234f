"""Minimax problem instances (the paper's §4.1 bilinear game)."""
from .bilinear import BilinearGame, make_bilinear_game

__all__ = ["BilinearGame", "make_bilinear_game"]
