"""Carry state across from the JAX package as numpy arrays.

The port imports nothing of JAX: a caller turns the JAX objects into numpy
(``np.asarray`` on each array) and these functions build the port's
counterparts from them.

Examples
--------
>>> import numpy as np
>>> key_from_numpy(np.array([0, 7], dtype=np.uint32), device="cpu").tolist()
[0, 7]
"""
from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .core.adaseg import AdaSEGState
from .problems.bilinear import BilinearGame, game_from_arrays


def key_from_numpy(key, *, device="cuda") -> torch.Tensor:
    """A uint32 ``(..., 2)`` JAX key array as the port's int64 key tensor."""
    arr = np.asarray(key)
    if arr.dtype != np.uint32 or arr.shape[-1:] != (2,):
        raise ValueError(f"expected uint32 keys of shape (..., 2), got "
                         f"{arr.dtype} {arr.shape}")
    return torch.as_tensor(arr.astype(np.int64), device=resolve_device(device))


def game_from_numpy(a, b, c, sigma: float, *, device="cuda",
                    name: str = "bilinear") -> BilinearGame:
    """The bilinear game with the given coefficients (``a`` (n, n), ``b``
    and ``c`` (n,), float32)."""
    dev = resolve_device(device)

    def t(v):
        return torch.as_tensor(np.array(v, dtype=np.float32), device=dev)

    return game_from_arrays(t(a), t(b), t(c), float(sigma), name)


def state_from_numpy(fields, *, device="cuda") -> AdaSEGState:
    """A worker-stacked :class:`AdaSEGState` from a mapping (or namedtuple)
    of numpy arrays with the JAX state's field names; the iterate fields
    are sequences of leaves."""
    dev = resolve_device(device)
    if not isinstance(fields, dict):
        fields = fields._asdict()

    def t(v, dtype):
        return torch.as_tensor(np.array(v, dtype=dtype), device=dev)

    return AdaSEGState(
        z_tilde=tuple(t(v, np.float32) for v in fields["z_tilde"]),
        sum_sq=t(fields["sum_sq"], np.float32),
        t=t(fields["t"], np.int32),
        z_bar=tuple(t(v, np.float32) for v in fields["z_bar"]),
        grad_sq_sum=t(fields["grad_sq_sum"], np.float32),
        worker_id=t(fields["worker_id"], np.int32),
    )
