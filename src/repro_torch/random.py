"""A threefry2x32 clone of ``jax.random`` on key tensors.

The engine's stream derivation is part of its semantics: worker keys come
from ``split(rng, M+1)``, round keys from ``split(rng0, R)``, step keys from
``split(rng_round, K·M)`` and each step splits its key once more. This
module reproduces ``jax.random`` (threefry2x32, ``jax_threefry_partitionable
=True``) bit for bit, so whole trajectories can be held against the JAX
package from one seed:

* ``split(key, n)[i]``     = ``T(k0, k1, 0, i)`` (both output words);
* ``bits(key, shape)[i]``  = ``y0 ^ y1`` with ``(y0, y1) = T(k0, k1, 0, i)``
  over the flat index ``i``;
* ``uniform``              = ``max(lo, fma(f, hi − lo, lo))`` with
  ``f = bitcast_f32((bits >> 9) | 0x3F800000) − 1`` (XLA fuses the scale
  and shift into one rounding; float64 reproduces it);
* ``normal``               = ``√2 · erfinv(uniform(nextafter(−1, 0), 1))``.

Keys are int64 tensors of shape ``(..., 2)`` holding uint32 words (PyTorch's
uint32 lacks the arithmetic, so the cipher runs in int64 and masks with
``0xFFFFFFFF``). Leading key dimensions are batch dimensions: a draw of
``shape`` under keys ``(M, 2)`` returns ``(M, *shape)``, worker ``m`` drawn
with its own key — what ``jax.vmap`` over keys gives.

Examples
--------
>>> key = PRNGKey(0, device="cpu")
>>> key.tolist()
[0, 0]
>>> split(key, 3).shape
torch.Size([3, 2])
>>> u = uniform(split(key, 4), (5,), -1.0, 1.0)
>>> u.shape, bool((u >= -1).all() and (u < 1).all())
(torch.Size([4, 5]), True)
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ._device import resolve_device

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# Counter elements per chunk of a draw: bounds the int64 temporaries of a
# large draw (the 16384² coupling matrix) to a few hundred MiB.
_CHUNK = 1 << 24


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) on int64 tensors holding uint32 words;
    all arguments broadcast. Returns the two output words ``(y0, y1)``."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = (((x1 << r) & _MASK) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def PRNGKey(seed: int, *, device="cuda") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the key ``(0, seed mod 2³²)`` for a
    seed in the int32 range (JAX's default, 32-bit mode)."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed {seed} is outside the int32 range")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64,
                        device=resolve_device(device))


def _words(key: torch.Tensor):
    if key.dtype != torch.int64 or key.shape[-1:] != (2,):
        raise ValueError(
            f"a key is an int64 tensor of shape (..., 2), got {key.dtype} "
            f"{tuple(key.shape)}"
        )
    return key[..., 0:1], key[..., 1:2]                  # (..., 1) each


def _hash(key: torch.Tensor, total: int, fn) -> torch.Tensor:
    """``fn(y0, y1)`` over counters ``(0, i)``, ``i < total``, per key. The
    counter axis of the result follows the key's batch axes. Chunked over
    the counters."""
    k0, k1 = _words(key)
    axis = key.ndim - 1
    out = None
    for start in range(0, total, _CHUNK):
        count = min(_CHUNK, total - start)
        idx = torch.arange(start, start + count, dtype=torch.int64,
                           device=key.device)
        part = fn(*threefry2x32(k0, k1, idx >> 32, idx & _MASK))
        if count == total:
            return part
        if out is None:
            shape = list(part.shape)
            shape[axis] = total
            out = torch.empty(shape, dtype=part.dtype, device=key.device)
        out.narrow(axis, start, count).copy_(part)
    return out


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``(..., 2)`` keys → ``(..., num, 2)``."""
    return _hash(key, num, lambda y0, y1: torch.stack([y0, y1], dim=-1))


def bits(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.bits`` (uint32 words, held in int64)."""
    shape = tuple(shape)
    flat = _hash(key, math.prod(shape), lambda y0, y1: y0 ^ y1)
    return flat.reshape(key.shape[:-1] + shape)


def _unit(y0, y1):
    """Bits → f32 in [0, 1): the top 23 bits become the mantissa of a
    float in [1, 2), minus 1."""
    mant = (((y0 ^ y1) >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


def uniform(key: torch.Tensor, shape=(), minval=0.0, maxval=1.0
            ) -> torch.Tensor:
    """``jax.random.uniform`` in float32."""
    shape = tuple(shape)
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    span, lo64 = (hi - lo).double(), lo.double()

    def scale(y0, y1):
        # f·span is exact in float64, so one rounding to float32 after the
        # add is the fused multiply-add XLA emits.
        return torch.maximum(lo, (_unit(y0, y1).double() * span + lo64)
                             .float())

    flat = _hash(key, math.prod(shape), scale)
    return flat.reshape(key.shape[:-1] + shape)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def normal(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.normal`` in float32 (erfinv transform; agrees with XLA's
    erfinv to a few ulps, not bit for bit)."""
    return _SQRT2 * torch.erfinv(uniform(key, shape, _NORMAL_LO, 1.0))
