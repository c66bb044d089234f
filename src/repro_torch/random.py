"""A threefry2x32 clone of ``jax.random`` on key tensors.

The engine's stream derivation is part of its semantics: worker keys come
from ``split(rng, M+1)``, round keys from ``split(rng0, R)``, step keys from
``split(rng_round, K·M)`` and each step splits its key once more. This
module reproduces ``jax.random`` (threefry2x32, ``jax_threefry_partitionable
=True``) bit for bit, so whole trajectories can be held against the JAX
package from one seed:

* ``split(key, n)[i]``     = ``T(k0, k1, 0, i)`` (both output words);
* ``fold_in(key, d)``      = ``T(k0, k1, 0, d)``, the same words as
  ``split(key, d + 1)[d]``;
* ``bits(key, shape)[i]``  = ``y0 ^ y1`` with ``(y0, y1) = T(k0, k1, 0, i)``
  over the flat index ``i``;
* ``uniform``              = ``max(lo, fma(f, hi − lo, lo))`` with
  ``f = bitcast_f32((bits >> 9) | 0x3F800000) − 1`` (XLA fuses the scale
  and shift into one rounding; float64 reproduces it);
* ``normal``               = ``√2 · erfinv(uniform(nextafter(−1, 0), 1))``;
* ``gumbel``               = ``−log(−log(uniform(tiny, 1)))`` (JAX's default
  ``mode="low"``);
* ``categorical``          = ``argmax(gumbel + logits)`` over the last axis,
  the first maximum on ties (as XLA's argmax);
* ``bernoulli``            = ``uniform < p`` (JAX's default ``mode="low"``);
* ``randint``              = JAX's two-word draw: ``k1, k2 = split(key)``,
  ``(hi % span · mult + lo % span) % span`` in wrapping uint32 with
  ``hi, lo`` the bits of ``k1, k2`` and ``mult = (2¹⁶ % span)² % span``;
* ``loggamma``             = Marsaglia–Tsang per element (its own key from
  ``split(key, size)``), α < 1 boosted by ``log(U)/α``;
* ``dirichlet``            = ``softmax(loggamma(key, α, (*shape, G)))``.

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


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in`` for a 32-bit ``data``: the cipher on counter
    ``(0, data)``, both output words — ``split(key, data + 1)[data]``.

    >>> key = PRNGKey(5, device="cpu")
    >>> bool((fold_in(key, 7) == split(key, 8)[7]).all())
    True
    """
    data = int(data)
    if not 0 <= data <= _MASK:
        raise ValueError(f"fold_in data {data} is not a uint32 word")
    k0, k1 = _words(key)
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(k0), torch.full_like(
        k1, data))
    return torch.cat([y0, y1], dim=-1)


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


_TINY = float(np.finfo(np.float32).tiny)


def gumbel(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.gumbel`` in float32, ``mode="low"`` (JAX's default):
    ``−log(−log(u))`` with ``u = uniform(key, shape, tiny, 1)``. Not bit
    for bit: XLA's f32 ``log`` on the CPU is not correctly rounded (it
    differs from PyTorch's in ~14% of inputs, by an ulp), so ~23% of the
    draws differ by an ulp or two; an argmax over them (:func:`categorical`)
    flips only on a near-tie."""
    g = uniform(key, shape, _TINY, 1.0)
    return g.log_().neg_().log_().neg_()


def categorical(key: torch.Tensor, logits: torch.Tensor, shape=()
                ) -> torch.Tensor:
    """``jax.random.categorical(key, logits, shape=shape)`` over the last
    axis of ``logits`` (int32): ``argmax(gumbel(key, (*shape, V)) + logits)``
    with the first maximum taken on ties, as XLA's argmax does. ``logits``
    broadcasts against ``(*key_batch, *shape, V)``.

    >>> key = PRNGKey(0, device="cpu")
    >>> logits = torch.log(torch.tensor([0.0, 1.0, 0.0]))
    >>> categorical(split(key, 2), logits, (4,)).tolist()
    [[1, 1, 1, 1], [1, 1, 1, 1]]
    """
    shape = tuple(shape) + (logits.shape[-1],)
    g = gumbel(key, shape)
    g += logits.to(g.dtype)
    return torch.argmax(g, dim=-1).to(torch.int32)


def bernoulli(key: torch.Tensor, p, shape=()) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` (``mode="low"``, JAX's
    default): ``uniform(key, shape) < p`` in float32. ``p`` is a number or
    a float32 tensor that broadcasts against ``(*key_batch, *shape)``."""
    u = uniform(key, shape)
    return u < torch.as_tensor(p, dtype=torch.float32, device=u.device)


def randint(key: torch.Tensor, shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32), bit for
    bit: two 32-bit words per value folded into ``[minval, maxval)``.

    >>> v = randint(PRNGKey(0, device="cpu"), (6,), 0, 10)
    >>> v.dtype, bool(((v >= 0) & (v < 10)).all())
    (torch.int32, True)
    """
    shape = tuple(shape)
    lo_v, hi_v = int(minval), int(maxval)
    if not -(1 << 31) <= lo_v <= hi_v <= (1 << 31) - 1:
        raise ValueError(f"randint range [{lo_v}, {hi_v}) is not int32")
    k = split(key)
    higher, lower = bits(k[..., 0, :], shape), bits(k[..., 1, :], shape)
    span = max(hi_v - lo_v, 1) & _MASK
    mult = ((((1 << 16) % span) ** 2) & _MASK) % span    # uint32 wraps
    offset = ((higher % span) * mult & _MASK) + lower % span
    offset = (offset & _MASK) % span
    return (offset + lo_v).to(torch.int32)


def _gamma_one_log(keys: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """``jax.random``'s ``_gamma_one(key, alpha, log_space=True)`` for a
    flat batch of keys ``(N, 2)`` and concentrations ``(N,)`` (float32).
    Every element runs its own rejection loop; the batch loops until the
    last element accepts, finished elements keeping their state (what
    ``jax.vmap`` of a ``while_loop`` does)."""
    one = torch.ones_like(alpha)
    boost = alpha >= 1.0
    a = torch.where(boost, alpha, alpha + 1.0)
    d = a - np.float32(1.0 / 3.0)
    c = (torch.full_like(d, np.float32(1.0 / 3.0))
         / torch.sqrt(d.double()).float())
    k = split(keys)
    key, subkey = k[:, 0], k[:, 1]
    x_sq = torch.zeros_like(alpha)
    v_cub = one.clone()
    u = torch.full_like(alpha, 2.0)

    def rejected(x_sq, v_cub, u):
        return ((u >= 1.0 - np.float32(0.0331) * (x_sq * x_sq))
                & (torch.log(u) >= x_sq * 0.5
                   + d * (1.0 - v_cub + torch.log(v_cub))))

    todo = rejected(x_sq, v_cub, u)
    while bool(todo.any()):
        k3 = split(key, 3)
        x_key, u_key = k3[:, 1], k3[:, 2]
        key = torch.where(todo[:, None], k3[:, 0], key)
        x = torch.zeros_like(alpha)
        v = -one
        while bool((v <= 0.0).any()):
            redo = v <= 0.0
            k2 = split(x_key)
            x_new = normal(k2[:, 1], ())
            x = torch.where(redo, x_new, x)
            v = torch.where(redo, 1.0 + x_new * c, v)
            x_key = torch.where(redo[:, None], k2[:, 0], x_key)
        x_sq = torch.where(todo, x * x, x_sq)
        v_cub = torch.where(todo, v * v * v, v_cub)
        u = torch.where(todo, uniform(u_key, ()), u)
        todo = todo & rejected(x_sq, v_cub, u)
    log_samples = torch.log1p(-uniform(subkey, ()))
    log_boost = torch.where(boost | (log_samples == 0.0),
                            torch.zeros_like(alpha),
                            log_samples * (one / alpha))
    return torch.log(d) + torch.log(v_cub) + log_boost


def loggamma(key: torch.Tensor, a, shape=None) -> torch.Tensor:
    """``jax.random.loggamma(key, a, shape)`` for one key, in float32:
    element ``i`` (C order) draws with ``split(key, size)[i]``. Not bit for
    bit: the loop takes ``log`` of uniforms, and XLA's float32 ``log`` on
    the CPU is not correctly rounded (an ulp on ~14% of inputs), so the
    results differ in their last bits, and an acceptance test on the edge
    could flip (tests hold :func:`dirichlet` at a tolerance)."""
    a = torch.as_tensor(a, dtype=torch.float32, device=key.device)
    shape = tuple(a.shape) if shape is None else tuple(shape)
    if key.shape != (2,):
        raise ValueError("loggamma takes one key of shape (2,)")
    alpha = a.expand(shape).reshape(-1)
    keys = split(key, alpha.numel())
    return _gamma_one_log(keys, alpha).reshape(shape)


def dirichlet(key: torch.Tensor, alpha, shape=()) -> torch.Tensor:
    """``jax.random.dirichlet(key, alpha, shape)`` in float32: rows of
    ``shape + (G,)`` on the simplex, ``softmax`` over the last axis of
    :func:`loggamma` draws (exp of the shifted logs over their sum).

    >>> p = dirichlet(PRNGKey(0, device="cpu"), torch.full((4,), 0.5), (3,))
    >>> p.shape, bool(torch.allclose(p.sum(-1), torch.ones(3)))
    (torch.Size([3, 4]), True)
    """
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=key.device)
    logs = loggamma(key, alpha, tuple(shape) + tuple(alpha.shape[-1:]))
    e = torch.exp(logs - logs.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)
