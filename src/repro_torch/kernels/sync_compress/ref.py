"""Plain PyTorch versions of the sync-codec kernels and the server merge
(port of ``repro.kernels.sync_compress.ref``), and the codec's shared
random stream.

Stochastic quantization draws one uniform per element from

    bits(i)    = threefry2x32(k0, k1, x0=i, x1=0)[0]
    uniform(i) = bitcast_f32((bits(i) >> 9) | 0x3F800000) − 1   ∈ [0, 1)

with ``(k0, k1)`` the leaf key and ``i`` the element's index in its row.
This is not :func:`repro_torch.random.bits`: there the index goes in the
second counter word and the result is ``y0 ^ y1``. Both codec backends,
and the CUDA kernel, draw from this one stream, so they make the same
rounding decisions on the same inputs.

The plain versions take a worker-stacked flat leaf ``(M, n)``; per-worker
values (``w``, ``scale``, ``alive``) are ``(M,)`` and keys ``(M, 2)``.

Two roundings follow what XLA emits for the JAX package's codec. The
effective message ``eff = w·z + ef`` is rounded once, as XLA rounds the
fused multiply-add: the product of two float32 values is exact in float64,
so the sum is formed there and rounded once to float32. And the level step
``scale / levels`` is ``scale`` times the float32 reciprocal of
``levels``, as XLA rewrites a division by a constant.

Examples
--------
>>> import torch
>>> keys = torch.tensor([[0, 7], [0, 8]])
>>> u = threefry_uniform(keys, 5)
>>> u.shape, bool(((u >= 0) & (u < 1)).all())
(torch.Size([2, 5]), True)
>>> z = torch.tensor([[0.5, -1.0, 0.25]])
>>> sent, ef = mask_uplink_ref(z, torch.tensor([[1, 0, 1]], dtype=torch.uint8))
>>> sent.tolist(), ef.tolist()
([[0.5, 0.0, 0.25]], [[0.0, -1.0, 0.0]])
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.tree import per_worker
from ...random import threefry2x32

_MANTISSA = 0x3F800000


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words (held in int64) → float32 uniforms in [0, 1): the top
    23 bits become the mantissa of a float in [1, 2), minus 1."""
    mant = ((bits >> 9) | _MANTISSA).to(torch.int32)
    return mant.view(torch.float32) - 1.0


def threefry_uniform(key: torch.Tensor, n: int) -> torch.Tensor:
    """The codec stream: ``uniform(i)`` for ``i < n`` under each key of
    ``key`` (``(..., 2)`` int64 words) → ``(..., n)``."""
    k0, k1 = key[..., 0:1], key[..., 1:2]
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, _ = threefry2x32(k0, k1, idx, torch.zeros_like(idx))
    return bits_to_uniform(y0)


def effective_message(z, ef=None, w=None):
    """The effective message the codec sees, ``w·z + ef``, rounded once.
    Without ``w`` it is ``z + ef``, without ``ef`` it is ``w·z``: one
    rounding each already."""
    if w is None:
        return z if ef is None else z + ef
    wb = per_worker(w, z)
    if ef is None:
        return wb * z
    return (wb.double() * z.double() + ef.double()).float()


def _alive_rows(alive, like):
    a = alive if alive.dtype == torch.bool else alive > 0
    return per_worker(a, like)


def _gate(eff, sent, ef, alive):
    """Dead rows send zeros and keep ``ef`` (zeros when there is none)."""
    if alive is None:
        return sent, eff - sent
    ok = _alive_rows(alive, eff)
    sent = torch.where(ok, sent, 0.0)
    old = torch.zeros_like(eff) if ef is None else ef
    return sent, torch.where(ok, eff - sent, old)


def uplink_stats_ref(z, ef=None, w=None):
    """Per-worker ``max|w·z + ef|`` ``(M,)``: the quantizer's scale, before
    the caller's 1e-30 clamp."""
    return torch.amax(effective_message(z, ef, w).abs(), dim=1)


def quantize_uplink_ref(z, keys, scale, *, levels: float, ef=None, w=None,
                        alive=None):
    """Stochastic uniform quantization of ``eff = w·z + ef`` to ``levels``
    magnitude levels against the per-worker ``scale``, with the codec
    stream's uniforms. Returns ``(sent, ef_new)``: ``ef_new = eff − sent``
    for live rows and the frozen ``ef`` for dead ones, which send zeros."""
    eff = effective_message(z, ef, w)
    sc = per_worker(scale, eff)
    y = eff.abs() / sc * levels
    lo = torch.floor(y)
    up = threefry_uniform(keys, eff.shape[1]) < (y - lo)
    # The level step scale / levels is scale times the float32 reciprocal
    # of levels: XLA rewrites a division by a constant that way.
    mag = (lo + up.to(eff.dtype)) * (sc * float(np.float32(1.0 / levels)))
    sent = torch.sign(eff) * mag
    return _gate(eff, sent, ef, alive)


def eff_uplink_ref(z, ef=None, w=None):
    """The materialised effective message ``w·z + ef`` (top-k pass 1)."""
    return effective_message(z, ef, w)


def mask_uplink_ref(eff, mask, *, alive=None, ef=None):
    """Keep the masked entries of ``eff`` and write the complement back as
    the new residual (top-k pass 2), with the aliveness semantics of
    :func:`quantize_uplink_ref`."""
    sent = torch.where(mask != 0, eff, 0.0)
    return _gate(eff, sent, ef, alive)


def merge_ref(z, w=None, *, normalize=False, recv=None, old=None):
    """Weighted sum over the workers of one stacked leaf ``(M, ...)``,
    broadcast back to every row.

    ``w`` is ``(M,)`` raw weights (None = unit), divided by their sum when
    ``normalize``. ``recv`` (``(M,)`` bool) selects the rows that receive
    the sum; the others keep ``old`` (default: ``z``).
    """
    if w is None:
        wb = torch.ones(z.shape[0], dtype=torch.float32, device=z.device)
    else:
        wb = torch.as_tensor(w, dtype=torch.float32, device=z.device)
    if normalize:
        wb = wb / torch.sum(wb)
    mean = torch.sum(per_worker(wb.to(z.dtype), z) * z, dim=0, keepdim=True)
    merged = mean.expand(z.shape)
    if recv is None:
        return merged.contiguous()
    return torch.where(per_worker(recv, z), merged, z if old is None else old)
