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
values (``w``, ``scale``, ``alive``) are ``(M,)`` and keys ``(M, 2)``. The
server's outer step takes the server leaf ``(1, n)``.

Two roundings follow what XLA emits for the JAX package's codec. The
effective message ``eff = w·z + ef`` is rounded once, as XLA rounds the
fused multiply-add: the product of two float32 values is exact in float64,
so the sum is formed there and rounded once to float32. And the level step
``scale / levels`` is ``scale`` times the float32 reciprocal of
``levels``, as XLA rewrites a division by a constant.

The outer step (:func:`outer_apply_ref`) rounds as XLA on the CPU rounds
the JAX package's: each ``a·b + c`` of the update is one fused
multiply-add (``β·m + Δ``, ``z + lr·m′``, Adam's ``β₁·m + (1−β₁)·Δ``),
Adam's bias factors ``1 − β^(t+1)`` are f32 ``pow`` (:func:`adam_bias`,
computed once per step and handed to the kernel, so the kernel and this
version divide by the same numbers), and at ``lr = 1`` Adam's
``(m̂)/(√v̂ + ε)`` is ``m′ / ((1 − β₁^(t+1))·(√v̂ + ε))``, XLA's rewrite of
``(a / b) / c``.

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


def f32(x: float) -> float:
    """``x`` rounded to float32 (the JAX package's ``jnp.float32(x)``)."""
    return float(np.float32(x))


def fma_f32(a, b, c):
    """``a·b + c`` rounded once to float32 (the product of two float32
    values is exact in float64): the fused multiply-add XLA emits."""
    return (a * b.double() + c.double()).float()


def sqrt_f32(x):
    """Correctly rounded float32 square root (PyTorch's float32 ``sqrt``
    on the CPU is off by an ulp for about 0.6% of inputs; XLA's and the
    card's are not)."""
    return torch.sqrt(x.double()).float()


def effective_message(z, ef=None, w=None):
    """The effective message the codec sees, ``w·z + ef``, rounded once.
    Without ``w`` it is ``z + ef``, without ``ef`` it is ``w·z``: one
    rounding each already."""
    if w is None:
        return z if ef is None else z + ef
    wb = per_worker(w, z)
    if ef is None:
        return wb * z
    return fma_f32(wb, z, ef)


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
    mag = (lo + up.to(eff.dtype)) * (sc * f32(1.0 / levels))
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


def trimmed_merge_ref(z, w, incl, *, trim, recv=None, old=None):
    """The robust server merge on one stacked leaf ``(M, n)``: the
    per-coordinate trimmed weighted mean, by the sort-free stable rank

        rank_i = Σ_k incl_k · [z_kj < z_ij  or  (z_kj = z_ij and k < i)]

    among the included rows (``incl`` 0/1; excluded rows never enter the
    order and are never kept). The trim per side is ``b = min(trim,
    ⌊(n_incl − 1)/2⌋)``; rows with ``b ≤ rank ≤ n_incl − 1 − b`` survive,
    and the output is their ``w``-weighted mean, renormalised per
    coordinate over the survivors' weight, broadcast to every row.
    ``trim = ⌊(M−1)/2⌋`` is the coordinate median. ``recv``/``old`` gate
    delivery as in :func:`merge_ref`.

    >>> z = torch.tensor([[1.0], [9.0], [2.0], [3.0]])
    >>> out = trimmed_merge_ref(z, torch.ones(4), torch.ones(4), trim=1)
    >>> out[:, 0].tolist()
    [2.5, 2.5, 2.5, 2.5]
    """
    m = z.shape[0]
    zf = z.float()
    wf = torch.as_tensor(w, dtype=torch.float32, device=z.device)
    inclf = torch.as_tensor(incl, dtype=torch.float32, device=z.device)
    n_incl = torch.sum(inclf)
    b = torch.clamp(torch.floor((n_incl - 1.0) * 0.5), max=float(trim))
    row_ids = torch.arange(m, device=z.device).reshape(
        (m,) + (1,) * (z.ndim - 1))
    rank = torch.zeros_like(zf)
    for k in range(m):                        # streaming: one row per pass
        zk = zf[k:k + 1]
        less = (zk < zf) | ((zk == zf) & (k < row_ids))
        rank = rank + inclf[k] * less.float()
    keep = ((rank >= b) & (rank <= n_incl - 1.0 - b)
            & (per_worker(inclf, zf) > 0.0))
    wk = per_worker(wf, zf) * keep.float()
    denom = torch.clamp(torch.sum(wk, dim=0, keepdim=True), min=1e-30)
    mean = torch.sum(wk * zf, dim=0, keepdim=True) / denom
    merged = mean.expand(z.shape).to(z.dtype)
    if recv is None:
        return merged.contiguous()
    return torch.where(per_worker(recv, z), merged, z if old is None else old)


def adam_bias(b1: float, b2: float, t) -> torch.Tensor:
    """Adam's bias factors ``[1 − β₁^(t+1), 1 − β₂^(t+1)]`` (float32, on
    ``t``'s device) for the f32 round count ``t`` before the step."""
    t_new = t.float() + 1.0

    def factor(beta):
        # a device-side fill, not a host copy: this runs inside CUDA graphs
        base = torch.full((), beta, dtype=torch.float32, device=t.device)
        return 1.0 - torch.pow(base, t_new)

    return torch.stack([factor(b1), factor(b2)])


def outer_apply_ref(merged, z, mom, t, *, spec):
    """The server's outer-optimizer step on one server leaf ``(1, n)``:
    the round delta ``Δ = merged − z`` and one moment update + step of the
    policy in ``spec`` (``ps.server_opt`` tuples). ``mom`` holds the moment
    leaves (1 for momentum/nesterov, 2 for adam), ``t`` the f32 round count
    *before* this step. Returns ``(z_new, mom_new, delta_sq)`` with
    ``delta_sq = Σ Δ²`` this leaf's share of ‖Δ‖².

    >>> z, g = torch.zeros(1, 2), torch.tensor([[1.0, -2.0]])
    >>> zn, mn, dsq = outer_apply_ref(g, z, (torch.zeros(1, 2),),
    ...                               torch.tensor(0.0),
    ...                               spec=("momentum", 0.5, 0.9))
    >>> zn.tolist(), mn[0].tolist(), float(dsq)
    ([[0.5, -1.0]], [[1.0, -2.0]], 5.0)
    """
    kind = spec[0]
    zz = z.float()
    d = merged.float() - zz
    if kind in ("momentum", "nesterov"):
        _, lr, beta = spec
        lr, beta = f32(lr), f32(beta)
        m_new = fma_f32(beta, mom[0].float(), d)
        step = m_new if kind == "momentum" else fma_f32(beta, m_new, d)
        z_new = fma_f32(lr, step, zz)
        mom_new = (m_new.to(mom[0].dtype),)
    elif kind == "adam":
        _, lr, b1, b2, eps = spec
        bias = adam_bias(b1, b2, t)
        m_new = fma_f32(f32(b1), mom[0].float(), f32(1.0 - b1) * d)
        v_new = fma_f32(f32(b2), mom[1].float(), f32(1.0 - b2) * d * d)
        # Full-shape divisors: PyTorch on the CPU divides by a 0-d tensor
        # as a multiplication by its reciprocal.
        bc1, bc2 = (bias[i].expand(d.shape) for i in range(2))
        den = sqrt_f32(v_new / bc2) + f32(eps)
        if f32(lr) == 1.0:
            z_new = zz + m_new / (bc1 * den)
        else:
            z_new = zz + f32(lr) * (m_new / bc1) / den
        mom_new = (m_new.to(mom[0].dtype), v_new.to(mom[1].dtype))
    else:
        raise ValueError(f"unknown server-opt spec {spec!r}")
    return z_new.to(z.dtype), mom_new, torch.sum(d * d)

