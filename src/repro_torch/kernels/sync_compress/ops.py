"""Tree-level wrappers of the sync kernels (port of
``repro.kernels.sync_compress.ops``).

The engine calls these under ``codec_backend="fused"``:
:func:`codec_uplink_stacked` runs the whole Line-5 uplink (weight, error
feedback, codec, residual) in fused passes per leaf and
:func:`sync_merge_stacked` the server side (``core.adaseg.
sync_weighted_stacked(backend="fused")`` calls it with ``normalize=True``).
Robust merges come in a later slice.

Codecs are static specs, as ``ps.compress`` compressors export them:

* ``("identity",)``      — the uplink is just the w-scaling;
* ``("quantize", bits)`` — stochastic quantization: a scale pass, then the
  quantize pass with the codec stream's uniforms drawn in-kernel;
* ``("topk", fraction)`` — top-k: an eff pass, the index selection here,
  then the mask pass.

Keys: ``rngs`` are the engine's ``(M, 2)`` per-worker codec keys; each
worker's leaf keys are ``split(rngs[m], L)`` in leaf order, as the JAX
package and the reference compressors derive them.

Examples
--------
>>> import torch
>>> from repro_torch import random as jr
>>> z = (torch.tensor([[0.5, -1.0, 2.0], [1.5, 0.25, -0.75]]),)
>>> ef = (torch.zeros(2, 3),)
>>> w = torch.tensor([0.25, 0.75])
>>> rngs = jr.split(jr.PRNGKey(0, device="cpu"), 2)
>>> sent, ef_new = codec_uplink_stacked(z, rngs, w=w, ef=ef,
...                                     codec=("topk", 0.5))
>>> sent[0].tolist()
[[0.0, -0.25, 0.5], [1.125, 0.0, -0.5625]]
>>> sync_merge_stacked(sent)[0].tolist()          # server sum, broadcast
[[1.125, -0.25, -0.0625], [1.125, -0.25, -0.0625]]
"""
from __future__ import annotations

import math

import torch

from ... import random as jr
from . import ref as _ref
from .kernel import (
    eff_uplink,
    mask_uplink,
    merge_stacked,
    quantize_uplink,
    uplink_stats,
)

_CODECS = ("identity", "quantize", "topk")


def _check_codec(codec):
    if not (isinstance(codec, tuple) and codec and codec[0] in _CODECS):
        raise ValueError(f"unknown codec spec {codec!r}")
    return codec


def _flat2(leaf):
    """Worker-stacked leaf (M, ...) → contiguous (M, n)."""
    return leaf.reshape(leaf.shape[0], -1).contiguous()


def topk_keep(n: int, fraction: float) -> int:
    """Entries kept per worker and leaf: ``max(1, ceil(fraction·n))``."""
    return max(1, int(math.ceil(fraction * n)))


def _eff2(z2, w, e2, use_kernel):
    """The effective message of a flat leaf (``z2`` itself when there is
    neither weight nor residual)."""
    if w is None and e2 is None:
        return z2
    return eff_uplink(z2, w, e2) if use_kernel else _ref.eff_uplink_ref(
        z2, e2, w)


def _topk_mask(eff2, fraction):
    """Per-worker top-k keep mask ``(M, n)`` uint8 on a flat leaf: the k
    largest magnitudes, ties to the lowest index — ``lax.top_k``'s order,
    through a stable descending sort (``torch.topk`` promises none)."""
    k = topk_keep(eff2.shape[1], fraction)
    order = torch.sort(eff2.abs(), dim=1, descending=True, stable=True)[1]
    mask = torch.zeros(eff2.shape, dtype=torch.uint8, device=eff2.device)
    return mask.scatter_(1, order[:, :k], 1)


def codec_uplink_stacked(payload, rngs, w=None, ef=None, alive=None, *,
                         codec, use_kernel=True):
    """The Line-5 uplink of M stacked workers: per leaf, apply the Line-7
    weight ``w`` (M,), add the error-feedback residual ``ef``, run the
    codec and write the new residual.

    ``payload``/``ef`` are tuples of ``(M, ...)`` leaves; ``rngs`` ``(M, 2)``
    keys (read by the stochastic codec only); ``alive`` (M,) masks dead
    workers, which send zeros and keep their residual (the identity codec
    ignores it). Returns ``(sent, ef_new)``, ``ef_new`` None without
    ``ef`` (and ``ef`` itself for the identity codec). ``use_kernel=False``
    runs the plain versions of :mod:`.ref` directly."""
    kind = _check_codec(codec)[0]
    leaves = tuple(payload)
    ef_leaves = tuple(ef) if ef is not None else (None,) * len(leaves)
    if kind == "quantize":
        levels = float(2 ** codec[1] - 1)
        leaf_keys = jr.split(rngs, len(leaves))              # (M, L, 2)

    sents, ef_news = [], []
    for li, (z, e) in enumerate(zip(leaves, ef_leaves)):
        z2 = _flat2(z)
        e2 = None if e is None else _flat2(e)
        if kind == "identity":
            sent2, ef2 = _eff2(z2, w, e2, use_kernel), e2
        elif kind == "quantize":
            keys = leaf_keys[:, li]                          # (M, 2)
            if use_kernel:
                scale = torch.clamp(uplink_stats(z2, w, e2), min=1e-30)
                sent2, ef2 = quantize_uplink(z2, keys, scale, w, e2, alive,
                                             levels=levels)
            else:
                scale = torch.clamp(_ref.uplink_stats_ref(z2, e2, w),
                                    min=1e-30)
                sent2, ef2 = _ref.quantize_uplink_ref(
                    z2, keys, scale, levels=levels, ef=e2, w=w, alive=alive)
        else:                                                # topk
            eff2 = _eff2(z2, w, e2, use_kernel)
            mask2 = _topk_mask(eff2, codec[1])
            if use_kernel:
                sent2, ef2 = mask_uplink(eff2, mask2, e2, alive)
            else:
                sent2, ef2 = _ref.mask_uplink_ref(eff2, mask2, alive=alive,
                                                  ef=e2)
        sents.append(sent2.reshape(z.shape))
        ef_news.append(None if e2 is None else ef2.reshape(z.shape))
    return tuple(sents), (tuple(ef_news) if ef is not None else None)


def codec_uplink(payload, rng, w=None, ef=None, alive=None, *, codec,
                 use_kernel=True):
    """Single-worker form of :func:`codec_uplink_stacked`: leaves without
    the worker axis, ``w``/``alive`` scalars, ``rng`` one ``(2,)`` key."""
    dev = rng.device
    p1 = tuple(v[None] for v in payload)
    e1 = None if ef is None else tuple(v[None] for v in ef)
    w1 = (None if w is None
          else torch.as_tensor(w, dtype=torch.float32, device=dev).reshape(1))
    a1 = (None if alive is None
          else torch.as_tensor(alive, dtype=torch.float32,
                               device=dev).reshape(1))
    sent, ef_new = codec_uplink_stacked(p1, rng.reshape(1, 2), w1, e1, a1,
                                        codec=codec, use_kernel=use_kernel)
    sent = tuple(v[0] for v in sent)
    if ef_new is not None:
        ef_new = tuple(v[0] for v in ef_new)
    return sent, ef_new


def sync_merge_stacked(z, w=None, recv=None, old=None, *, normalize=False,
                       agg=None):
    """Weighted sum over the worker axis of every leaf of ``z`` (a tuple of
    ``(M, ...)`` leaves), broadcast back to every worker. ``recv`` (M,)
    gates delivery: non-receiving workers keep their ``old`` row (default:
    ``z``)."""
    if agg is not None:
        raise NotImplementedError(
            "robust merges (agg=...) are ported in a later slice")
    old_leaves = old if old is not None else (None,) * len(z)
    outs = []
    for zl, ol in zip(z, old_leaves):
        o2 = None if ol is None else _flat2(ol)
        out2 = merge_stacked(_flat2(zl), w, recv, o2, normalize=normalize)
        outs.append(out2.reshape(zl.shape))
    return tuple(outs)
