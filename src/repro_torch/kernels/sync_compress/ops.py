"""Tree-level wrappers of the sync kernels (port of
``repro.kernels.sync_compress.ops``).

The engine calls these under ``codec_backend="fused"``:
:func:`codec_uplink_stacked` runs the whole Line-5 uplink (weight, error
feedback, codec, residual) in fused passes per leaf,
:func:`sync_merge_stacked` the server side, plain or robust (``core.adaseg.
sync_weighted_stacked(backend="fused")`` calls it with ``normalize=True``),
and :func:`server_outer_apply` the server's outer-optimizer step. Under a
robust pipeline the engine calls the uplink and the merge with
``use_kernel=False`` for its reference backend, as the JAX package does.

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
    outer_apply,
    quantize_uplink,
    trimmed_merge_stacked,
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


def _krum_select(z2s, w, *, f, m_sel):
    """(Multi-)Krum selection on flat ``(M, n)`` leaves: score each
    included worker by the sum of its ``max(1, M − f − 2)`` smallest squared
    distances to the *other* included workers, keep the ``m_sel``
    lowest-scoring (ties to the lowest worker index, ``lax.top_k``'s order,
    through a stable sort) and return the ``(M,)`` 0/1 selection. Zero-weight
    lanes never enter the distance pool and are never selected. The
    distances are ``‖z_i‖² + ‖z_j‖² − 2·z_i·z_j`` with the Gram matrix as
    one f32 product (on the card TF32 must be off, as ``chip_smoke.py``
    sets it)."""
    m = z2s[0].shape[0]
    dev = z2s[0].device
    zc = torch.cat([zz.float() for zz in z2s], dim=1)
    sq = torch.sum(zc * zc, dim=1)
    d = sq[:, None] + sq[None, :] - 2.0 * (zc @ zc.T)
    incl = (torch.ones(m, device=dev) if w is None
            else torch.as_tensor(w, dtype=torch.float32, device=dev)) > 0
    eye = torch.eye(m, dtype=torch.bool, device=dev)
    pair = incl[None, :] & incl[:, None] & ~eye
    d = torch.where(pair, d, math.inf)
    nb = max(1, m - f - 2)
    score = torch.sum(torch.sort(d, dim=1)[0][:, :nb], dim=1)
    score = torch.where(incl, score, math.inf)
    idx = torch.sort(score, stable=True)[1][:min(m_sel, m)]
    sel = torch.zeros(m, dtype=torch.float32, device=dev)
    sel[idx] = 1.0
    return sel * incl.float()


def sync_merge_stacked(z, w=None, recv=None, old=None, *, normalize=False,
                       agg=None, use_kernel=True):
    """Weighted sum over the worker axis of every leaf of ``z`` (a tuple of
    ``(M, ...)`` leaves), broadcast back to every worker. ``recv`` (M,)
    gates delivery: non-receiving workers keep their ``old`` row (default:
    ``z``). ``use_kernel=False`` runs the plain versions directly.

    ``agg`` selects a robust merge instead of the weighted mean (the static
    specs of ``ps.robust`` aggregators; None is the historical mean):

    * ``("trimmed", b)``     — the per-coordinate ``b``-per-side trimmed
      weighted mean over the positive-weight lanes (the robust merge
      kernel; ``b = ⌊(M−1)/2⌋`` is the coordinate median);
    * ``("krum", f, m_sel)`` — multi-Krum: keep the ``m_sel`` workers with
      the smallest sum of ``max(1, M−f−2)`` nearest squared distances, then
      the survivors' renormalised weighted mean (the merge kernel).

    >>> z = (torch.tensor([[1.0], [9.0], [2.0], [3.0]]),)
    >>> out = sync_merge_stacked(z, torch.ones(4), agg=("trimmed", 1))
    >>> out[0][:, 0].tolist()
    [2.5, 2.5, 2.5, 2.5]
    """
    old_leaves = old if old is not None else (None,) * len(z)
    m = z[0].shape[0]
    dev = z[0].device
    if w is not None:
        w = torch.as_tensor(w, dtype=torch.float32, device=dev)
    if recv is not None:
        recv = torch.as_tensor(recv, dtype=torch.float32, device=dev)

    if agg is not None and agg[0] == "krum":
        sel = _krum_select([_flat2(zl) for zl in z], w, f=int(agg[1]),
                           m_sel=int(agg[2]))
        w = sel if w is None else w * sel
        agg, normalize = None, True     # mean over the Krum survivors

    outs = []
    if agg is not None:                 # ("trimmed", b)
        trim = int(agg[1])
        wt = torch.ones(m, dtype=torch.float32, device=dev) if w is None else w
        incl = (wt > 0).float()
        for zl, ol in zip(z, old_leaves):
            o2 = None if ol is None else _flat2(ol)
            if use_kernel:
                out2 = trimmed_merge_stacked(_flat2(zl), wt, incl, recv, o2,
                                             trim=trim)
            else:
                out2 = _ref.trimmed_merge_ref(
                    _flat2(zl), wt, incl, trim=trim,
                    recv=None if recv is None else recv > 0, old=o2)
            outs.append(out2.reshape(zl.shape))
        return tuple(outs)

    for zl, ol in zip(z, old_leaves):
        o2 = None if ol is None else _flat2(ol)
        if use_kernel:
            out2 = merge_stacked(_flat2(zl), w, recv, o2, normalize=normalize)
        else:
            out2 = _ref.merge_ref(_flat2(zl), w, normalize=normalize,
                                  recv=None if recv is None else recv > 0,
                                  old=o2)
        outs.append(out2.reshape(zl.shape))
    return tuple(outs)


def server_outer_apply(merged, z, mom, t, *, spec, use_kernel=True):
    """The server's outer-optimizer step on tuples of leaves: per leaf,
    ``Δ = merged − z`` and one moment update and step of the ``ps.
    server_opt`` policy ``spec`` (the outer-step kernel, or its plain
    version with ``use_kernel=False``).

    ``merged``/``z`` are server-space leaves (leading axis 1), ``mom`` a
    tuple of z-shaped moment tuples (1 for momentum/nesterov, 2 for adam),
    ``t`` the int32 count of outer steps taken so far. Returns ``(z_new,
    mom_new, t_new, eff_lr, delta_norm)``: ``eff_lr`` the policy's step
    size this round (Adam's with the bias correction folded in) and
    ``delta_norm = ‖Δ‖₂`` over all leaves.

    Nesterov's first step moves by lr·(1+β)·Δ off a zero moment:

    >>> z, merged = (torch.zeros(1, 3),), (torch.tensor([[1.0, -2.0, 0.5]]),)
    >>> zn, mn, tn, lr, dn = server_outer_apply(
    ...     merged, z, ((torch.zeros(1, 3),),), torch.tensor(0),
    ...     spec=("nesterov", 0.5, 0.8))
    >>> bool(torch.allclose(zn[0], 0.5 * 1.8 * merged[0], rtol=1e-6))
    True
    >>> int(tn), float(lr), round(float(dn), 4)
    (1, 0.5, 2.2913)
    """
    t_f = t.float()
    z_new, mom_new = [], [[] for _ in mom]
    dsq = torch.zeros((), dtype=torch.float32, device=t.device)
    apply = outer_apply if use_kernel else _ref.outer_apply_ref
    for i, (g, zl) in enumerate(zip(merged, z)):
        m2 = tuple(_flat2(ml[i]) for ml in mom)
        zn2, mn2, ds = apply(_flat2(g), _flat2(zl), m2, t_f, spec=spec)
        z_new.append(zn2.reshape(zl.shape))
        for s, mn in enumerate(mn2):
            mom_new[s].append(mn.reshape(zl.shape))
        dsq = dsq + ds
    t_new = t.to(torch.int32) + 1
    if spec[0] == "adam":
        _, lr, b1, b2, _ = spec
        bias = _ref.adam_bias(b1, b2, t_f)
        eff_lr = _ref.f32(lr) * _ref.sqrt_f32(bias[1]) / bias[0]
    else:
        eff_lr = torch.full((), _ref.f32(spec[1]), dtype=torch.float32,
                            device=t.device)
    return (tuple(z_new), tuple(tuple(v) for v in mom_new), t_new, eff_lr,
            _ref.sqrt_f32(dsq))


# ---------------------------------------------------------------------------
# HBM-traffic model: passes over the fleet's (M, n) payload per uplink, a
# read or a write of one (M, n) array counting as one pass.
# ---------------------------------------------------------------------------

#: passes per sync uplink: {codec: (reference, fused)}. The reference
#: column is the JAX package's model of its tree pipeline (message scale,
#: EF add, scale/select reduction, quantize/scatter, residual, each a sweep).
#: The fused column counts the port's kernels (``csrc/sync_compress.cu``):
#: identity, the merge (B5) reads the payload and writes the broadcast (2);
#: quantize, the scale pass (B6) reads z and ef, the quantize pass (B7)
#: reads z and ef and writes sent and ef (6); top-k, the eff pass (B8)
#: reads z and ef and writes eff, the mask pass (B9) reads eff and the
#: mask and writes sent and ef (7). The top-k selection between them (a
#: stable sort in plain PyTorch) is not a kernel and is not counted; the
#: JAX model's fused 8 counts its read of eff (ROADMAP C19).
CODEC_PASS_MODEL = {
    "identity": (4, 2),
    "quantize": (11, 6),
    "topk": (10, 7),
}


def codec_passes(codec) -> tuple[int, int]:
    """(reference, fused) HBM passes per uplink for a codec spec.

    >>> codec_passes(("quantize", 8)), codec_passes(("topk", 0.25))
    ((11, 6), (10, 7))
    """
    return CODEC_PASS_MODEL[_check_codec(codec)[0]]
