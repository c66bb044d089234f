"""Tree-level wrapper of the fused server merge (port of the plain-mean
branch of ``repro.kernels.sync_compress.ops.sync_merge_stacked``).

The engine calls :func:`sync_merge_stacked` under ``codec_backend="fused"``
and ``core.adaseg.sync_weighted_stacked(backend="fused")`` calls it with
``normalize=True``. Codecs and robust merges come in a later slice.

Examples
--------
>>> import torch
>>> z = (torch.tensor([[1.0, 2.0], [3.0, 4.0]]),)
>>> sync_merge_stacked(z, torch.tensor([1.0, 3.0]), normalize=True)[0]
tensor([[2.5000, 3.5000],
        [2.5000, 3.5000]])
"""
from __future__ import annotations

from .kernel import merge_stacked


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
        z2 = zl.reshape(zl.shape[0], -1).contiguous()
        o2 = None if ol is None else ol.reshape(ol.shape[0], -1).contiguous()
        out2 = merge_stacked(z2, w, recv, o2, normalize=normalize)
        outs.append(out2.reshape(zl.shape))
    return tuple(outs)
