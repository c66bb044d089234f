"""Wrapper of the fused server-merge CUDA kernel (``csrc/sync_compress.cu``;
port of ``repro.kernels.sync_compress.kernel.merge_stacked``).

A CPU tensor goes to :func:`.ref.merge_ref`; a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import torch

from .. import _build
from .._build import I, P
from .ref import merge_ref

MERGE = _build.Kernel("merge_stacked", "sync_compress.cu",
                      "merge_stacked_launch", [P, P, P, P, P, I, I, I, I, P])

#: the kernel keeps the M weights in (default-sized) shared memory
MAX_ROWS = 12 * 1024


def merge_stacked(z, w=None, recv=None, old=None, *, normalize=False):
    """Fused Line-7 merge on a stacked ``(M, n)`` leaf: Σ_m w_m z[m] (w
    normalised when asked) broadcast to every row; rows whose ``recv`` is
    falsy keep ``old`` (default ``z``)."""
    if z.device.type == "cpu":
        return merge_ref(z, w, normalize=normalize,
                         recv=None if recv is None else recv > 0, old=old)
    rows, n = z.shape
    dev = z.device
    wf = (None if w is None
          else torch.as_tensor(w, dtype=torch.float32, device=dev)
          .contiguous())
    rf = (None if recv is None
          else torch.as_tensor(recv, device=dev).to(torch.float32)
          .contiguous())
    if recv is not None and old is None:
        old = z
    if recv is None:
        old = None
    _build.check_cuda_f32("merge_stacked", z, wf, rf, old)
    for v in (wf, rf):
        if v is not None and v.shape != (rows,):
            raise ValueError(f"merge_stacked: per-worker vector of shape "
                             f"{tuple(v.shape)}, expected {(rows,)}")
    if old is not None and old.shape != z.shape:
        raise ValueError("merge_stacked: old must have the shape of z")
    if n == 0 or not 0 < rows <= MAX_ROWS:
        raise ValueError(f"merge_stacked: unsupported shape {(rows, n)}")
    out = torch.empty_like(z)
    vec = int(n % 4 == 0 and _build.aligned16(z, old, out))

    def ptr(t):
        return None if t is None else t.data_ptr()

    MERGE(z.data_ptr(), ptr(wf), ptr(rf), ptr(old), out.data_ptr(), rows, n,
          int(normalize), vec, _build.stream_of(z))
    return out
