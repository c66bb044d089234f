"""Plain PyTorch version of the fused server merge (port of
``repro.kernels.sync_compress.ref.merge_ref``)."""
from __future__ import annotations

import torch

from ...core.tree import per_worker


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
