"""Sync compressors for the uphill w·z̃ messages (port of
``repro.ps.compress``). Only the identity codec is ported in this slice;
quantize and top-k come with their kernels in a later one.
"""
from __future__ import annotations

import dataclasses


def dense_bytes(tree) -> float:
    """Wire size of an uncompressed float32 message.

    Examples
    --------
    >>> import torch
    >>> dense_bytes((torch.ones(4), torch.ones(2, 3)))
    40.0
    """
    return float(sum(4 * v.numel() for v in tree))


class SyncCompressor:
    """Lossy codec contract for the uphill sync messages."""

    name: str = "compressor"
    is_identity: bool = False

    def message_bytes(self, like) -> float:
        """Static wire size of one compressed message."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class IdentityCompressor(SyncCompressor):
    """No-op codec: the engine sends the dense weighted anchors.

    Examples
    --------
    >>> import torch
    >>> IdentityCompressor().message_bytes((torch.ones(3),))   # 3 × f32
    12.0
    """

    name: str = "identity"
    is_identity: bool = True

    def message_bytes(self, like) -> float:
        return dense_bytes(like)
