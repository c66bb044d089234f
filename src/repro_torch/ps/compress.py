"""Sync compressors: lossy codecs for the uphill w·z̃ messages (port of
``repro.ps.compress``).

The server sums the (decompressed) messages, so compressing the messages
keeps the Line-7 semantics exactly for the identity codec and degrades
them gracefully otherwise. :meth:`SyncCompressor.compress` returns the
decompressed message and :meth:`SyncCompressor.message_bytes` the wire
size the real codec would ship. Compressors with ``error_feedback=True``
get error feedback from the engine: the residual of round r is added to
the message of round r+1, so the compression error telescopes.

In the port ``compress`` sees the whole fleet's messages, a tuple of
``(M, ...)`` leaves, with ``(M, 2)`` per-worker keys — what the JAX engine
gets by vmapping its per-worker ``compress``. It is the reference codec:
the plain versions of ``kernels.sync_compress`` on the bare messages (no
weight, no residual). ``codec_spec`` is the static spec the fused kernels
take under ``codec_backend="fused"``. Both draw the stochastic rounding
from the codec stream of ``kernels.sync_compress.ref``, so they make the
same decisions.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..kernels.sync_compress.ops import codec_uplink_stacked, topk_keep


def dense_bytes(tree) -> float:
    """Wire size of an uncompressed float32 message.

    Examples
    --------
    >>> dense_bytes((torch.ones(4), torch.ones(2, 3)))
    40.0
    """
    return float(sum(4 * v.numel() for v in tree))


class SyncCompressor:
    """Lossy codec contract for the uphill sync messages.

    Examples
    --------
    >>> comp = TopKCompressor(fraction=0.5)
    >>> msg = (torch.tensor([[3.0, -0.1, -2.0, 0.2]]),)
    >>> comp.compress(msg, torch.zeros(1, 2, dtype=torch.int64))[0].tolist()
    [[3.0, 0.0, -2.0, 0.0]]
    """

    name: str = "compressor"
    error_feedback: bool = False
    is_identity: bool = False
    #: static spec for kernels.sync_compress (None = no fused path)
    codec_spec: tuple | None = None

    def compress(self, msg, rngs) -> tuple:
        """Lossy round-trip of every worker's message: ``msg`` a tuple of
        ``(M, ...)`` leaves, ``rngs`` ``(M, 2)`` keys."""
        raise NotImplementedError

    def message_bytes(self, like) -> float:
        """Static wire size of one worker's compressed message."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class IdentityCompressor(SyncCompressor):
    """No-op codec: the engine sends the dense weighted anchors.

    Examples
    --------
    >>> IdentityCompressor().message_bytes((torch.ones(3),))   # 3 × f32
    12.0
    """

    name: str = "identity"
    is_identity: bool = True

    @property
    def codec_spec(self) -> tuple:
        return ("identity",)

    def compress(self, msg, rngs) -> tuple:
        return msg

    def message_bytes(self, like) -> float:
        return dense_bytes(like)


@dataclasses.dataclass(frozen=True)
class StochasticQuantizeCompressor(SyncCompressor):
    """Per-leaf stochastic uniform quantization to ``bits`` bits
    (QSGD-style): values are scaled by the leaf's max-abs, rounded
    stochastically to one of 2^bits − 1 levels, and shipped with one f32
    scale per leaf.

    Examples
    --------
    >>> comp = StochasticQuantizeCompressor(bits=8)
    >>> comp.name
    'q8'
    >>> msg = (torch.tensor([[1.0, -0.3, 0.004]]),)
    >>> out = comp.compress(msg, torch.zeros(1, 2, dtype=torch.int64))
    >>> bool((out[0] - msg[0]).abs().max() <= 1.0 / 255)
    True
    >>> comp.message_bytes((torch.zeros(100),))   # 9 bits each + scale
    117.0
    """

    bits: int = 8
    name: str = "quantize"
    error_feedback: bool = True

    def __post_init__(self):
        if not 1 <= self.bits <= 16:
            raise ValueError(f"bits must be in [1, 16], got {self.bits}")
        object.__setattr__(self, "name", f"q{self.bits}")

    @property
    def codec_spec(self) -> tuple:
        return ("quantize", self.bits)

    def compress(self, msg, rngs) -> tuple:
        return codec_uplink_stacked(msg, rngs, codec=self.codec_spec,
                                    use_kernel=False)[0]

    def message_bytes(self, like) -> float:
        # bits magnitude levels + 1 sign bit per entry, one f32 scale per leaf
        return float(sum(math.ceil(v.numel() * (self.bits + 1) / 8) + 4
                         for v in like))


@dataclasses.dataclass(frozen=True)
class TopKCompressor(SyncCompressor):
    """Keep the top ``fraction`` of entries of each leaf by magnitude (ties
    to the lowest index), zero the rest; the wire format is (index, value)
    pairs. Biased, which is why it runs under error feedback.

    Examples
    --------
    >>> comp = TopKCompressor(fraction=0.5)
    >>> comp.compress((torch.tensor([[5.0, 1.0, -3.0, 0.5]]),),
    ...               None)[0].tolist()
    [[5.0, 0.0, -3.0, 0.0]]
    >>> comp.message_bytes((torch.zeros(100),))   # (idx, value) pairs
    400.0
    """

    fraction: float = 0.1
    name: str = "topk"
    error_feedback: bool = True

    def __post_init__(self):
        if not 0.0 < self.fraction <= 1.0:
            raise ValueError(f"fraction must be in (0, 1], got {self.fraction}")
        object.__setattr__(self, "name", f"top{self.fraction:g}")

    @property
    def codec_spec(self) -> tuple:
        return ("topk", self.fraction)

    def compress(self, msg, rngs) -> tuple:
        return codec_uplink_stacked(msg, rngs, codec=self.codec_spec,
                                    use_kernel=False)[0]

    def message_bytes(self, like) -> float:
        return float(sum(8 * topk_keep(v.numel(), self.fraction)
                         for v in like))


def check_codec_backend(codec_backend: str,
                        compressor: SyncCompressor | None) -> None:
    """Validate a ``codec_backend`` against a compressor: the fused path
    needs a static :attr:`SyncCompressor.codec_spec`.

    Examples
    --------
    >>> check_codec_backend("fused", TopKCompressor(0.1))   # fine
    >>> check_codec_backend("turbo", None)
    Traceback (most recent call last):
        ...
    ValueError: unknown codec backend 'turbo'
    """
    if codec_backend not in ("reference", "fused"):
        raise ValueError(f"unknown codec backend {codec_backend!r}")
    if (codec_backend == "fused" and compressor is not None
            and compressor.codec_spec is None):
        raise ValueError(
            f"compressor {compressor.name!r} exports no codec_spec — the "
            "fused codec backend only covers the built-in codecs "
            "(identity / stochastic quantize / top-k)"
        )
