"""Robust server aggregators: alternative Line-7 merge modes (port of
``repro.ps.robust.aggregators``; pure Python, the port's own copy).

A :class:`RobustAggregator` names *how the server combines* the fleet's
uplinks. It is a thin, hashable policy object: the math lives in the
``kernels.sync_compress`` merge (CUDA kernel + plain PyTorch version), and
an aggregator resolves, for a static fleet width ``m``, to the static merge
spec ``sync_merge_stacked(agg=...)`` understands:

* ``None``               — the exact historical weighted mean. Every
  aggregator returns this at zero robustness budget (β=0 trimming, f=0
  Krum selecting everyone, median of ≤2 lanes), which is what makes the
  clean-fleet degradation guarantee *bit-exact*: the engine runs the very
  same merge it always did.
* ``("trimmed", b)``     — b-per-side per-coordinate trimmed weighted
  mean (:class:`TrimmedMean`; :class:`CoordinateMedian` is the maximal
  trim ``b = ⌊(m−1)/2⌋``).
* ``("krum", f, m_sel)`` — multi-Krum selection then survivor mean
  (:class:`MultiKrum`).

``reject_frac(m)`` reports the fraction of lanes the aggregator discards
per round (per coordinate for trims, per lane for Krum). ``fingerprint``
is checkpointed like the optimizer fingerprint, so a resume cannot
silently change the merge semantics mid-run.
"""
from __future__ import annotations

import dataclasses
import math
import zlib


class RobustAggregator:
    """Protocol for server-side robust merge policies.

    Subclasses implement :meth:`spec` (the static merge spec at fleet width
    ``m`` — ``None`` means "exactly the weighted mean") and ``name``;
    :meth:`reject_frac` and ``fingerprint`` derive from those.

    Examples
    --------
    >>> from repro_torch.ps.robust import TrimmedMean, WeightedMean
    >>> TrimmedMean(beta=0.25).spec(8)
    ('trimmed', 2)
    >>> TrimmedMean(beta=0.0).spec(8) is None   # zero budget ⇒ exact mean
    True
    >>> WeightedMean().fingerprint == WeightedMean().fingerprint
    True
    """

    def spec(self, num_workers: int):
        """Static merge spec at fleet width ``num_workers`` — ``None`` for
        the exact historical weighted mean."""
        raise NotImplementedError

    def reject_frac(self, num_workers: int) -> float:
        """Fraction of lanes discarded per merge (0.0 = none)."""
        s = self.spec(num_workers)
        if s is None:
            return 0.0
        if s[0] == "trimmed":
            return min(1.0, 2 * s[1] / num_workers)
        return (num_workers - s[2]) / num_workers

    @property
    def name(self) -> str:
        raise NotImplementedError

    @property
    def fingerprint(self) -> int:
        """crc32 of the canonical description (checkpoint compatibility
        check, like the worker/sampler fingerprints)."""
        return zlib.crc32(self.name.encode()) & 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class WeightedMean(RobustAggregator):
    """The paper's Line-7 merge itself: 1/η-weighted mean, no rejection.
    The do-nothing aggregator (``spec`` is always ``None``), so configs can
    name the default explicitly.

    >>> from repro_torch.ps.robust import WeightedMean
    >>> WeightedMean().spec(16) is None, WeightedMean().reject_frac(16)
    (True, 0.0)
    """

    @property
    def name(self) -> str:
        return "weighted_mean"

    def spec(self, num_workers: int):
        return None


@dataclasses.dataclass(frozen=True)
class TrimmedMean(RobustAggregator):
    """β-trimmed per-coordinate weighted mean: drop the ``b = ⌊β·m⌋``
    smallest and largest values of every coordinate, renormalize the
    surviving weight mass. β=0 degrades bit-exactly to the weighted mean;
    β must stay < 0.5 (you cannot trim more than everything).

    >>> from repro_torch.ps.robust import TrimmedMean
    >>> agg = TrimmedMean(beta=0.2)
    >>> agg.spec(10), agg.reject_frac(10)
    (('trimmed', 2), 0.4)
    >>> agg.spec(4)        # ⌊0.2·4⌋ = 0 ⇒ exact mean at this width
    """

    beta: float

    def __post_init__(self):
        if not 0.0 <= self.beta < 0.5:
            raise ValueError(f"beta must be in [0, 0.5), got {self.beta}")

    @property
    def name(self) -> str:
        return f"trimmed_mean(beta={self.beta})"

    def trim_count(self, num_workers: int) -> int:
        return int(math.floor(self.beta * num_workers))

    def spec(self, num_workers: int):
        b = self.trim_count(num_workers)
        return None if b == 0 else ("trimmed", b)


@dataclasses.dataclass(frozen=True)
class CoordinateMedian(RobustAggregator):
    """Per-coordinate weighted median — the maximal trimmed mean,
    ``b = ⌊(m−1)/2⌋``: only the middle one (odd fleets) or two (even
    fleets) order statistics survive. At m ≤ 2 the median of the fleet *is*
    the mean, so ``spec`` degrades to ``None`` there.

    >>> from repro_torch.ps.robust import CoordinateMedian
    >>> CoordinateMedian().spec(5)
    ('trimmed', 2)
    >>> CoordinateMedian().spec(2) is None
    True
    """

    @property
    def name(self) -> str:
        return "coordinate_median"

    def trim_count(self, num_workers: int) -> int:
        return (num_workers - 1) // 2

    def spec(self, num_workers: int):
        b = self.trim_count(num_workers)
        return None if b == 0 else ("trimmed", b)


@dataclasses.dataclass(frozen=True)
class MultiKrum(RobustAggregator):
    """(Multi-)Krum: score each worker by the sum of its ``max(1, m−f−2)``
    smallest squared distances to other workers, keep the ``m_select``
    (default ``m − f``) best-scoring, then take their renormalized weighted
    mean. ``f`` is the number of adversaries defended against; ``f=0``
    selecting the whole fleet degrades bit-exactly to the weighted mean.

    >>> from repro_torch.ps.robust import MultiKrum
    >>> MultiKrum(f=2).spec(10)
    ('krum', 2, 8)
    >>> MultiKrum(f=0).spec(10) is None
    True
    >>> MultiKrum(f=1, m_select=1).spec(4)   # classic single-Krum
    ('krum', 1, 1)
    """

    f: int
    m_select: int | None = None

    def __post_init__(self):
        if self.f < 0:
            raise ValueError(f"f must be >= 0, got {self.f}")
        if self.m_select is not None and self.m_select < 1:
            raise ValueError(
                f"m_select must be >= 1, got {self.m_select}")

    @property
    def name(self) -> str:
        return f"multi_krum(f={self.f},m_select={self.m_select})"

    def selected(self, num_workers: int) -> int:
        if self.m_select is not None:
            return min(self.m_select, num_workers)
        return max(1, num_workers - self.f)

    def spec(self, num_workers: int):
        m_sel = self.selected(num_workers)
        if self.f == 0 and m_sel >= num_workers:
            return None
        return ("krum", self.f, m_sel)
