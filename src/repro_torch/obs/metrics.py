"""Counter/gauge/histogram registry with JSONL and in-memory sinks (port of
``repro.obs.metrics``).

The engine emits its quantitative telemetry here (bytes up and down,
effective local steps, η spread, hostile-fleet and outer-step gauges) and,
for the sync, a *modeled* cost next to the measured round wall time: HBM
passes per uplink from the traffic model of ``kernels.sync_compress``
(:func:`~repro_torch.kernels.sync_compress.ops.codec_passes`), converted to
seconds at the card's bandwidth (:data:`repro_torch.hardware.HBM_BW`). So
one record answers "how long did the round take, and how long does the
traffic model say the uplink's memory traffic takes on the card".

Records are plain dicts (``kind``/``name``/``value``/``labels`` and
optional ``t_wall``/``t_sim``) kept in memory, in the JAX package's
format; :meth:`MetricsRegistry.save_jsonl` writes one per line and
:meth:`MetricsRegistry.load_jsonl` reads them back. Emission is host-side
only and reads values the engine has already copied to the host, so
metrics cannot change results (``tests/test_torch_obs.py`` pins it).

Examples
--------
>>> reg = MetricsRegistry()
>>> reg.inc("bytes_up", 80.0, engine="sync")
>>> reg.inc("bytes_up", 40.0, engine="sync")
>>> reg.set_gauge("eta_spread", 1.5)
>>> reg.observe("staleness", 2.0)
>>> reg.total("bytes_up"), reg.last("eta_spread")
(120.0, 1.5)
>>> reg.histogram("staleness")["count"]
1
"""
from __future__ import annotations

import json
import math
from typing import Any


class MetricsRegistry:
    """In-memory metric sink with counter/gauge/histogram semantics;
    ``enabled=False`` records nothing.

    Examples
    --------
    >>> reg = MetricsRegistry()
    >>> reg.inc("steps", 12, worker="0")
    >>> reg.total("steps")
    12.0
    >>> off = MetricsRegistry(enabled=False)
    >>> off.inc("steps", 12)
    >>> off.records
    []
    """

    def __init__(self, *, enabled: bool = True):
        self.enabled = bool(enabled)
        self.records: list[dict] = []

    # -- emission -----------------------------------------------------------

    def emit(self, kind: str, name: str, value: float,
             t_wall: float | None = None, t_sim: float | None = None,
             **labels: Any) -> None:
        if not self.enabled:
            return
        rec: dict = {"kind": kind, "name": name, "value": float(value)}
        if labels:
            rec["labels"] = labels
        if t_wall is not None:
            rec["t_wall"] = float(t_wall)
        if t_sim is not None:
            rec["t_sim"] = float(t_sim)
        self.records.append(rec)

    def inc(self, name: str, value: float = 1.0, **labels: Any) -> None:
        self.emit("counter", name, value, **labels)

    def set_gauge(self, name: str, value: float, **labels: Any) -> None:
        self.emit("gauge", name, value, **labels)

    def observe(self, name: str, value: float, **labels: Any) -> None:
        self.emit("histogram", name, value, **labels)

    # -- in-memory aggregation ----------------------------------------------

    def _values(self, name: str, kind: str | None = None) -> list[float]:
        return [r["value"] for r in self.records
                if r["name"] == name and (kind is None or r["kind"] == kind)]

    def total(self, name: str) -> float:
        """Sum of every ``counter`` emission under ``name``."""
        return float(sum(self._values(name, "counter")))

    def last(self, name: str) -> float | None:
        """Latest ``gauge`` value under ``name`` (None if never set)."""
        vals = self._values(name, "gauge")
        return vals[-1] if vals else None

    def histogram(self, name: str) -> dict:
        """Summary stats over every ``histogram`` observation of ``name``."""
        vals = self._values(name, "histogram")
        if not vals:
            return {"count": 0}
        return {
            "count": len(vals),
            "sum": float(sum(vals)),
            "min": float(min(vals)),
            "max": float(max(vals)),
            "mean": float(sum(vals) / len(vals)),
        }

    def names(self) -> list[str]:
        seen: dict[str, None] = {}
        for r in self.records:
            seen.setdefault(r["name"])
        return list(seen)

    # -- serialization ------------------------------------------------------

    def save_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for r in self.records:
                f.write(json.dumps(r) + "\n")

    @classmethod
    def load_jsonl(cls, path: str) -> "MetricsRegistry":
        reg = cls()
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    reg.records.append(json.loads(line))
        return reg


def modeled_sync_cost(codec_spec: tuple | None, param_bytes: float, *,
                      workers: int, backend: str = "reference") -> dict:
    """Modeled cost of one sync round's uplink: the traffic model's HBM
    passes for the codec and backend (``codec_passes``: the JAX package's
    reference column, the port's own kernels' fused column) times the
    fleet's payload bytes, over the card's bandwidth. ``codec_spec=None``
    (a compressor without a spec) gives NaNs rather than a guess.

    Examples
    --------
    >>> c = modeled_sync_cost(("quantize", 8), 4096.0, workers=4)
    >>> c["hbm_passes"], c["hbm_bytes"] == 11 * 4096.0 * 4
    (11, True)
    >>> f = modeled_sync_cost(("quantize", 8), 4096.0, workers=4,
    ...                       backend="fused")
    >>> f["hbm_passes"], f["hbm_s"] == 6 * 4096.0 * 4 / 3.35e12
    (6, True)
    """
    from ..hardware import HBM_BW

    if codec_spec is None:
        return {"hbm_passes": math.nan, "hbm_bytes": math.nan,
                "hbm_s": math.nan}
    from ..kernels.sync_compress.ops import codec_passes

    ref_p, fused_p = codec_passes(codec_spec)
    passes = ref_p if backend == "reference" else fused_p
    hbm_bytes = float(passes) * float(param_bytes) * int(workers)
    return {"hbm_passes": passes, "hbm_bytes": hbm_bytes,
            "hbm_s": hbm_bytes / HBM_BW}
