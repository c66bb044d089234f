"""Dual-clock hierarchical span tracer (port of ``repro.obs.spans``).

A :class:`Span` is one named interval of work — ``run → round/admission →
phase`` (local-compute, uplink, server-merge, broadcast, eval, checkpoint)
— on a named *track* (``server`` for the engine/server timeline, ``worker/3``
for fleet member 3). Every span can carry **two clocks**:

* ``wall_t0/wall_t1`` — host wall-clock seconds (``time.perf_counter``),
  measured around the host-side dispatch that actually did the work;
* ``sim_t0/sim_t1``  — a *simulated* clock (the event-driven engine of a
  later slice), so staleness holds and straggler idle gaps stay visible
  even though the host executed everything back-to-back.

The synchronous engine only fills the wall clock. The span format is the
JAX package's, so the same exporters read both.

The tracer is deliberately dumb and cheap: recording a span is one dataclass
append on the host, never on the device, so tracing cannot change results.
With ``profile=True`` each context-managed span also enters a
``torch.profiler.record_function`` range, so spans line up with kernel
names in a device profile.

Examples
--------
>>> tr = SpanTracer()
>>> with tr.span("round 0", cat="round", steps=12) as sp:
...     pass
>>> ph = tr.add_span("local-compute", cat="local-compute", track="worker/1",
...                  parent=sp.id, sim_t0=0.0, sim_t1=3.5)
>>> len(tr.spans), ph.sim_dur, sp.wall_dur is not None
(2, 3.5, True)
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Any, Iterator

# Canonical phase categories (``Span.cat``). Free-form strings are allowed,
# but the engines and the Perfetto export color-key on these.
CATEGORIES = (
    "run", "chunk", "round", "admission",
    "local-compute", "uplink", "held", "reboot",
    "uplink-encode", "server-merge", "broadcast",
    "eval", "checkpoint",
)


@dataclasses.dataclass
class Span:
    """One traced interval on one track, on up to two clocks.

    Examples
    --------
    >>> sp = Span(name="uplink", cat="uplink", track="worker/0",
    ...           sim_t0=1.0, sim_t1=1.2, id=0)
    >>> round(sp.sim_dur, 3), sp.wall_dur
    (0.2, None)
    """

    name: str
    cat: str = ""
    track: str = "server"
    wall_t0: float | None = None
    wall_t1: float | None = None
    sim_t0: float | None = None
    sim_t1: float | None = None
    parent: int | None = None
    id: int = -1
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def wall_dur(self) -> float | None:
        if self.wall_t0 is None or self.wall_t1 is None:
            return None
        return self.wall_t1 - self.wall_t0

    @property
    def sim_dur(self) -> float | None:
        if self.sim_t0 is None or self.sim_t1 is None:
            return None
        return self.sim_t1 - self.sim_t0

    def to_dict(self) -> dict:
        d = {"name": self.name, "cat": self.cat, "track": self.track,
             "id": self.id}
        for f in ("wall_t0", "wall_t1", "sim_t0", "sim_t1", "parent"):
            v = getattr(self, f)
            if v is not None:
                d[f] = v
        if self.attrs:
            d["attrs"] = self.attrs
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Span":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class SpanTracer:
    """Accumulates :class:`Span` records; hierarchy via a host-side stack.

    ``enabled=False`` turns the tracer into a timing-only shell: the context
    manager still measures wall time (the engines read their telemetry
    timings from it either way) but nothing is recorded — the configuration
    the overhead benchmark compares against. ``profile=True`` additionally
    wraps each context-managed span in a ``torch.profiler.record_function``
    range so device profiles carry the same names.

    Examples
    --------
    >>> tr = SpanTracer()
    >>> with tr.span("run", cat="run"):
    ...     with tr.span("round 0", cat="round") as r0:
    ...         pass
    >>> tr.spans[0].parent == tr.spans[1].id  # children close first
    True
    >>> [s.name for s in tr.spans]
    ['round 0', 'run']
    """

    def __init__(self, *, enabled: bool = True, profile: bool = False):
        self.enabled = bool(enabled)
        self.profile = bool(profile)
        self.spans: list[Span] = []
        self._stack: list[int] = []
        self._next_id = 0

    # -- recording ----------------------------------------------------------

    def _new_id(self) -> int:
        i = self._next_id
        self._next_id += 1
        return i

    @contextlib.contextmanager
    def span(self, name: str, *, cat: str = "", track: str = "server",
             sim_t0: float | None = None, sim_t1: float | None = None,
             **attrs: Any) -> Iterator[Span]:
        """Measure a host-side section; records it when enabled. The yielded
        span is live — callers may set ``sim_t0``/``sim_t1``/attrs inside."""
        sp = Span(name=name, cat=cat, track=track, sim_t0=sim_t0,
                  sim_t1=sim_t1, attrs=attrs)
        prof = None
        if self.enabled:
            sp.id = self._new_id()
            sp.parent = self._stack[-1] if self._stack else None
            self._stack.append(sp.id)
            if self.profile:
                import torch

                prof = torch.profiler.record_function(name)
                prof.__enter__()
        sp.wall_t0 = time.perf_counter()
        try:
            yield sp
        finally:
            sp.wall_t1 = time.perf_counter()
            if self.enabled:
                if prof is not None:
                    prof.__exit__(None, None, None)
                self._stack.pop()
                self.spans.append(sp)

    def add_span(self, name: str, *, cat: str = "", track: str = "server",
                 wall_t0: float | None = None, wall_t1: float | None = None,
                 sim_t0: float | None = None, sim_t1: float | None = None,
                 parent: int | None = None, **attrs: Any) -> Span:
        """Record an interval retroactively (the event-driven engine's
        simulated-clock phases are only known once their events fire)."""
        sp = Span(name=name, cat=cat, track=track, wall_t0=wall_t0,
                  wall_t1=wall_t1, sim_t0=sim_t0, sim_t1=sim_t1,
                  parent=parent, attrs=attrs)
        if self.enabled:
            sp.id = self._new_id()
            if sp.parent is None and self._stack:
                sp.parent = self._stack[-1]
            self.spans.append(sp)
        return sp

    # -- queries ------------------------------------------------------------

    def by_cat(self, cat: str) -> list[Span]:
        return [s for s in self.spans if s.cat == cat]

    def tracks(self) -> list[str]:
        seen: dict[str, None] = {}
        for s in self.spans:
            seen.setdefault(s.track)
        return list(seen)

    # -- serialization (JSONL: one span per line) ---------------------------

    def save_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for s in self.spans:
                f.write(json.dumps(s.to_dict()) + "\n")

    @classmethod
    def load_jsonl(cls, path: str) -> "SpanTracer":
        """Inverse of :meth:`save_jsonl`; unknown keys from newer writers
        are dropped, like ``TraceRecorder.load``."""
        tr = cls()
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    tr.spans.append(Span.from_dict(json.loads(line)))
        if tr.spans:
            tr._next_id = max(s.id for s in tr.spans) + 1
        return tr
