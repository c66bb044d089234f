"""Chrome/Perfetto trace-event export of a span trace (port of
``repro.obs.export``).

:func:`to_trace_events` turns a list of :class:`~repro_torch.obs.spans.Span`
into the Trace Event Format dict that ``chrome://tracing`` and
https://ui.perfetto.dev open directly: one complete (``"ph": "X"``) event
per span with microsecond ``ts``/``dur``, one thread (``tid``) per span
track, and thread-name metadata events. ``clock="wall"`` exports the host
wall clock (the synchronous engine's view), ``clock="sim"`` the simulated
clock of an event-driven engine; spans without the requested clock are
skipped. The payload is the JAX package's, field for field (its
``otherData.source`` included), so traces of both packages open and
compare in the same tools.

:func:`validate_trace_events` is the schema check the tests gate on:
required keys, non-negative durations, and proper nesting (events on one
track either nest or are disjoint, never partially overlap).

Examples
--------
>>> from repro_torch.obs.spans import SpanTracer
>>> tr = SpanTracer()
>>> _ = tr.add_span("uplink r0", cat="uplink", track="worker/0",
...                 sim_t0=0.0, sim_t1=0.2)
>>> _ = tr.add_span("local-compute r0", cat="local-compute",
...                 track="worker/0", sim_t0=0.3, sim_t1=2.3)
>>> payload = to_trace_events(tr.spans, clock="sim")
>>> validate_trace_events(payload)
>>> [e["name"] for e in payload["traceEvents"] if e["ph"] == "X"]
['uplink r0', 'local-compute r0']
"""
from __future__ import annotations

import json
from typing import Iterable

from .spans import Span, SpanTracer

_CLOCKS = ("wall", "sim")


def _interval(span: Span, clock: str) -> tuple[float, float] | None:
    t0 = getattr(span, f"{clock}_t0")
    t1 = getattr(span, f"{clock}_t1")
    if t0 is None or t1 is None:
        return None
    return float(t0), float(t1)


def to_trace_events(spans: Iterable[Span], *, clock: str = "wall",
                    pid: int = 1) -> dict:
    """Spans → Trace Event Format dict (see the module docstring)."""
    if clock not in _CLOCKS:
        raise ValueError(f"clock must be one of {_CLOCKS}, got {clock!r}")
    spans = list(spans)
    events: list[dict] = []
    tids: dict[str, int] = {}
    for sp in spans:
        if _interval(sp, clock) is not None:
            tids.setdefault(sp.track, len(tids))
    for track, tid in tids.items():
        events.append({
            "ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
            "args": {"name": track},
        })
        events.append({
            "ph": "M", "pid": pid, "tid": tid, "name": "thread_sort_index",
            "args": {"sort_index": tid},
        })
    t_base = min((_interval(sp, clock)[0] for sp in spans
                  if _interval(sp, clock) is not None), default=0.0)
    for sp in spans:
        iv = _interval(sp, clock)
        if iv is None:
            continue
        t0, t1 = iv
        ev = {
            "ph": "X",
            "pid": pid,
            "tid": tids[sp.track],
            "name": sp.name,
            "cat": sp.cat or "span",
            "ts": (t0 - t_base) * 1e6,          # µs, zero-based
            "dur": (t1 - t0) * 1e6,
        }
        args = dict(sp.attrs)
        if clock == "sim" and sp.wall_dur is not None:
            args["wall_dur_ms"] = sp.wall_dur * 1e3
        if args:
            ev["args"] = {k: v for k, v in args.items()
                          if isinstance(v, (int, float, str, bool))
                          or v is None}
        events.append(ev)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"clock": clock, "source": "repro.obs"},
    }


def save_trace_events(path: str, tracer: SpanTracer | Iterable[Span], *,
                      clock: str = "wall", pid: int = 1) -> dict:
    """Write :func:`to_trace_events` output as JSON; returns the payload."""
    spans = tracer.spans if isinstance(tracer, SpanTracer) else tracer
    payload = to_trace_events(spans, clock=clock, pid=pid)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    return payload


def validate_trace_events(payload: dict) -> None:
    """Raise ``ValueError`` unless ``payload`` is well-formed Trace Event
    JSON: required keys per event, non-negative ``ts``/``dur``, and per-track
    events that strictly nest or are disjoint (no partial overlap).

    >>> validate_trace_events({})
    Traceback (most recent call last):
        ...
    ValueError: missing traceEvents
    """
    if "traceEvents" not in payload:
        raise ValueError("missing traceEvents")
    complete: dict[int, list[tuple[float, float, str]]] = {}
    for ev in payload["traceEvents"]:
        for key in ("ph", "pid", "tid", "name"):
            if key not in ev:
                raise ValueError(f"event missing {key!r}: {ev}")
        if ev["ph"] == "M":
            continue
        if ev["ph"] != "X":
            raise ValueError(f"unexpected phase {ev['ph']!r}")
        if "ts" not in ev or "dur" not in ev:
            raise ValueError(f"X event missing ts/dur: {ev}")
        if ev["ts"] < 0 or ev["dur"] < 0:
            raise ValueError(
                f"negative timestamp/duration on {ev['name']!r}: "
                f"ts={ev['ts']}, dur={ev['dur']}"
            )
        complete.setdefault(ev["tid"], []).append(
            (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]), ev["name"])
        )
    eps = 1.0  # µs: tolerate float jitter from uniform wall attribution
    for tid, ivs in complete.items():
        ivs.sort(key=lambda x: (x[0], -(x[1] - x[0])))
        stack: list[tuple[float, float, str]] = []
        for t0, t1, name in ivs:
            while stack and t0 >= stack[-1][1] - eps:
                stack.pop()
            if stack and t1 > stack[-1][1] + eps:
                raise ValueError(
                    f"track {tid}: {name!r} [{t0}, {t1}] partially overlaps "
                    f"{stack[-1][2]!r} [{stack[-1][0]}, {stack[-1][1]}]"
                )
            stack.append((t0, t1, name))
