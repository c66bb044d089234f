"""Per-round telemetry for the Parameter-Server engine (port of
``repro.ps.trace``, same trace JSON v8, so a port trace and a reference
trace diff with one script).

One :class:`RoundRecord` per engine round: communication volume (bytes up =
survivors × compressed message size, bytes down = survivors × dense anchor
broadcast), the effective local step count per worker, the aliveness mask,
the η spread across workers at the end of the round, the round's wall-clock
share and local-steps/sec throughput, and — when the engine was given an
``eval_fn`` — the problem residual of the running global output iterate.
The async, sampled-client, hostile-fleet and outer-optimizer fields are
kept (default ``None``) so traces of every vintage load.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any

#: Trace JSON schema version, continuing the field-shaped revision history
#: of ``docs/formats.md`` (1–4 were implicit). 5 is the first revision to
#: stamp the file with an explicit ``version`` key; loaders treat a missing
#: key as 1, the oldest vintage — safe, since every post-v1 field is
#: optional anyway. 6 adds sampled-client participation: a per-record
#: ``sampled_workers`` id list plus ``sampler``/``sample`` meta keys. 7 adds
#: the hostile-fleet story: a per-record ``byzantine_workers`` id list plus
#: ``byzantine``/``aggregator``/``dp`` meta keys (v6 traces still load —
#: every new field is optional). 8 adds the server-side outer optimizer:
#: per-record ``outer_lr``/``delta_norm`` telemetry plus a ``server_opt``
#: meta key (v7 traces still load — same optional-field discipline).
TRACE_VERSION = 8


@dataclasses.dataclass
class RoundRecord:
    """One round's (or admission batch's) telemetry — the unit of the trace
    JSON's ``rounds`` list (field-by-field spec: ``docs/formats.md``).

    Examples
    --------
    >>> rec = RoundRecord(round=0, local_steps=[3, 2], alive=[True, True],
    ...                   bytes_up=80.0, bytes_down=80.0,
    ...                   eta_min=0.5, eta_max=1.0, eta_mean=0.75)
    >>> rec.eta_spread
    2.0
    >>> rec.sim_time_s is None        # sync engines leave async fields None
    True
    """

    round: int
    local_steps: list          # effective K per worker (0 = sat out / down)
    alive: list                # bool per worker
    bytes_up: float            # Σ_alive compressed message bytes
    bytes_down: float          # Σ_alive dense broadcast bytes
    eta_min: float
    eta_max: float
    eta_mean: float
    residual: float | None = None
    wall_time_s: float | None = None   # this round's share of chunk wall time
    steps_per_sec: float | None = None  # effective local steps / wall_time_s
    # --- async (simulated-time) telemetry; None for synchronous engines ----
    sim_time_s: float | None = None    # simulated clock at server admission
    staleness: list | None = None      # per worker: rounds behind freshest
    idle_frac: float | None = None     # fleet idle fraction up to sim_time_s
    # --- sampled-client rounds (v6); None = full participation ------------
    # fleet ids drawn this round, ascending; when set, the per-worker lists
    # above (local_steps/alive/staleness) are per *sampled lane*, length
    # meta["sample"], aligned with these ids
    sampled_workers: list | None = None
    # --- hostile-fleet rounds (v7); None = no Byzantine policy configured --
    # fleet ids of the workers whose uplink was adversarially corrupted this
    # round (empty list = policy active but nobody attacked this round)
    byzantine_workers: list | None = None
    # --- server-side outer optimizer (v8); None = historical Line-7 merge --
    outer_lr: float | None = None      # effective outer step size this round
    delta_norm: float | None = None    # ‖Δ‖₂ of the round's pseudo-gradient

    @property
    def eta_spread(self) -> float:
        return self.eta_max / max(self.eta_min, 1e-30)


class TraceRecorder:
    """Accumulates RoundRecords and summarizes/serializes them.

    Examples
    --------
    >>> import os, tempfile
    >>> rec = TraceRecorder(meta={"problem": "demo"})
    >>> rec.record(RoundRecord(round=0, local_steps=[2, 2],
    ...                        alive=[True, True], bytes_up=8.0,
    ...                        bytes_down=8.0, eta_min=1.0, eta_max=1.0,
    ...                        eta_mean=1.0, residual=0.5))
    >>> rec.total_steps, rec.total_bytes_up
    (4, 8.0)
    >>> with tempfile.TemporaryDirectory() as d:
    ...     rec.save(os.path.join(d, "t.json"))
    ...     back = TraceRecorder.load(os.path.join(d, "t.json"))
    >>> back.meta["problem"], back.rounds[0].residual
    ('demo', 0.5)
    """

    def __init__(self, meta: dict | None = None):
        self.meta: dict = dict(meta or {})
        self.rounds: list[RoundRecord] = []
        self.version: int = TRACE_VERSION

    def record(self, rec: RoundRecord) -> None:
        self.rounds.append(rec)

    @classmethod
    def from_spans(cls, tracer_or_spans, meta: dict | None = None
                   ) -> "TraceRecorder":
        """Rebuild a recorder from the span layer (:mod:`repro_torch.obs.spans`).

        The engines attach every :class:`RoundRecord`'s fields to the span
        that timed it (``cat="round"`` in the sync engine, ``"admission"``
        in the event-driven one), so the span trace alone reconstructs the
        trace JSON — with ``wall_time_s``/``steps_per_sec`` *derived from
        the span's wall clock* when the record itself left them unset (the
        async engine's records stay deterministic for crash-resume
        bit-exactness; the nondeterministic wall timing lives here).

        Examples
        --------
        >>> from repro_torch.obs.spans import SpanTracer
        >>> tr = SpanTracer()
        >>> _ = tr.add_span("round 0", cat="round", wall_t0=1.0, wall_t1=1.5,
        ...                 round=0, local_steps=[2, 2], alive=[True, True],
        ...                 bytes_up=8.0, bytes_down=8.0, eta_min=1.0,
        ...                 eta_max=1.0, eta_mean=1.0)
        >>> rec = TraceRecorder.from_spans(tr)
        >>> rec.rounds[0].wall_time_s, rec.rounds[0].steps_per_sec
        (0.5, 8.0)
        """
        spans = getattr(tracer_or_spans, "spans", tracer_or_spans)
        known = {f.name for f in dataclasses.fields(RoundRecord)}
        rec = cls(meta=meta)
        for sp in spans:
            if sp.cat not in ("round", "admission"):
                continue
            fields = {k: v for k, v in sp.attrs.items() if k in known}
            if "round" not in fields or "local_steps" not in fields:
                continue  # a span without a riding record (e.g. bare timing)
            r = RoundRecord(**fields)
            if r.wall_time_s is None and sp.wall_dur is not None:
                r.wall_time_s = sp.wall_dur
                steps = sum(r.local_steps)
                if r.wall_time_s > 0.0 and steps:
                    r.steps_per_sec = steps / r.wall_time_s
            rec.record(r)
        rec.rounds.sort(key=lambda r: r.round)
        return rec

    # -- aggregates ---------------------------------------------------------

    @property
    def total_bytes_up(self) -> float:
        return sum(r.bytes_up for r in self.rounds)

    @property
    def total_bytes_down(self) -> float:
        return sum(r.bytes_down for r in self.rounds)

    @property
    def total_steps(self) -> int:
        return int(sum(sum(r.local_steps) for r in self.rounds))

    @property
    def total_wall_time_s(self) -> float:
        return sum(r.wall_time_s for r in self.rounds
                   if r.wall_time_s is not None)

    @property
    def sim_time_s(self) -> float | None:
        """Final simulated-clock reading (async engines only)."""
        times = [r.sim_time_s for r in self.rounds if r.sim_time_s is not None]
        return max(times) if times else None

    @property
    def max_staleness(self) -> int | None:
        """Largest per-entry staleness any admission ever averaged over
        (``None`` entries — workers the server hadn't heard from yet — are
        ignored)."""
        vals = [s for r in self.rounds if r.staleness
                for s in r.staleness if s is not None]
        return int(max(vals)) if vals else None

    def time_to_residual(self, target: float) -> float | None:
        """First simulated time at which the recorded residual reached
        ``target`` — the time-to-accuracy metric ``bench_async`` plots."""
        for r in self.rounds:
            if (r.sim_time_s is not None and r.residual is not None
                    and r.residual <= target):
                return float(r.sim_time_s)
        return None

    @property
    def steps_per_sec(self) -> float | None:
        """Aggregate local-steps/sec over every timed round."""
        timed = [r for r in self.rounds if r.wall_time_s]
        wall = sum(r.wall_time_s for r in timed)
        if wall <= 0.0:
            return None
        return sum(sum(r.local_steps) for r in timed) / wall

    def summary(self) -> dict:
        out = {
            "rounds": len(self.rounds),
            "total_steps": self.total_steps,
            "bytes_up": self.total_bytes_up,
            "bytes_down": self.total_bytes_down,
        }
        wall = self.total_wall_time_s
        if wall > 0.0:
            out["wall_time_s"] = wall
            out["steps_per_sec"] = self.steps_per_sec
        residuals = [r.residual for r in self.rounds if r.residual is not None]
        if residuals:
            out["final_residual"] = residuals[-1]
        sim = self.sim_time_s
        if sim is not None:
            out["sim_time_s"] = sim
            stale = self.max_staleness
            if stale is not None:
                out["max_staleness"] = stale
            idles = [r.idle_frac for r in self.rounds
                     if r.idle_frac is not None]
            if idles:
                out["idle_frac"] = idles[-1]
        return out

    # -- serialization ------------------------------------------------------

    def to_json(self) -> str:
        def _plain(v: Any):
            if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
                return v.item()
            return v

        payload = {
            "version": self.version,
            "meta": self.meta,
            "summary": self.summary(),
            "rounds": [
                {k: _plain(v) for k, v in dataclasses.asdict(r).items()}
                for r in self.rounds
            ],
        }
        return json.dumps(payload, indent=2)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "TraceRecorder":
        """Inverse of :meth:`save`. Fields missing from old trace files fall
        back to the RoundRecord defaults, and fields this version doesn't
        know (written by a newer one) are dropped — so bench/plot code can
        read any vintage of trace through one API instead of re-parsing the
        JSON by hand."""
        with open(path) as f:
            payload = json.load(f)
        known = {f.name for f in dataclasses.fields(RoundRecord)}
        rec = cls(meta=payload.get("meta"))
        # pre-versioning traces carry no "version" key: that's version 1
        rec.version = int(payload.get("version", 1))
        for r in payload.get("rounds", []):
            rec.record(RoundRecord(**{k: v for k, v in r.items()
                                      if k in known}))
        return rec
