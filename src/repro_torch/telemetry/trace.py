"""Structured serving trace: per-step spans + per-request lifecycle events
(copy of ``repro.telemetry.trace``; pure Python).

The ``Tracer`` is an append-only in-memory recorder.  Producers emit two
shapes (DESIGN.md §15 documents the schema):

- **spans** (``span()``): a timed interval — one per executed step kind
  (``prefill_zero`` / ``prefill_chunk`` / ``prefill_dense`` / ``decode``)
  plus one ``step`` summary umbrella.  Span args carry the lanes, chunk
  sizes, declared collective census, tuner-resolved tiles, and the IO
  ledger's predicted HBM bytes for that interval.
- **markers** (``event()``): an instant — request lifecycle points
  (``submit``/``admit``/``resume``/``chunk``/``first_token``/``preempt``/
  ``prefix_hit``/``finish``) and scheduler decisions with reasons
  (``defer``/``evict``).

Overhead contract: when ``enabled`` is False every emit is a single
attribute check.  Hot-path call sites guard ``if tracer.enabled:``
*before* building kwargs, so the disabled mode allocates nothing —
``tests/test_telemetry.py`` pins this with tracemalloc.

Exports: ``to_jsonl`` dumps the raw events one-per-line;
``to_chrome_trace`` converts to Chrome trace-event JSON (load at
``chrome://tracing`` or https://ui.perfetto.dev).  Step spans land on an
``engine`` process with one thread lane per step kind; request lifecycle
phases are *reconstructed* from the markers into contiguous spans
(queued → prefill → decode, with ``preempted`` gaps) on a ``requests``
process, one thread per request id.
"""

from __future__ import annotations

import json
import time

# Chrome trace pid/tid assignment. Stable small ints so diffs are stable.
PID_ENGINE = 1
PID_REQUESTS = 2
_STEP_TIDS = {"step": 0, "prefill_zero": 1, "prefill_chunk": 2,
              "prefill_dense": 3, "decode": 4, "sched": 5}

# Request phases, in lifecycle order (used by the validator too).
REQ_PHASES = ("queued", "prefill", "decode", "preempted")


class Tracer:
    """Near-zero-overhead event recorder; no-op when disabled."""

    __slots__ = ("enabled", "events", "_t0")

    def __init__(self, enabled: bool = False):
        self.enabled = bool(enabled)
        self.events: list[dict] = []
        self._t0 = time.perf_counter()

    def now(self) -> float:
        """Seconds since tracer creation (trace-relative clock)."""
        return time.perf_counter() - self._t0

    def event(self, kind: str, name: str, **fields) -> None:
        """Instant marker. ``kind`` in {"req", "sched", "meta"}."""
        if not self.enabled:
            return
        ev = {"ts": self.now(), "kind": kind, "name": name}
        ev.update(fields)
        self.events.append(ev)

    def span(self, kind: str, name: str, t_start: float, dur: float,
             **fields) -> None:
        """Timed interval. ``t_start`` is tracer-relative (from ``now()``)."""
        if not self.enabled:
            return
        ev = {"ts": t_start, "dur": max(dur, 0.0), "kind": kind,
              "name": name}
        ev.update(fields)
        self.events.append(ev)

    # -- exports ------------------------------------------------------------

    def to_jsonl(self, path: str) -> None:
        with open(path, "w") as fh:
            for ev in self.events:
                fh.write(json.dumps(ev) + "\n")

    def to_chrome_trace(self, path: str) -> int:
        doc = chrome_trace_doc(self.events)
        with open(path, "w") as fh:
            json.dump(doc, fh)
        return len(doc["traceEvents"])


def _us(t: float) -> float:
    return t * 1e6


def _args_of(ev: dict) -> dict:
    return {k: v for k, v in ev.items()
            if k not in ("ts", "dur", "kind", "name")}


def _request_phase_spans(events: list[dict]) -> list[dict]:
    """Reconstruct contiguous lifecycle phases per request from markers.

    Phase transitions: submit opens ``queued``; admit closes it and opens
    ``prefill`` (args carry cached-token and resume annotations);
    first_token moves prefill → ``decode``; preempt closes the live phase
    and opens ``preempted`` until the re-admission; finish closes
    whatever is open.  An unfinished request's last phase stays open and
    is closed at the trace's end timestamp.
    """
    by_rid: dict[int, list[dict]] = {}
    t_end = 0.0
    for ev in events:
        t_end = max(t_end, ev["ts"] + ev.get("dur", 0.0))
        if ev.get("kind") == "req" and "rid" in ev:
            by_rid.setdefault(ev["rid"], []).append(ev)

    out = []
    for rid, evs in sorted(by_rid.items()):
        evs.sort(key=lambda e: e["ts"])
        open_phase, open_ts, open_args = None, 0.0, {}

        def close(t, extra=None):
            nonlocal open_phase
            if open_phase is None:
                return
            args = dict(open_args)
            if extra:
                args.update(extra)
            out.append({"name": open_phase, "cat": "request", "ph": "X",
                        "ts": _us(open_ts), "dur": _us(max(t - open_ts, 0.0)),
                        "pid": PID_REQUESTS, "tid": rid, "args": args})
            open_phase = None

        for ev in evs:
            name, t = ev["name"], ev["ts"]
            if name == "submit":
                close(t)
                open_phase, open_ts, open_args = "queued", t, _args_of(ev)
            elif name in ("admit", "resume"):
                close(t)
                open_phase, open_ts, open_args = "prefill", t, _args_of(ev)
            elif name == "first_token":
                close(t)
                open_phase, open_ts, open_args = "decode", t, {}
            elif name == "preempt":
                close(t, {"preempted": True})
                open_phase, open_ts = "preempted", t
                open_args = {"reason": ev.get("reason", "")}
            elif name == "finish":
                close(t, {"reason": ev.get("reason", "")})
        close(t_end)
    return out


def chrome_trace_doc(events: list[dict]) -> dict:
    """Convert raw tracer events into a Chrome trace-event document."""
    te: list[dict] = [
        {"name": "process_name", "ph": "M", "pid": PID_ENGINE,
         "args": {"name": "engine"}},
        {"name": "process_name", "ph": "M", "pid": PID_REQUESTS,
         "args": {"name": "requests"}},
    ]
    for lane, tid in sorted(_STEP_TIDS.items(), key=lambda kv: kv[1]):
        te.append({"name": "thread_name", "ph": "M", "pid": PID_ENGINE,
                   "tid": tid, "args": {"name": lane}})

    rids = set()
    for ev in events:
        kind = ev.get("kind")
        if kind in ("step", "stepsum"):
            tid = _STEP_TIDS.get(ev["name"], _STEP_TIDS["step"])
            te.append({"name": ev["name"], "cat": kind, "ph": "X",
                       "ts": _us(ev["ts"]), "dur": _us(ev.get("dur", 0.0)),
                       "pid": PID_ENGINE, "tid": tid, "args": _args_of(ev)})
        elif kind == "sched":
            te.append({"name": ev["name"], "cat": "sched", "ph": "i",
                       "ts": _us(ev["ts"]), "pid": PID_ENGINE,
                       "tid": _STEP_TIDS["sched"], "s": "t",
                       "args": _args_of(ev)})
        elif kind == "req":
            rid = ev.get("rid", -1)
            rids.add(rid)
            te.append({"name": ev["name"], "cat": "request", "ph": "i",
                       "ts": _us(ev["ts"]), "pid": PID_REQUESTS,
                       "tid": rid, "s": "t", "args": _args_of(ev)})

    te.extend(_request_phase_spans(events))
    for rid in sorted(rids):
        te.append({"name": "thread_name", "ph": "M", "pid": PID_REQUESTS,
                   "tid": rid, "args": {"name": f"req {rid}"}})
    return {"traceEvents": te, "displayTimeUnit": "ms"}
