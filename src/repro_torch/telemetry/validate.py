"""Schema validator for exported Chrome trace-event JSON (port of
``repro.telemetry.validate``, the same checks).

    PYTHONPATH=src python -m repro_torch.telemetry.validate trace.json

Checks:

- top-level: a ``traceEvents`` list of dicts, each with name/ph/pid
  (and ts for non-metadata phases); ``X`` events carry ``dur >= 0``.
- engine step spans (cat ``step``) carry ``args.hbm_bytes >= 0`` —
  every executed step is priced by the IO ledger, no exceptions.
- request lifecycle (pid named ``requests``): each request thread has a
  ``submit`` marker, at least one ``queued`` and one ``prefill`` phase
  span, a ``finish`` marker, phases in non-decreasing time order, and —
  if a ``preempt`` marker exists — a ``preempted`` phase followed by a
  resumed ``prefill`` (the preemption→resume reconstruction contract).

Exit status: 0 when clean, 1 with one problem per line otherwise.
"""

from __future__ import annotations

import json
import sys

_STEP_SPAN_NAMES = {"prefill_zero", "prefill_chunk", "prefill_dense",
                    "decode"}


def validate_chrome_trace(doc) -> list[str]:
    problems: list[str] = []
    events = doc.get("traceEvents") if isinstance(doc, dict) else None
    if not isinstance(events, list):
        return ["top-level: missing 'traceEvents' list"]

    req_pid = None
    for ev in events:
        if (isinstance(ev, dict) and ev.get("ph") == "M"
                and ev.get("name") == "process_name"
                and ev.get("args", {}).get("name") == "requests"):
            req_pid = ev.get("pid")

    by_req: dict[int, list[dict]] = {}
    n_steps = 0
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event[{i}]: not an object")
            continue
        for key in ("name", "ph", "pid"):
            if key not in ev:
                problems.append(f"event[{i}]: missing '{key}'")
        ph = ev.get("ph")
        if ph != "M" and "ts" not in ev:
            problems.append(f"event[{i}] ({ev.get('name')}): missing 'ts'")
        if ph == "X":
            if ev.get("dur", -1) < 0:
                problems.append(
                    f"event[{i}] ({ev.get('name')}): X span needs dur >= 0")
            if ev.get("cat") == "step" and ev.get("name") in _STEP_SPAN_NAMES:
                n_steps += 1
                hbm = ev.get("args", {}).get("hbm_bytes")
                if not isinstance(hbm, (int, float)) or hbm < 0:
                    problems.append(
                        f"event[{i}] ({ev.get('name')}): step span lacks "
                        f"args.hbm_bytes >= 0 (got {hbm!r})")
        if req_pid is not None and ev.get("pid") == req_pid and ph != "M":
            by_req.setdefault(ev.get("tid", -1), []).append(ev)

    if n_steps == 0:
        problems.append("no engine step spans (cat='step') in trace")
    if req_pid is None:
        problems.append("no 'requests' process metadata in trace")

    for rid, evs in sorted(by_req.items()):
        markers = {e["name"] for e in evs if e["ph"] == "i"}
        spans = sorted((e for e in evs if e["ph"] == "X"),
                       key=lambda e: e["ts"])
        names = [s["name"] for s in spans]
        where = f"request {rid}"
        if "submit" not in markers:
            problems.append(f"{where}: no submit marker")
        if "finish" not in markers:
            problems.append(f"{where}: no finish marker")
        if "queued" not in names:
            problems.append(f"{where}: no queued phase span")
        if "prefill" not in names:
            problems.append(f"{where}: no prefill phase span")
        for a, b in zip(spans, spans[1:]):
            if b["ts"] + 1e-6 < a["ts"]:
                problems.append(f"{where}: phase spans out of order")
                break
        if "preempt" in markers:
            if "preempted" not in names:
                problems.append(f"{where}: preempt marker without a "
                                f"preempted phase span")
            else:
                i_pre = names.index("preempted")
                if "prefill" not in names[i_pre + 1:]:
                    problems.append(f"{where}: preemption never resumed "
                                    f"into a prefill phase")
    return problems


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m repro_torch.telemetry.validate TRACE.json",
              file=sys.stderr)
        return 2
    with open(argv[0]) as fh:
        doc = json.load(fh)
    problems = validate_chrome_trace(doc)
    if problems:
        for p in problems:
            print(f"INVALID: {p}", file=sys.stderr)
        return 1
    events = doc["traceEvents"]
    n_req = len({e.get("tid") for e in events
                 if e.get("cat") == "request" and e.get("ph") == "X"})
    n_span = sum(1 for e in events if e.get("cat") == "step")
    print(f"trace OK: {len(events)} events, {n_span} step spans, "
          f"{n_req} request lifecycles")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
