"""Typed metrics registry: counters, gauges, and fixed-bucket histograms
(copy of ``repro.telemetry.metrics``; pure Python + numpy).

The registry is the single funnel for every number the serving engine,
scheduler, KV pool, tuner, and train loop used to keep as ad-hoc
attributes (DESIGN.md §15).  Three metric kinds, all label-aware:

- ``Counter``   — monotonically increasing float (``inc``).
- ``Gauge``     — last-write-wins float (``set`` / ``max_update``).
- ``Histogram`` — fixed cumulative buckets for export plus retained raw
  samples so exact percentiles (``np.percentile``) stay available; this
  is the single percentile implementation the engine's ``latency_stats``
  delegates to.

Labels are declared per metric (``labels=("reason",)``) and passed as
kwargs at observation time; each distinct label-value tuple is an
independent series.  ``snapshot()`` returns a plain-dict view and
``delta(prev)`` diffs two snapshots (counters and histogram totals are
subtracted, gauges pass through) — the scrape loop a real exporter would
run, without the exporter.

This module is numpy-only so the host-side scheduler can import it
without pulling in a device backend.
"""

from __future__ import annotations

import numpy as np

# Default latency buckets in seconds: 0.5 ms .. 10 s, roughly log-spaced.
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def percentile(samples, q: float) -> float:
    """Percentile of raw samples; the one implementation in the repo.

    Edge cases pinned by tests: an empty sample set reports 0.0 (the
    engine's pre-telemetry ``latency_stats`` contract) and a singleton
    reports that sample for every q.
    """
    xs = np.asarray(list(samples), dtype=np.float64)
    if xs.size == 0:
        return 0.0
    return float(np.percentile(xs, q))


class _Metric:
    """Shared label plumbing for the three metric kinds."""

    kind = "metric"

    def __init__(self, name: str, help: str = "", labels: tuple = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(labels)
        self._series: dict[tuple, object] = {}

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(sorted(labels))}")
        return tuple(str(labels[n]) for n in self.label_names)

    def _label_str(self, key: tuple) -> str:
        return ",".join(f"{n}={v}" for n, v in zip(self.label_names, key))

    def series_keys(self) -> list[tuple]:
        return sorted(self._series)


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up")
        k = self._key(labels)
        self._series[k] = self._series.get(k, 0.0) + amount

    def value(self, **labels) -> float:
        return self._series.get(self._key(labels), 0.0)

    def total(self) -> float:
        """Sum across all label series (back-compat unlabeled view)."""
        return float(sum(self._series.values()))


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._series[self._key(labels)] = float(value)

    def max_update(self, value: float, **labels) -> None:
        """Keep the running maximum (peak-style gauges)."""
        k = self._key(labels)
        self._series[k] = max(self._series.get(k, float(value)), float(value))

    def value(self, default: float = 0.0, **labels) -> float:
        return self._series.get(self._key(labels), default)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str = "", labels: tuple = (),
                 buckets: tuple = DEFAULT_BUCKETS):
        super().__init__(name, help, labels)
        self.buckets = tuple(sorted(buckets))

    def _cell(self, key: tuple) -> dict:
        cell = self._series.get(key)
        if cell is None:
            cell = {"counts": [0] * (len(self.buckets) + 1),
                    "sum": 0.0, "samples": []}
            self._series[key] = cell
        return cell

    def observe(self, value: float, **labels) -> None:
        cell = self._cell(self._key(labels))
        i = int(np.searchsorted(self.buckets, value, side="left"))
        cell["counts"][i] += 1
        cell["sum"] += float(value)
        cell["samples"].append(float(value))

    def count(self, **labels) -> int:
        cell = self._series.get(self._key(labels))
        return int(sum(cell["counts"])) if cell else 0

    def sum(self, **labels) -> float:
        cell = self._series.get(self._key(labels))
        return float(cell["sum"]) if cell else 0.0

    def samples(self, **labels) -> list[float]:
        cell = self._series.get(self._key(labels))
        return list(cell["samples"]) if cell else []

    def percentile(self, q: float, **labels) -> float:
        return percentile(self.samples(**labels), q)

    def bucket_counts(self, **labels) -> dict[str, int]:
        """Cumulative counts per upper bound, Prometheus-style ``le``."""
        cell = self._series.get(self._key(labels))
        raw = cell["counts"] if cell else [0] * (len(self.buckets) + 1)
        out, running = {}, 0
        for ub, c in zip(self.buckets, raw):
            running += c
            out[f"le={ub:g}"] = running
        out["le=+Inf"] = running + raw[-1]
        return out


class MetricsRegistry:
    """Get-or-create registry of named metrics.

    Re-requesting a name returns the existing metric; requesting it with
    a different kind or label set is a hard error (one meaning per name).
    """

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, help, labels, **kw):
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls) or m.label_names != tuple(labels):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind} "
                    f"with labels {m.label_names}")
            return m
        m = cls(name, help, labels, **kw)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "", labels: tuple = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", labels: tuple = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", labels: tuple = (),
                  buckets: tuple = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)

    def get(self, name: str) -> _Metric | None:
        return self._metrics.get(name)

    def names(self) -> list[str]:
        return sorted(self._metrics)

    # -- snapshot / delta ---------------------------------------------------

    def snapshot(self) -> dict:
        """Plain-dict view: {name: {kind, series: {label_str: value}}}.

        Histogram series export as {count, sum, buckets} (no raw
        samples — snapshots are for scraping, not replay).
        """
        out = {}
        for name in self.names():
            m = self._metrics[name]
            series = {}
            for key in m.series_keys():
                ls = m._label_str(key)
                if m.kind == "histogram":
                    labels = dict(zip(m.label_names, key))
                    series[ls] = {"count": m.count(**labels),
                                  "sum": m.sum(**labels),
                                  "buckets": m.bucket_counts(**labels)}
                else:
                    series[ls] = m._series[key]
            out[name] = {"kind": m.kind, "series": series}
        return out

    def delta(self, prev: dict) -> dict:
        """Diff the current state against an older ``snapshot()``.

        Counters and histogram count/sum subtract; gauges report their
        current value (a gauge delta is not meaningful). Series absent
        from ``prev`` diff against zero.
        """
        cur = self.snapshot()
        out = {}
        for name, entry in cur.items():
            pseries = prev.get(name, {}).get("series", {})
            series = {}
            for ls, v in entry["series"].items():
                if entry["kind"] == "counter":
                    series[ls] = v - pseries.get(ls, 0.0)
                elif entry["kind"] == "histogram":
                    pv = pseries.get(ls, {"count": 0, "sum": 0.0})
                    series[ls] = {"count": v["count"] - pv["count"],
                                  "sum": v["sum"] - pv["sum"]}
                else:
                    series[ls] = v
            out[name] = {"kind": entry["kind"], "series": series}
        return out

    # -- human-readable dump ------------------------------------------------

    def table(self) -> str:
        """Fixed-width text table of every series (``--metrics`` output)."""
        lines = [f"{'metric':<44} {'kind':<10} {'value':>16}"]
        for name in self.names():
            m = self._metrics[name]
            keys = m.series_keys() or [()]
            for key in keys:
                label_s = m._label_str(key)
                disp = f"{name}{{{label_s}}}" if label_s else name
                if m.kind == "histogram":
                    labels = dict(zip(m.label_names, key))
                    n = m.count(**labels)
                    val = (f"n={n} p50={m.percentile(50, **labels):.4g} "
                           f"p95={m.percentile(95, **labels):.4g}")
                    lines.append(f"{disp:<44} {m.kind:<10} {val:>16}")
                else:
                    v = m._series.get(key, 0.0)
                    lines.append(f"{disp:<44} {m.kind:<10} {v:>16.6g}")
        return "\n".join(lines)


_DEFAULT: MetricsRegistry | None = None


def default_registry() -> MetricsRegistry:
    """Process-global registry for components without an obvious owner
    (the autotune cache, module-level hooks). Engines and trainers create
    their own registries so per-instance counters never alias."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = MetricsRegistry()
    return _DEFAULT
