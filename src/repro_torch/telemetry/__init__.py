"""Telemetry: metrics registry + serving trace (DESIGN.md §15).

``Telemetry`` bundles the registry and the tracer the serving stack threads
through its hot path; engine, scheduler and tests share ONE bundle. The IO
ledger of the JAX package (``io_ledger.py`` with ``core/io_model.py``) is
not ported yet.
"""

from __future__ import annotations

from repro_torch.telemetry.metrics import (DEFAULT_BUCKETS, Counter, Gauge,
                                           Histogram, MetricsRegistry,
                                           default_registry, percentile)
from repro_torch.telemetry.trace import Tracer, chrome_trace_doc

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "DEFAULT_BUCKETS",
    "default_registry", "percentile", "Tracer", "chrome_trace_doc",
    "Telemetry",
]


class Telemetry:
    """One registry + one tracer, threaded together."""

    def __init__(self, *, trace: bool = False,
                 registry: MetricsRegistry | None = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = Tracer(enabled=trace)
