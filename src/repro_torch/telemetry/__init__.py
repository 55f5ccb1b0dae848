"""Telemetry: metrics registry + serving trace + IO ledger.

``Telemetry`` bundles the three subsystems the serving stack threads
through its hot path; engine, scheduler and tests share ONE bundle so
counters, spans and byte accounting land in the same place.
"""

from __future__ import annotations

from repro_torch.telemetry.io_ledger import IOLedger, ServePriceModel
from repro_torch.telemetry.metrics import (DEFAULT_BUCKETS, Counter, Gauge,
                                           Histogram, MetricsRegistry,
                                           default_registry, percentile)
from repro_torch.telemetry.trace import Tracer, chrome_trace_doc

# repro_torch.telemetry.validate is not imported here, so that
# ``python -m repro_torch.telemetry.validate`` runs without runpy's
# double-import warning; import validate_chrome_trace from the submodule.

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "DEFAULT_BUCKETS",
    "default_registry", "percentile", "Tracer", "chrome_trace_doc",
    "IOLedger", "ServePriceModel", "Telemetry",
]


class Telemetry:
    """One registry + one tracer + one ledger, threaded together."""

    def __init__(self, *, trace: bool = False,
                 registry: MetricsRegistry | None = None,
                 ledger: IOLedger | None = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = Tracer(enabled=trace)
        self.ledger = ledger if ledger is not None else IOLedger()
