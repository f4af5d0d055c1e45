"""Observability for the port: the metrics registry the executor, the
glock and the regulator share (DESIGN.md §12.1)."""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                                     MetricsRegistry)
