"""Observability for the port: the metrics registry the executor, the
glock and the regulator share (DESIGN.md §12.1), and the per-job
RTA-margin accounting (measured response vs the analytic bound,
DESIGN.md §12.3)."""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                                     MetricsRegistry)
from repro_torch.obs.margins import margin_summary, merge_margins  # noqa: F401
