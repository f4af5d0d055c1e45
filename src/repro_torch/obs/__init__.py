"""Observability for the port: the metrics registry the executor, the
glock and the regulator share (DESIGN.md §12.1), the Perfetto /
Chrome-trace export of ``core.tracing.Trace`` timelines (DESIGN.md
§12.2), the per-job RTA-margin accounting (measured response vs the
analytic bound, DESIGN.md §12.3), and the host-span recorder that the
executor and ``ModelApi`` feed while it is on (``obs.spans``)."""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                                     MetricsRegistry)
from repro_torch.obs.margins import margin_summary, merge_margins  # noqa: F401
from repro_torch.obs import spans  # noqa: F401
from repro_torch.obs.perfetto import (export_trace, export_sim,  # noqa: F401
                                      segments_from_json, spans_from_json,
                                      validate_chrome_trace,
                                      write_chrome_trace)
