"""p95 over the RT jobs released in the window of the executor's
dispatch, ``start - max(release, prev_finish)`` from the program's
``executor.rt_quantum`` spans: the worker's wake-up, a best-effort
quantum in flight on the lane, the gang lock, the gang-isolation barrier
and admission; the part of ``rt_blocking_ms`` that is not backlog."""
from gangbench.harness.program_spans import rt_parts
from gangbench.harness.stats import percentile


def read(run):
    v = percentile([d for _, d, _ in rt_parts(run)], 95)
    return None if v is None else v * 1e3
