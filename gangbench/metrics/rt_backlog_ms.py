"""p95 over the RT jobs released in the window of the wait for the same
job's previous quantum, ``max(0, prev_finish - release)``, from the
program's ``executor.rt_quantum`` spans: the part of ``rt_blocking_ms``
that is the RT job's own backlog."""
from gangbench.harness.program_spans import rt_parts
from gangbench.harness.stats import percentile


def read(run):
    v = percentile([b for b, _, _ in rt_parts(run)], 95)
    return None if v is None else v * 1e3
