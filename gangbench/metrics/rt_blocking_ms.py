"""p95 over the RT jobs released in the window of the response time minus
the job's own quantum (matched by job index): the wait for the gang
lock, for a best-effort quantum in flight, or for the backlog."""
from gangbench.harness.stats import percentile


def read(run):
    quanta = {s.meta["idx"]: s.dur for s in run.spans.of("quantum")}
    n = int(-(-run.seconds // run.period_s))
    waits = [r - quanta[i] for i, r in enumerate(run.response_s[:n])
             if i in quanta]
    v = percentile(waits, 95)
    return None if v is None else v * 1e3
