"""Median over the requests due in the window of the time from when each
was due to the start of its admission (``add_request``); a request never
admitted counts until the run's end."""
from gangbench.harness.stats import percentile


def read(run):
    waits = [(r["admit"] if r["admit"] is not None else run.run_s) - r["due"]
             for r in run.requests if r["due"] < run.seconds]
    v = percentile(waits, 50)
    return None if v is None else v * 1e3
