"""Of the RT stream's idle time inside the window's decode steps (the
benchmark's ``decode`` spans), the share during which lane 0 was inside
the program's ``model.decode_fn`` (the host enqueueing the step), in %.
High: the host's launch loop starves the device; low: the host is
blocked elsewhere (the read of the tokens, bookkeeping, the other lane's
thread)."""
from gangbench.harness import profile
from gangbench.harness.program_spans import decode_enqueue


def read(run):
    tr = run.trace
    parts = decode_enqueue(run)
    if tr is None or tr.rt_stream is None or parts is None:
        return None
    lo, hi, e0, e1 = parts
    on = tr.stream == tr.rt_stream
    starts, ends = profile.union(tr.t0[on], tr.t1[on], 0.0, run.seconds)
    idle = float((hi - lo).sum() - profile.covered(starts, ends, lo,
                                                   hi).sum())
    e0, e1 = profile.union(e0, e1, 0.0, run.seconds)
    idle_enq = float((e1 - e0).sum() - profile.covered(starts, ends, e0,
                                                       e1).sum())
    return None if idle <= 0.0 else 100.0 * idle_enq / idle
