"""Share of the RT quanta's wall time in the window in which no operation
of the RT lane's stream ran on the device, in %."""
import numpy as np

from gangbench.harness import profile


def read(run):
    tr = run.trace
    quanta = run.in_window("quantum")
    if tr is None or tr.rt_stream is None or not quanta:
        return None
    on = tr.stream == tr.rt_stream
    starts, ends = profile.union(tr.t0[on], tr.t1[on], 0.0, run.seconds)
    lo = np.array([s.t0 for s in quanta])
    hi = np.array([s.t1 for s in quanta])
    busy = profile.covered(starts, ends, lo, hi)
    wall = float((hi - lo).sum())
    return 100.0 * (wall - float(busy.sum())) / wall
