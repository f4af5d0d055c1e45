"""Host time inside the program's ``model.decode_fn`` within the window's
decode steps over the device operations on the RT stream that began
inside those steps, in microseconds a launch."""
import numpy as np

from gangbench.harness.program_spans import decode_enqueue


def read(run):
    tr = run.trace
    parts = decode_enqueue(run)
    if tr is None or tr.rt_stream is None or parts is None:
        return None
    lo, hi, e0, e1 = parts
    t = tr.t0[tr.stream == tr.rt_stream]
    i = np.searchsorted(lo, t, side="right") - 1
    n = int(((i >= 0) & (t < hi[np.maximum(i, 0)])).sum())
    return None if n == 0 else 1e6 * float((e1 - e0).sum()) / n
