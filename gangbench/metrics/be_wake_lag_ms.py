"""Median over the best-effort stalls of the window of the time from the
stall's end (``stalled_until`` of the program's ``executor.be_denied``,
the regulator's window end) to the start of the lane's next
``executor.be_quantum``: how long a throttled lane sleeps past its
refill. A stall counts once (its first denial); one whose lane runs an
RT quantum before its next best-effort quantum, or runs none, is left
out."""
import bisect
from collections import defaultdict

from gangbench.harness.program_spans import of
from gangbench.harness.stats import percentile


def read(run):
    be, rt = defaultdict(list), defaultdict(list)
    for name, by_lane in (("executor.be_quantum", be),
                          ("executor.rt_quantum", rt)):
        for s in of(run, name):
            by_lane[s.lane].append(s.t0)
    for starts in (*be.values(), *rt.values()):
        starts.sort()
    lags, seen = [], set()
    for d in sorted(of(run, "executor.be_denied"), key=lambda s: s.t0):
        until = d.meta["stalled_until"]
        if d.t0 - run.spans.origin >= run.seconds or \
                (d.lane, until) in seen:
            continue
        seen.add((d.lane, until))
        q = be[d.lane]
        k = bisect.bisect_right(q, d.t0)
        if k == len(q):
            continue
        r = rt[d.lane]
        j = bisect.bisect_right(r, d.t0)
        if j < len(r) and r[j] < q[k]:
            continue
        lags.append(q[k] - until)
    v = percentile(lags, 50)
    return None if v is None else v * 1e3
