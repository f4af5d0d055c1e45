"""Execution traces (KernelShark-lite): per-core timeline segments with an
ASCII renderer and CSV export, used by the simulator, the executor and the
Fig.5 benchmark."""
from __future__ import annotations

import csv
import dataclasses
import io
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(slots=True)
class Segment:
    core: int
    label: Optional[str]          # None = idle; "throttled:<task>" = stalled
    t0: float
    t1: float


class Trace:
    def __init__(self, n_cores: int):
        self.n_cores = n_cores
        self.segments: List[Segment] = []
        self._open: Dict[int, Segment] = {}

    def record(self, core: int, label: Optional[str], t0: float, t1: float):
        if t1 - t0 < 1e-12:      # zero-length (event-engine cascade) — skip
            return
        seg = self._open.get(core)
        if seg is not None:
            if seg.label == label and -1e-9 < seg.t1 - t0 < 1e-9:
                seg.t1 = t1
                return
            self.segments.append(seg)
        self._open[core] = Segment(core, label, t0, t1)

    def finish(self):
        for seg in self._open.values():
            self.segments.append(seg)
        self._open.clear()
        self.segments.sort(key=lambda s: (s.core, s.t0))

    def busy(self, label: str) -> float:
        self.finish_view()
        return sum(s.t1 - s.t0 for s in self.segments if s.label == label)

    def intervals(self, label: str, tol: float = 1e-9
                  ) -> List[Tuple[float, float]]:
        """Merged [t0, t1) intervals (across cores) during which ``label``
        ran anywhere. The quantum engine emits dt-sized touching segments,
        the event engine emits long exact ones; merging makes the two
        comparable for equivalence checks."""
        self.finish_view()
        segs = sorted(((s.t0, s.t1) for s in self.segments
                       if s.label == label))
        out: List[Tuple[float, float]] = []
        for t0, t1 in segs:
            if out and t0 <= out[-1][1] + tol:
                out[-1] = (out[-1][0], max(out[-1][1], t1))
            else:
                out.append((t0, t1))
        return out

    def finish_view(self):
        if self._open:
            self.finish()

    def to_csv(self) -> str:
        """CSV with properly quoted labels. ``throttled:<task>`` /
        ``dem:<task>`` labels (and any future label containing a comma
        or quote) round-trip through a standard CSV reader; an idle
        (None) segment writes an empty field, distinct from a literal
        task named "idle"."""
        self.finish_view()
        buf = io.StringIO()
        w = csv.writer(buf, lineterminator="\n")
        w.writerow(["core", "label", "t0", "t1"])
        for s in self.segments:
            w.writerow([s.core, "" if s.label is None else s.label,
                        f"{s.t0:.4f}", f"{s.t1:.4f}"])
        return buf.getvalue().rstrip("\n")

    @classmethod
    def from_csv(cls, text: str, n_cores: Optional[int] = None) -> "Trace":
        """Inverse of ``to_csv`` (modulo the 1e-4 ms timestamp
        rounding)."""
        rows = list(csv.reader(io.StringIO(text)))
        assert rows and rows[0] == ["core", "label", "t0", "t1"], \
            "not a Trace CSV"
        body = [(int(c), lab or None, float(t0), float(t1))
                for c, lab, t0, t1 in rows[1:]]
        if n_cores is None:
            n_cores = max((c for c, *_ in body), default=-1) + 1
        tr = cls(n_cores)
        for core, lab, t0, t1 in body:
            tr.segments.append(Segment(core, lab, t0, t1))
        tr.segments.sort(key=lambda s: (s.core, s.t0))
        return tr

    def render_ascii(self, t_end: Optional[float] = None, width: int = 100,
                     t_start: float = 0.0) -> str:
        """One row per core; distinct letters per task label."""
        self.finish_view()
        if not self.segments:
            return "(empty trace)"
        if t_end is None:
            t_end = max(s.t1 for s in self.segments)
        labels = sorted({s.label for s in self.segments if s.label})
        letters = {}
        alphabet = "ABCDEFGHJKLMNPQRSTUVWXYZabcdefghjklmnpqrstuvwxyz"
        for i, lab in enumerate(labels):
            if lab.startswith("throttled:"):
                letters[lab] = "~"
            else:
                letters[lab] = alphabet[i % len(alphabet)]
        # a single-instant trace (every segment at one timestamp, or an
        # explicit t_end == t_start) has no extent to scale into the
        # row — render the instant as one column instead of dividing
        # by zero
        span = t_end - t_start
        if span <= 0:
            span, width = 1.0, 1
        rows = []
        for c in range(self.n_cores):
            row = ["."] * width
            for s in self.segments:
                if s.core != c or s.label is None:
                    continue
                i0 = int((max(s.t0, t_start) - t_start) / span * width)
                i1 = int((min(s.t1, t_end) - t_start) / span * width)
                for i in range(max(i0, 0), min(max(i1, i0 + 1), width)):
                    row[i] = letters[s.label]
            rows.append(f"core{c} |" + "".join(row) + "|")
        legend = "  ".join(f"{v}={k}" for k, v in letters.items()
                           if not k.startswith("throttled:"))
        return "\n".join(rows) + f"\n  [{t_start:.1f}..{t_end:.1f}ms] " + \
            legend + "  ~=throttled"


class NullTrace(Trace):
    """A trace that records nothing (``Simulator(trace=False)``).

    ``bench_sim.py --profile`` shows ``Segment`` allocation as the top
    allocator on the event-engine hot path; Monte-Carlo sim-checks (the
    acceptance grid, sweeps) never read the timeline, only the
    ``SimResult`` counters.  Dropping ``record`` to a no-op skips
    Segment construction entirely while every query keeps working
    against the empty timeline (``busy`` -> 0, ``intervals`` -> [],
    ``to_csv`` -> header only).  Counters, misses, percentiles and RTA
    margins are computed from the engines' own state, so results are
    byte-identical with tracing on or off (tested in
    tests/test_trace_optional.py)."""

    def record(self, core: int, label: Optional[str], t0: float, t1: float):
        pass
