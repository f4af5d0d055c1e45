"""What the per-layer metric readers share: the model's dimensions, the
device operations that ran inside spans, and a roofline share."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from gangbench.harness import work

ITEMSIZE = {"bfloat16": 2, "float32": 4}

# names of the port's hand-written kernels in a device trace
FLASH = r"(?<![A-Za-z])flash_fwd"
GMM = r"(?<![A-Za-z])gmm_"
SSD = r"(?<![A-Za-z])ssd_"


def ops_in_spans(run, pattern: str, spans: Sequence) -> float:
    """Device seconds of the operations matching ``pattern`` that started
    inside one of ``spans`` (disjoint spans of lane 0)."""
    tr = run.trace
    if tr is None or not spans:
        return 0.0
    sel = tr.select(pattern)
    t0, t1 = tr.t0[sel], tr.t1[sel]
    a = np.array(sorted(s.t0 for s in spans))
    b = np.array(sorted(s.t1 for s in spans))
    i = np.searchsorted(a, t0, side="right") - 1
    inside = (i >= 0) & (t0 <= b[np.maximum(i, 0)])
    return float((t1[inside] - t0[inside]).sum())


def share(bound_s: float, device_s: float) -> Optional[float]:
    """Bound over measured time, in %; None where nothing ran."""
    if device_s <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / device_s


def bound(run, ops: float, nbytes: float, dtype: str) -> Optional[float]:
    return work.bound_s(ops, nbytes, "bf16" if dtype == "bfloat16"
                        else "f32", run.device_kind)
