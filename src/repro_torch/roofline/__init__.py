"""The port's cost analysis and roofline (its counterpart of
``repro.roofline``): ``work`` counts a kernel call's operations and bytes
from its shapes, ``op_analysis.analyze`` counts a callable's FLOPs, bytes
and collective bytes as it runs, and ``report`` turns such counts into
the three roofline terms on an H100."""
