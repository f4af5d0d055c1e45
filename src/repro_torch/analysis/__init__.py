"""Analysis fast path (DESIGN.md §13): batched, vectorized
response-time analysis over shards of independent tasksets."""
from repro_torch.analysis.batched_rta import (PaddedBatch, accept_bits,
                                              batched_accepts,
                                              batched_response_times,
                                              batched_schedulable, fixed_point,
                                              pad_rows, pad_tasksets)

__all__ = [
    "PaddedBatch", "pad_tasksets", "pad_rows", "fixed_point", "accept_bits",
    "batched_response_times", "batched_schedulable", "batched_accepts",
]
