"""DeepPicar DAVE-2 CNN — the paper's own real-time DNN control workload.

NVIDIA DAVE-2 architecture (Bojarski et al., arXiv:1604.07316) as used by
DeepPicar [Bechtel et al., RTCSA'18] and by RT-Gang's case study (paper §II,
Fig.1, Fig.6): 200x66 RGB input, 5 conv layers, 3 fc layers + steering output.
This is not one of the 10 assigned LM architectures; it exists to drive the
paper-faithful benchmarks (fig1/fig6) on the gang-scheduled executor.
"""
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class Dave2Config:
    name: str = "deeppicar-dave2"
    input_hw: Tuple[int, int] = (66, 200)
    in_channels: int = 3
    # (out_channels, kernel, stride)
    conv: Tuple[Tuple[int, int, int], ...] = (
        (24, 5, 2), (36, 5, 2), (48, 5, 2), (64, 3, 1), (64, 3, 1))
    fc: Tuple[int, ...] = (100, 50, 10)
    n_outputs: int = 1


CONFIG = Dave2Config()
