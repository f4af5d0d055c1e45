"""Roofline terms on one NVIDIA H100 SXM (the port's counterpart of
``repro.roofline.report``, whose model is a TPU v5e):

    compute term    = FLOPs per device / peak FLOP/s of the compute dtype
    memory term     = bytes per device / HBM bandwidth
    collective term = collective bytes per device / NVLink bandwidth

A cell is one analysed callable per device: ``cell`` builds one from
``op_analysis.analyze``, and the port's dry-run cells (results/
dryrun_torch/, ``repro_torch.launch.dryrun``) carry the same keys. The
port's ``bytes_per_device`` is already the traffic with the kernels
deployed (a kernel's inputs and outputs once); ``bytes_inner_loops_per_
device`` is what the kernels' plain versions move on top, so the memory
term without kernels is their sum (JAX's cells count the inner bytes
inside ``bytes_per_device`` instead).

MODEL_FLOPS = 6 N D (dense) or 6 N_active D (MoE) per training step;
inference steps use 2 N D_new. A cell carries its ``chips`` and
``tokens``; ``SHAPE_TOKENS`` gives the tokens of the JAX package's shape
names for cells that name one and carry none.
"""
from __future__ import annotations

from typing import Dict, Optional

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit:
# 989 TFLOP/s bf16 / fp16 on the tensor cores, 67 TFLOP/s f32 without them
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
# the same data sheet: HBM3, 3.35 TB/s
HBM_BW = 3.35e12
# the same data sheet: NVLink 900 GB/s a GPU, both directions together
NVLINK_BW = 450e9

SHAPE_TOKENS = {
    "train_4k": 4096 * 256,
    "prefill_32k": 32768 * 32,
    "decode_32k": 128,        # one new token per sequence
    "long_500k": 1,
}


def cell(arch: str, shape: str, analysis: Dict, *, dtype: str,
         tokens: int, chips: int = 1, n_params: Optional[int] = None,
         n_active_params: Optional[int] = None) -> Dict:
    """A cell from one ``op_analysis.analyze`` result of a callable that
    ran eagerly on one of ``chips`` devices and processed ``tokens`` tokens
    in all; ``dtype`` is its compute dtype."""
    return {"arch": arch, "shape": shape, "mesh": str(chips),
            "variant": "eager",
            "chips": chips, "tokens": tokens, "dtype": dtype,
            "n_params": n_params, "n_active_params": n_active_params,
            "flops_per_device": analysis["flops"],
            "bytes_per_device": analysis["bytes"],
            "bytes_inner_loops_per_device": analysis["bytes_inner_loops"],
            "collectives_per_device": {
                "total_bytes": analysis["collective_total"],
                "bytes_by_type": dict(analysis["collective_bytes"])},
            "memory": {}}


def model_flops(cell: Dict) -> float:
    """Useful FLOPs per device for the cell (training: 6 N D; inference
    forward-only: 2 N D); 0 when the cell carries no parameter count."""
    n = cell.get("n_active_params") or cell.get("n_params")
    if not n:
        return 0.0
    tokens = cell.get("tokens") or SHAPE_TOKENS[cell["shape"]]
    mult = 6 if cell["shape"].startswith("train") else 2
    return mult * n * tokens / cell["chips"]


def roofline_row(cell: Dict) -> Dict:
    peak = PEAK_FLOPS[cell.get("dtype", "bfloat16")]
    f = cell["flops_per_device"]
    b = cell["bytes_per_device"]
    b_inner = cell.get("bytes_inner_loops_per_device", 0.0)
    # ring all-reduce moves ~2x the payload per link (reduce-scatter +
    # all-gather phases); AG/RS/A2A move ~1x.
    by_type = cell["collectives_per_device"]["bytes_by_type"]
    c = (cell["collectives_per_device"]["total_bytes"]
         + by_type.get("all-reduce", 0.0))
    t_compute = f / peak
    t_memory = (b + b_inner) / HBM_BW       # the plain versions' traffic
    t_memory_k = b / HBM_BW                 # with the kernels deployed
    t_collective = c / NVLINK_BW
    terms = {"compute": t_compute, "memory": t_memory_k,
             "collective": t_collective}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cell)
    bound = max(terms.values())
    bound_nok = max(t_compute, t_memory, t_collective)
    return {
        "arch": cell["arch"], "shape": cell["shape"], "mesh": cell["mesh"],
        "variant": cell.get("variant", "baseline"),
        "dtype": cell.get("dtype", "bfloat16"),
        "compute_s": t_compute,
        "memory_s": t_memory,
        "memory_s_kernel": t_memory_k,
        "collective_s": t_collective,
        "bound_s": bound,
        "dominant": dominant,
        "model_flops_per_dev": mf,
        "op_flops_per_dev": f,
        "useful_flops_ratio": mf / f if f else 0.0,
        "roofline_fraction": (mf / peak) / bound if bound > 0 else 0.0,
        "roofline_fraction_no_kernels": ((mf / peak) / bound_nok
                                         if bound_nok > 0 else 0.0),
        "mem_args_gb": cell["memory"].get("argument_size_bytes", 0) / 2**30,
        "mem_temp_gb": cell["memory"].get("temp_size_bytes", 0) / 2**30,
        "compile_s": cell.get("compile_s"),
    }


def markdown_table(rows) -> str:
    if not rows:
        return "(no dry-run cells found)"
    cols = ["arch", "shape", "mesh", "variant", "compute_s", "memory_s",
            "memory_s_kernel", "collective_s", "dominant",
            "useful_flops_ratio", "roofline_fraction", "mem_args_gb",
            "mem_temp_gb"]
    out = ["| " + " | ".join(cols) + " |",
           "|" + "|".join("---" for _ in cols) + "|"]
    for r in rows:
        out.append("| " + " | ".join(
            f"{r[c]:.6g}" if isinstance(r.get(c), float) else
            str(r.get(c, "")) for c in cols) + " |")
    return "\n".join(out)
