#!/usr/bin/env python3
"""Device times of the port's grouped-matmul kernel (moe_gmm) on one
NVIDIA card: the serve shapes ``chip_smoke.py`` (c2) times and the
expert-parallel shapes of its phase (t), in bf16 and f32.

    PYTHONPATH=<checkout>/src python3 scripts/torch_gmm_times.py [--tag T]
    python3 scripts/torch_gmm_times.py --src <parent>/src <change>/src \
        [--tags parent change]

Each shape is timed as 20 wrapper calls captured in a CUDA graph and
replayed (device time only: back to back, a call this short is timed by
its wrapper's host dispatch), twice: warm, every call on the same
weights, and cold, the calls rotating over copies of the weights that
together pass 100 MB (the card's L2 holds 50 MB, and a served step
streams each layer's weights from device memory; x is not rotated). Beside
them ``torch.bmm`` on the same inputs (TF32 off), timed the same two ways,
the least time the card could take (``roofline/work.gmm_work``: each input
byte read once, the rows in use multiplied, against 989 TFLOP/s bf16 and
3.35 TB/s; f32 against both the split-TF32 rate the "tf32x3" path runs at,
three TF32 products at 495 TFLOP/s, and the FMA rate, 67 TFLOP/s) and the
kernel's share of each, with the largest absolute difference from the plain
version (``ref.gmm_reference``) and the path the wrapper took where it
reports one. Without ``--src`` the kernel comes from whichever checkout's
``src`` is first on ``PYTHONPATH`` (each builds into its own ``build/``).
With ``--src``, each checkout's package is imported in turn into this one
process (its modules dropped from ``sys.modules`` before the next is
imported) and every shape is timed on the checkouts in the order 1, 2, ..,
n, n, .., 1 (parent / change / change / parent for two): separate
processes read one unchanged kernel up to 4.5% apart. Prints one line a
reading with the card's name and power limit, then one JSON line of every
reading. Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
from pathlib import Path

import torch
from torch_gmm_cases import SERVE_SHAPES, ep_cases, gmm_counts
from torch_kernels_ab import load

PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3}
FMA_OPS = 67e12        # f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
DT_NAME = {torch.float32: "f32", torch.bfloat16: "bf16"}


COLD_BYTES = 100e6   # weight copies a cold reading rotates over, in all


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Mean device time of one call: ``iters`` calls ``fn(0)``, ``fn(1)``,
    .. in a CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def bound(ops: float, nbytes: float, rate: float) -> tuple[float, str]:
    """The larger of ops over ``rate`` and bytes over the memory rate, in
    ms, and which of the two it is."""
    t_ops, t_bytes = ops / rate, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def cases() -> list[tuple]:
    """(label, E, C, D, F, counts) of (c2)'s serve rows and (t)'s rows,
    both SwiGLU directions of each (t) buffer, every row counted."""
    out = list(SERVE_SHAPES)
    for label, e, C, D, Fd in ep_cases():
        out += [(f"EP {label} gate/up", e, C, D, Fd, "full"),
                (f"EP {label} down", e, C, Fd, D, "full")]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="", help="label printed on each line")
    ap.add_argument("--src", nargs="+", default=None,
                    help="checkouts' src directories, timed in one process")
    ap.add_argument("--tags", nargs="+", default=None,
                    help="a label for each --src")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_gmm_times: needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    srcs = args.src or [None]
    tags = args.tags or ([args.tag] if args.src is None else
                         [str(Path(p).resolve().parent.name) for p in srcs])
    if len(tags) != len(srcs):
        ap.error("--tags needs one label for each --src")
    mods = [load(src, ("moe_gmm",))["moe_gmm"] for src in srcs]
    ref = importlib.import_module("repro_torch.kernels.moe_gmm.ref")
    work = importlib.import_module("repro_torch.roofline.work")
    order = list(range(len(mods))) + list(reversed(range(len(mods))))
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rows = []
    for dt in (torch.bfloat16, torch.float32):
        for label, E, C, D, Fd, kind in cases():
            x = torch.randn((E, C, D), generator=gen, device=dev).to(dt)
            w = (torch.randn((E, D, Fd), generator=gen, device=dev)
                 * D ** -0.5).to(dt)
            counts = gmm_counts(kind, E, C, gen, dev)
            want = ref.gmm_reference(x, w, counts).float()
            ops, nbytes = work.gmm_work(E, C, D, Fd, counts, dt)
            bound_ms, bound_by = bound(ops, nbytes, PEAK_OPS[dt])
            n_cold = max(2, -(-int(COLD_BYTES) // w.nbytes))
            ws = [w] + [w.clone() for _ in range(n_cold - 1)]
            bmm = {"bmm_graph_ms": graph_ms(lambda i: torch.bmm(x, w)),
                   "bmm_cold_graph_ms": graph_ms(
                       lambda i: torch.bmm(x, ws[i % n_cold]))}
            case = f"{label} E={E} C={C} D={D} F={Fd} {DT_NAME[dt]}"
            for k in order:
                gmm, tag = mods[k], tags[k]
                paths = dict(getattr(gmm, "launches_by_path", {}))
                out = gmm.grouped_matmul(x, w, counts)
                torch.cuda.synchronize()
                path = next((p for p, n in getattr(gmm, "launches_by_path",
                                                   {}).items()
                             if n != paths.get(p)), "not reported")
                err = (out.float() - want).abs().max().item()
                row = {"tag": tag, "case": case, "path": path,
                       "graph_ms": graph_ms(lambda i: gmm.grouped_matmul(
                           x, w, counts)),
                       "cold_graph_ms": graph_ms(
                           lambda i: gmm.grouped_matmul(
                               x, ws[i % n_cold], counts)),
                       **bmm, "cold_copies": n_cold, "bound_ms": bound_ms,
                       "bound_by": bound_by, "max_abs_err": err,
                       "nvidia_smi": smi}
                row["share"] = bound_ms / row["graph_ms"]
                row["cold_share"] = bound_ms / row["cold_graph_ms"]
                fma = ""
                if dt == torch.float32:
                    fma_ms, fma_by = bound(ops, nbytes, FMA_OPS)
                    row.update(fma_bound_ms=fma_ms, fma_bound_by=fma_by,
                               fma_share=fma_ms / row["graph_ms"])
                    fma = (f"; FMA-rate bound {fma_ms:.4f} ms ({fma_by}), "
                           f"{100 * row['fma_share']:.1f}% of it")
                row["ratio"] = row["graph_ms"] / row["bmm_graph_ms"]
                row["cold_ratio"] = (row["cold_graph_ms"]
                                     / row["bmm_cold_graph_ms"])
                rows.append(row)
                print(f"[{tag}] {case}: {path} path, kernel "
                      f"{row['graph_ms']:.4f} ms, bmm "
                      f"{row['bmm_graph_ms']:.4f} ms, kernel/bmm "
                      f"{row['ratio']:.3f}, "
                      f"{'split-TF32 ' if dt == torch.float32 else ''}bound "
                      f"{bound_ms:.4f} ms ({bound_by}), "
                      f"{100 * row['share']:.1f}% of it{fma}; cold L2 "
                      f"({n_cold} weight copies) kernel "
                      f"{row['cold_graph_ms']:.4f} ms, bmm "
                      f"{row['bmm_cold_graph_ms']:.4f} ms, kernel/bmm "
                      f"{row['cold_ratio']:.3f}, "
                      f"{100 * row['cold_share']:.1f}% of the bound; "
                      f"max_abs_err {err:.3g} [{smi}]", flush=True)
            del ws
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
