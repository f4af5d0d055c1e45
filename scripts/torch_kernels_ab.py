#!/usr/bin/env python3
"""Two or more checkouts of the port's four kernels timed against each
other in one process, on one NVIDIA card.

    python3 scripts/torch_kernels_ab.py --src <parent>/src <change>/src \
        [--tags parent change]

Each checkout's kernel wrappers (``repro_torch.kernels.*.ops``) are
imported in turn from its own ``src`` (the ``repro_torch`` modules of the
one before dropped from ``sys.modules``) and their libraries built, each
into its checkout's ``build/``. Every case is then timed as 20 wrapper
calls captured in a CUDA graph and replayed (device time), on the
checkouts in the order 1, 2, .., n, n, .., 1 (parent / change / change /
parent for two): separate processes read one unchanged kernel up to 4.5%
apart, so a check of a few percent needs both in one process. The cases
are the main shapes of each kernel's paths: flash in bf16 (D 64, 128 and
256) and f32 at S = 1024, moe_gmm's bf16 wgmma, swap and fill paths and
its f32 path at olmoe-1b-7b's decode and prefill, ssd_scan and
rglru_scan at S 200 and 1024 in f32 and bf16; inputs from seed 0. Prints
each reading and, for each case, the mean of each checkout's readings
over the first's, with the card's name and power limit, then one JSON
line of every reading. Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
from pathlib import Path

import torch

KERNELS = ("flash_attention", "moe_gmm", "ssd_scan", "rglru_scan")
BF16, F32 = torch.bfloat16, torch.float32
# flash: (label, (B, S, Hq, Hkv, D, window), dtype), causal
FLASH = [("qwen2-7b S=1024", (1, 1024, 28, 4, 128, 0), BF16),
         ("recurrentgemma-9b D 256 window 2048", (1, 1024, 16, 1, 256, 2048),
          BF16),
         ("internvl2-1b D 64", (1, 1024, 14, 2, 64, 0), BF16),
         ("qwen2-7b S=1024", (1, 1024, 28, 4, 128, 0), F32)]
# moe_gmm: (label, E, C, D, F, counts, dtype); the fill row's D and F are
# not multiples of 8 (bf16 TMA cannot address them)
GMM = [("wgmma: prefill T=1024 gate/up", 64, 160, 2048, 1024, "route1024",
        BF16),
       ("swap: decode gate/up", 64, 8, 2048, 1024, "decode", BF16),
       ("swap: EP 16 decode C=16 gate/up", 4, 16, 2048, 1024, "full", BF16),
       ("fill: decode, D and F 4 short", 64, 8, 2044, 1020, "decode", BF16),
       ("f32: decode gate/up", 64, 8, 2048, 1024, "decode", F32),
       ("f32: prefill T=1024 gate/up", 64, 160, 2048, 1024, "route1024",
        F32)]
SCAN_SEQS = (200, 1024)


def load(src: str | None, kernels=KERNELS) -> dict:
    """The wrapper modules of ``kernels`` from the checkout at ``src``
    (None: the ``repro_torch`` already importable), libraries built now,
    while its modules are the ones loaded (a wrapper imports
    ``kernels.build`` when it first builds); its modules stay in
    ``sys.modules`` until the next load."""
    if src is not None:
        for name in [n for n in sys.modules
                     if n == "repro_torch" or n.startswith("repro_torch.")]:
            del sys.modules[name]
        sys.path.insert(0, str(Path(src).resolve()))
    try:
        mods = {k: importlib.import_module(f"repro_torch.kernels.{k}.ops")
                for k in kernels}
        for m in mods.values():
            m.build()
    finally:
        if src is not None:
            sys.path.pop(0)
    return mods


def cases(gen, dev) -> list[tuple]:
    """(kernel, label, call(module)) of every case, inputs drawn now."""
    from torch_gmm_cases import gmm_counts
    from torch_scan_times import rglru_inputs, ssd_inputs
    out = []
    for label, (B, S, Hq, Hkv, D, window), dt in FLASH:
        q = torch.randn((B, S, Hq, D), generator=gen, device=dev).to(dt)
        k, v = (torch.randn((B, S, Hkv, D), generator=gen, device=dev)
                .to(dt) for _ in range(2))
        out.append(("flash_attention", f"{label} {dt}",
                    lambda m, q=q, k=k, v=v, w=window: m.flash_attention(
                        q, k, v, causal=True, window=w)))
    for label, E, C, D, F, kind, dt in GMM:
        x = torch.randn((E, C, D), generator=gen, device=dev).to(dt)
        w = (torch.randn((E, D, F), generator=gen, device=dev)
             * D ** -0.5).to(dt)
        cnt = gmm_counts(kind, E, C, gen, dev)
        out.append(("moe_gmm", f"{label} E={E} C={C} D={D} F={F} {dt}",
                    lambda m, x=x, w=w, c=cnt: m.grouped_matmul(x, w, c)))
    for dt in (F32, BF16):
        for S in SCAN_SEQS:
            a = ssd_inputs(S, dt, gen, dev)
            out.append(("ssd_scan", f"S={S} {dt}",
                        lambda m, a=a: m.ssd_scan(*a, chunk=256)))
            la, gx = rglru_inputs(S, dt, gen, dev)
            out.append(("rglru_scan", f"S={S} {dt}",
                        lambda m, la=la, gx=gx: m.rglru_scan(la, gx)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", nargs="+", required=True,
                    help="checkouts' src directories")
    ap.add_argument("--tags", nargs="+", default=None,
                    help="a label for each --src")
    args = ap.parse_args()
    tags = args.tags or [Path(p).resolve().parent.name for p in args.src]
    if len(tags) != len(args.src):
        ap.error("--tags needs one label for each --src")
    if not torch.cuda.is_available():
        print("torch_kernels_ab: needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    trees = [load(src) for src in args.src]
    from torch_scan_times import graph_ms
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    order = list(range(len(trees))) + list(reversed(range(len(trees))))
    rows = []
    for kernel, label, call in cases(gen, dev):
        got = {t: [] for t in tags}
        for i in order:
            ms = graph_ms(lambda: call(trees[i][kernel]))
            got[tags[i]].append(ms)
            rows.append({"tag": tags[i], "kernel": kernel, "case": label,
                         "graph_ms": ms, "nvidia_smi": smi})
            print(f"[{tags[i]}] {kernel} {label}: CUDA graph {ms:.4f} ms "
                  f"[{smi}]", flush=True)
        base = sum(got[tags[0]]) / len(got[tags[0]])
        print(f"[ratio] {kernel} {label}: " + ", ".join(
            f"{t} / {tags[0]} {sum(v) / len(v) / base:.4f}"
            for t, v in got.items() if t != tags[0]) + f" [{smi}]",
            flush=True)
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
