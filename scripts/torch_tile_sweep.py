#!/usr/bin/env python3
"""Tile sweep of the port's two bf16 tensor-core kernels on one NVIDIA card.

    python3 scripts/torch_tile_sweep.py [--kernels flash moe_gmm]

Builds variants of ``src/repro_torch/csrc/flash_attention.cu`` (its
``flash_fwd_wgmma`` path, bf16 at D >= 64: q rows a block at D <= 128
``FW_ROWS``, kv rows a tile at D 64 and 128 ``FW_BK_D64`` /
``FW_BK_D128``, ring stages at D <= 128 ``FW_STAGES``) and of
``moe_gmm.cu`` (its ``gmm_wgmma`` prefill path: output columns a tile
``WG_BN``, TMA ring stages ``WG_STAGES``, 64-column boxes a warpgroup
stages a store ``WG_OBOXES``, and the grid walk: one persistent block an
SM or one block a tile) into ``build/tile_sweep/``, one nvcc per
variant, all started together. Prints each variant's registers and spills
(``-Xptxas -v``), its device time on the serve shapes (20 calls captured
in a CUDA graph, so the host's launch time is left out), its largest
error against the plain version, and the library call's time beside it
(SDPA, ``torch.bmm``). Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from torch_flash_times import bound_ms as flash_bound, sdpa_call  # noqa: E402
from repro_torch.kernels.build import CSRC, NVCC_FLAGS, _tool  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import naive_attention  # noqa: E402
from repro_torch.kernels.moe_gmm.ops import PATHS  # noqa: E402
from repro_torch.kernels.moe_gmm.ref import gmm_reference  # noqa: E402

OUT = ROOT / "build" / "tile_sweep"
WGMMA = PATHS.index("wgmma")
FLASH_WGMMA = fa.PATHS.index("wgmma")
# flash's wgmma path: (FW_ROWS, FW_BK_D64, FW_BK_D128, FW_STAGES); the
# first is the source's own. At 64 rows, a 128-row kv tile or 3 stages at
# D 128 do not leave two blocks an SM (the layout's assertion fails)
FLASH = [(64, 128, 64, 2), (64, 64, 64, 2), (128, 128, 128, 2),
         (128, 128, 64, 2), (128, 128, 64, 3)]
# (D, Sq, Sk, Hq, Hkv, causal, window): the S=1024 prefills of qwen2-7b,
# granite-20b, minitron-4b, olmoe-1b-7b, internvl2-1b, recurrentgemma-9b;
# whisper-base's encoder and a cross-attention; qwen2-7b at S 200
FLASH_SHAPES = [(128, 1024, 1024, 28, 4, True, 0),
                (128, 1024, 1024, 48, 1, True, 0),
                (128, 1024, 1024, 24, 8, True, 0),
                (128, 1024, 1024, 16, 16, True, 0),
                (64, 1024, 1024, 14, 2, True, 0),
                (256, 1024, 1024, 16, 1, True, 2048),
                (64, 1500, 1500, 8, 8, False, 0),
                (64, 300, 1500, 8, 8, False, 0),
                (128, 200, 200, 28, 4, True, 0)]
# moe_gmm's wgmma path: (WG_BN, WG_STAGES, WG_OBOXES, WG_PERSISTENT); the
# first is the source's own
GMM = [(256, 4, 2, True), (256, 3, 2, True), (256, 4, 1, True),
       (128, 5, 2, True), (128, 6, 2, True), (256, 4, 2, False),
       (128, 5, 2, False)]
# (label, E, C, D, F, counts): the serve prefills (64 experts) and the
# expert-parallel receive buffer (4 experts a device, every row counted)
GMM_SHAPES = [("prefill T=1024 gate/up", 64, 160, 2048, 1024, "route1024"),
              ("prefill T=1024 down", 64, 160, 1024, 2048, "route1024"),
              ("prefill T=300 gate/up", 64, 48, 2048, 1024, "route300"),
              ("EP a2a gate/up", 4, 2560, 2048, 1024, "full"),
              ("EP a2a down", 4, 2560, 1024, 2048, "full")]


def flash_source(var) -> str:
    rows, bk64, bk128, stages = var
    text = (CSRC / "flash_attention.cu").read_text()
    for name, value in (("FW_ROWS", rows), ("FW_BK_D64", bk64),
                        ("FW_BK_D128", bk128), ("FW_STAGES", stages)):
        text, n = re.subn(rf"constexpr int {name} = \w+;",
                          f"constexpr int {name} = {value};", text)
        assert n == 1, name
    return text


def gmm_source(var) -> str:
    bn, stages, oboxes, persistent = var
    text = (CSRC / "moe_gmm.cu").read_text()
    for name, value in (("int WG_BN", bn), ("int WG_STAGES", stages),
                        ("int WG_OBOXES", oboxes),
                        ("bool WG_PERSISTENT", str(persistent).lower())):
        text, n = re.subn(rf"constexpr {name} = \w+;",
                          f"constexpr {name} = {value};", text)
        assert n == 1, name
    return text


def build(name: str, fname: str, source: str, kernel_re: str):
    """nvcc one variant; returns (library, 'registers / spills' of the
    kernel whose mangled name matches ``kernel_re``) or (None, error)."""
    out = OUT / name
    out.mkdir(parents=True, exist_ok=True)
    (out / fname).write_text(source)
    for h in CSRC.glob("*.cuh"):
        (out / h.name).write_text(h.read_text())
    lib = out / "lib.so"
    res = subprocess.run([_tool("nvcc"), *NVCC_FLAGS, "-o", str(lib),
                          str(out / fname)], capture_output=True, text=True)
    if res.returncode:
        return None, res.stderr[-1500:]
    info = [k for k in cs.ptxas_report(res.stdout + res.stderr)
            if re.search(kernel_re, k["kernel"])]
    return lib, ", ".join(f"{k['registers']} registers, spills "
                          f"{k['spill_stores']}/{k['spill_loads']} B"
                          for k in info)


def graph_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time of one call: ``iters`` calls in a CUDA graph."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        g.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (iters * reps)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", nargs="+", default=["flash", "moe_gmm"],
                    choices=["flash", "moe_gmm"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_tile_sweep: needs an NVIDIA card", file=sys.stderr)
        return 2
    jobs = []
    if "flash" in args.kernels:
        jobs += [(f"flash_rows{v[0]}_bk{v[1]}x{v[2]}_stages{v[3]}",
                  "flash_attention.cu", flash_source(v),
                  r"flash_fwd_wgmma<\d+, false>") for v in FLASH]
    if "moe_gmm" in args.kernels:
        jobs += [(f"gmm_bn{v[0]}_stages{v[1]}_oboxes{v[2]}_"
                  f"{'persistent' if v[3] else 'plain'}", "moe_gmm.cu",
                  gmm_source(v), rf"gmm_wgmma<{v[0]},") for v in GMM]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip((j[0] for j in jobs),
                         pool.map(lambda j: build(*j), jobs)))
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {cs.nvidia_smi()}")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    cases = []
    for shape in FLASH_SHAPES if "flash" in args.kernels else ():
        d, Sq, Sk, Hq, Hkv, causal, window = shape
        q = torch.randn((1, Sq, Hq, d), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((1, Sk, Hkv, d), generator=gen, device=dev)
                .bfloat16() for _ in range(2))
        ref = naive_attention(q, k, v, causal=causal, window=window)
        lib = sdpa_call(q, k, v, causal, window)
        cases.append((shape, q, k, v, ref, graph_ms(lib)))
        b_ms = flash_bound((1, Sq, Sk, Hq, Hkv, d, causal, window,
                            torch.bfloat16))
        print(f"[flash] D={d} Sq={Sq} Sk={Sk} Hq={Hq} Hkv={Hkv} "
              f"{'causal' if causal else 'full'} window={window}: sdpa "
              f"{cases[-1][-1]:.4f} ms, bound {b_ms:.4f} ms")
    for name, (lib, info) in built.items():
        if not name.startswith("flash_"):
            continue
        if lib is None:
            print(f"[flash] {name}: build failed: {info}")
            continue
        fn = ctypes.CDLL(str(lib)).repro_flash_attention_fwd_bshd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + \
            [ctypes.c_float] * 2 + [ctypes.c_void_p]
        row = []
        for (d, Sq, Sk, Hq, Hkv, causal, window), q, k, v, ref, _ in cases:
            o = torch.empty_like(q)
            call = lambda: fn(  # noqa: E731
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                FLASH_WGMMA, 1, Hq, Hkv, Sq, Sk, d, int(causal), window, 0,
                d ** -0.5, 0.0, stream())
            rc = call()
            torch.cuda.synchronize()
            err = (o.float() - ref.float()).abs().max().item()
            row.append(f"{graph_ms(call):.4f} ms (err {err:.3g}, rc {rc})")
        print(f"[flash] {name}: {info}: " + "; ".join(row))
    cases = []
    for label, E, C, D, Fd, kind in GMM_SHAPES if "moe_gmm" in \
            args.kernels else ():
        x = torch.randn((E, C, D), generator=gen, device=dev).bfloat16()
        w = (torch.randn((E, D, Fd), generator=gen, device=dev)
             * D ** -0.5).bfloat16()
        cnt = cs.gmm_counts(kind, E, C, gen, dev)
        bound_ms, bound_by = cs.gmm_bound(E, C, D, Fd, cnt, torch.bfloat16)
        cases.append((label, x, w, cnt, gmm_reference(x, w, cnt),
                      graph_ms(lambda: torch.bmm(x, w))))
        print(f"[gmm] {label}: bmm {cases[-1][-1]:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by})")
    for name, (lib, info) in built.items():
        if not name.startswith("gmm_"):
            continue
        if lib is None:
            print(f"[gmm] {name}: build failed: {info}")
            continue
        fn = ctypes.CDLL(str(lib)).repro_moe_gmm
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
        row = []
        for label, x, w, cnt, ref, _ in cases:
            E, C, D = x.shape
            o = torch.empty((E, C, w.shape[2]), dtype=x.dtype, device=dev)
            call = lambda: fn(  # noqa: E731
                x.data_ptr(), w.data_ptr(), cnt.data_ptr(), o.data_ptr(),
                WGMMA, E, C, D, w.shape[2], stream())
            rc = call()
            torch.cuda.synchronize()
            err = (o.float() - ref.float()).abs().max().item()
            row.append(f"{graph_ms(call):.4f} ms (err {err:.3g}, rc {rc})")
        print(f"[gmm] {name}: {info}: " + "; ".join(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
