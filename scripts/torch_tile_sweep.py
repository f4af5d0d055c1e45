#!/usr/bin/env python3
"""Tile sweep of the port's tensor-core kernels on one NVIDIA card.

    python3 scripts/torch_tile_sweep.py [--kernels flash tf32x3 moe_gmm swap
                                         gmm_tf32x3 ssd]

Builds variants of ``src/repro_torch/csrc/flash_attention.cu`` (its
``flash_fwd_wgmma`` path, bf16 at D >= 64: q rows a block at D <= 128
``FW_ROWS``, kv rows a tile at D 64 and 128 ``FW_BK_D64`` /
``FW_BK_D128``, ring stages at D <= 128 ``FW_STAGES``; its
``flash_fwd_tf32x3`` path, f32 at D >= 64: the K and V ring stages at
each head dim, ``FT_KST_D*`` / ``FT_VST_D*``, whose 32 KB each share
224 KB with Q's planes, on the same shapes in f32) and of
``moe_gmm.cu`` (its ``gmm_wgmma`` prefill path: output columns a tile
``WG_BN``, TMA ring stages ``WG_STAGES``, 64-column boxes a warpgroup
stages a store ``WG_OBOXES``, and the grid walk: one persistent block an
SM or one block a tile; and its ``gmm_swap_wgmma`` decode path: TMA ring
stages ``SW_STAGES``, each at every split over D, the one ``gmm_splits``
picks marked; and its ``gmm_tf32x3`` f32 path: the TMA ring's stages of
the decode tiles (C <= 16) ``TF_ST_DECODE``, of the 64-row tile
``TF_ST_64`` and of the wide tile ``TF_ST_128``, the wide tile's token
rows ``TF_WIDE_BC`` (128, or C > 64 in 64-row tiles too), the decode
tiles at every split over D; f32 x and w, the f32 time of ``torch.bmm``
beside them) and of ``ssd_scan.cu``
(the rule that splits a
one-chunk call's query tiles over two blocks: as shipped, never, or
whenever the chunk has two query tiles or more, at any grid; and, as a
check of the numerics, lo of each split left unrounded; its key-tile
rows and stages are fixed by the 64-row wgmma tile and one block of 218
KB an SM) into ``build/tile_sweep/``, one nvcc per variant, all started
together. Prints each variant's registers and spills
(``-Xptxas -v``), its device time on the serve shapes (20 calls captured
in a CUDA graph, so the host's launch time is left out), its largest
error against the plain version, and the library call's time beside it
(SDPA, ``torch.bmm``; none for ssd_scan). Exits non-zero without a
card.
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
from repro_torch.kernels.moe_gmm.ops import PATHS, gmm_splits  # noqa: E402
from repro_torch.kernels.moe_gmm.ref import gmm_reference  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_reference  # noqa: E402

OUT = ROOT / "build" / "tile_sweep"
WGMMA = PATHS.index("wgmma")
SWAP = PATHS.index("swap")
GMM_TF32X3_PATH = PATHS.index("tf32x3")
FLASH_WGMMA = fa.PATHS.index("wgmma")
FLASH_TF32X3 = fa.PATHS.index("tf32x3")
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
# flash's tf32x3 path: (K, V) ring stages at D 64, 128 and 256; the first
# is the source's own. Q's planes take 32 / 64 / 128 KB, a stage 32 KB, and
# the layout's assertion fails past 224 KB: 6 / 5 / 3 stages
TF32X3 = [((4, 2), (1, 4), (1, 2)), ((3, 3), (2, 3), (2, 1)),
          ((2, 4), (3, 2), (1, 1)), ((2, 2), (2, 2), (1, 1))]
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
# moe_gmm's swap path: SW_STAGES (the first is the source's own; up to 5
# leave two blocks an SM, 12 is the most one block of 16 token rows fits)
SWAP_STAGES = (4, 3, 5, 6, 8)
# (label, E, C, D, F, counts): olmoe-1b-7b's decode on one card and its
# replicated decode under EP 16 (4 experts a device, every row counted)
SWAP_SHAPES = [("decode gate/up", 64, 8, 2048, 1024, "decode"),
               ("decode down", 64, 8, 1024, 2048, "decode"),
               ("EP C=16 gate/up", 4, 16, 2048, 1024, "full"),
               ("EP C=16 down", 4, 16, 1024, 2048, "full"),
               ("EP C=8 gate/up", 4, 8, 2048, 1024, "full"),
               ("EP C=8 down", 4, 8, 1024, 2048, "full")]

# moe_gmm's tf32x3 path: (TF_ST_DECODE, TF_ST_64, TF_ST_128, TF_WIDE_BC);
# the first is the source's own. More than 5 decode stages leave no two
# blocks an SM, more than 6 / 4 do not fit the 64- / 128-row tile's block
GMM_TF32X3 = [(3, 6, 4, 128), (2, 6, 4, 128), (4, 6, 4, 128),
              (5, 6, 4, 128), (3, 5, 4, 128), (3, 6, 3, 128),
              (3, 6, 4, 64)]
# its shapes: the decode ones (split over D) and the prefill ones, in f32
TF32X3_SHAPES = SWAP_SHAPES + GMM_SHAPES

# ssd_scan: variants as (source line, its replacement); the first is the
# source's own
SSD_SPLIT = ("const int qsplit = l.n_chunks == 1 && Q > 2 * KT && "
             "2LL * blocks <= sms;")
SSD_LO = ("make_float4(sm90::to_tf32(a - h.x), sm90::to_tf32(b - h.y),\n"
          "                    sm90::to_tf32(c - h.z), sm90::to_tf32(d - h.w))")
SSD = {"ssd_split_rule": (),
       "ssd_split_never": ((SSD_SPLIT, "const int qsplit = 0;"),),
       "ssd_split_always": ((SSD_SPLIT, "const int qsplit = l.n_chunks == 1 "
                                        "&& Q > KT;"),),
       "ssd_lo_unrounded": ((SSD_LO, "make_float4(a - h.x, b - h.y, c - h.z, "
                                     "d - h.w)"),)}
# (B, S, strong decay): mamba2-1.3b's prefills (H 64, P 64, N 128, chunk
# 256); one chunk of two and of three query tiles, and of four at batch 2
# (128 blocks unsplit); the strong decay of (c3) at S 1024
SSD_SHAPES = ((1, 32, False), (1, 128, False), (1, 192, False),
              (1, 200, False), (1, 300, False), (1, 1024, False),
              (2, 200, False), (1, 1024, True))


def flash_source(var) -> str:
    rows, bk64, bk128, stages = var
    text = (CSRC / "flash_attention.cu").read_text()
    for name, value in (("FW_ROWS", rows), ("FW_BK_D64", bk64),
                        ("FW_BK_D128", bk128), ("FW_STAGES", stages)):
        text, n = re.subn(rf"constexpr int {name} = \w+;",
                          f"constexpr int {name} = {value};", text)
        assert n == 1, name
    return text


def tf32x3_source(var) -> str:
    text = (CSRC / "flash_attention.cu").read_text()
    for d, (kst, vst) in zip((64, 128, 256), var):
        text, n = re.subn(rf"constexpr int FT_KST_D{d} = \w+, "
                          rf"FT_VST_D{d} = \w+;",
                          f"constexpr int FT_KST_D{d} = {kst}, "
                          f"FT_VST_D{d} = {vst};", text)
        assert n == 1, d
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


def swap_source(stages: int) -> str:
    text = (CSRC / "moe_gmm.cu").read_text()
    text, n = re.subn(r"constexpr int SW_STAGES = \w+;",
                      f"constexpr int SW_STAGES = {stages};", text)
    assert n == 1, "SW_STAGES"
    return text


def gmm_tf32x3_source(var) -> str:
    text = (CSRC / "moe_gmm.cu").read_text()
    decode, st64, st128, wide = var
    text, n = re.subn(r"constexpr int TF_ST_DECODE = \w+, TF_ST_64 = \w+, "
                      r"TF_ST_128 = \w+;",
                      f"constexpr int TF_ST_DECODE = {decode}, TF_ST_64 = "
                      f"{st64}, TF_ST_128 = {st128};", text)
    assert n == 1, "TF_ST_*"
    text, n = re.subn(r"constexpr int TF_WIDE_BC = \w+;",
                      f"constexpr int TF_WIDE_BC = {wide};", text)
    assert n == 1, "TF_WIDE_BC"
    return text


def ssd_source(edits) -> str:
    text = (CSRC / "ssd_scan.cu").read_text()
    for line, repl in edits:
        assert text.count(line) == 1, line
        text = text.replace(line, repl)
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
                    choices=["flash", "tf32x3", "moe_gmm", "swap",
                             "gmm_tf32x3", "ssd"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_tile_sweep: needs an NVIDIA card", file=sys.stderr)
        return 2
    jobs = []
    if "flash" in args.kernels:
        jobs += [(f"flash_rows{v[0]}_bk{v[1]}x{v[2]}_stages{v[3]}",
                  "flash_attention.cu", flash_source(v),
                  r"flash_fwd_wgmma<\d+, false>") for v in FLASH]
    if "tf32x3" in args.kernels:
        jobs += [("tf32x3_" + "_".join(f"d{d}k{k}v{v}" for d, (k, v) in
                                       zip((64, 128, 256), var)),
                  "flash_attention.cu", tf32x3_source(var),
                  r"flash_fwd_tf32x3<\d+, false>") for var in TF32X3]
    if "moe_gmm" in args.kernels:
        jobs += [(f"gmm_bn{v[0]}_stages{v[1]}_oboxes{v[2]}_"
                  f"{'persistent' if v[3] else 'plain'}", "moe_gmm.cu",
                  gmm_source(v), rf"gmm_wgmma<{v[0]},") for v in GMM]
    if "swap" in args.kernels:
        jobs += [(f"swap_stages{s}", "moe_gmm.cu", swap_source(s),
                  r"gmm_swap_wgmma") for s in SWAP_STAGES]
    if "gmm_tf32x3" in args.kernels:
        jobs += [("gtf_decode{}_st64x{}_st128x{}_wide{}".format(*v),
                  "moe_gmm.cu", gmm_tf32x3_source(v), r"gmm_tf32x3")
                 for v in GMM_TF32X3]
    if "ssd" in args.kernels:
        jobs += [(name, "ssd_scan.cu", ssd_source(edits), r"ssd_chunk<float>")
                 for name, edits in SSD.items()]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip((j[0] for j in jobs),
                         pool.map(lambda j: build(*j), jobs)))
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {cs.nvidia_smi()}")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    # flash's wgmma path in bf16 and its tf32x3 path in f32, on the same
    # shapes
    for tag, dt, path in (("flash", torch.bfloat16, FLASH_WGMMA),
                          ("tf32x3", torch.float32, FLASH_TF32X3)):
        if tag not in args.kernels:
            continue
        cases = []
        for shape in FLASH_SHAPES:
            d, Sq, Sk, Hq, Hkv, causal, window = shape
            q = torch.randn((1, Sq, Hq, d), generator=gen, device=dev).to(dt)
            k, v = (torch.randn((1, Sk, Hkv, d), generator=gen, device=dev)
                    .to(dt) for _ in range(2))
            ref = naive_attention(q, k, v, causal=causal, window=window)
            lib = sdpa_call(q, k, v, causal, window)
            cases.append((shape, q, k, v, ref, graph_ms(lib)))
            b_ms = flash_bound((1, Sq, Sk, Hq, Hkv, d, causal, window, dt))
            print(f"[{tag}] D={d} Sq={Sq} Sk={Sk} Hq={Hq} Hkv={Hkv} "
                  f"{'causal' if causal else 'full'} window={window} "
                  f"{cs.DT_NAME[dt]}: sdpa {cases[-1][-1]:.4f} ms, "
                  f"{'split-TF32 ' if dt == torch.float32 else ''}bound "
                  f"{b_ms:.4f} ms")
        for name, (lib, info) in built.items():
            if not name.startswith(f"{tag}_"):
                continue
            if lib is None:
                print(f"[{tag}] {name}: build failed: {info}")
                continue
            fn = ctypes.CDLL(str(lib)).repro_flash_attention_fwd_bshd
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + \
                [ctypes.c_float] * 2 + [ctypes.c_void_p]
            row = []
            for (d, Sq, Sk, Hq, Hkv, causal, window), q, k, v, ref, _ in \
                    cases:
                o = torch.empty_like(q)
                call = lambda: fn(  # noqa: E731
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    path, 1, Hq, Hkv, Sq, Sk, d, int(causal), window, 0,
                    d ** -0.5, 0.0, stream())
                rc = call()
                torch.cuda.synchronize()
                err = (o.float() - ref.float()).abs().max().item()
                row.append(f"{graph_ms(call):.4f} ms (err {err:.3g}, rc "
                           f"{rc})")
            print(f"[{tag}] {name}: {info}: " + "; ".join(row))
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
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p]
        row = []
        for label, x, w, cnt, ref, _ in cases:
            E, C, D = x.shape
            o = torch.empty((E, C, w.shape[2]), dtype=x.dtype, device=dev)
            call = lambda: fn(  # noqa: E731
                x.data_ptr(), w.data_ptr(), cnt.data_ptr(), o.data_ptr(),
                WGMMA, 1, E, C, D, w.shape[2], stream())
            rc = call()
            torch.cuda.synchronize()
            err = (o.float() - ref.float()).abs().max().item()
            row.append(f"{graph_ms(call):.4f} ms (err {err:.3g}, rc {rc})")
        print(f"[gmm] {name}: {info}: " + "; ".join(row))
    cases = []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, E, C, D, Fd, kind in SWAP_SHAPES if "swap" in \
            args.kernels else ():
        x = torch.randn((E, C, D), generator=gen, device=dev).bfloat16()
        w = (torch.randn((E, D, Fd), generator=gen, device=dev)
             * D ** -0.5).bfloat16()
        cnt = cs.gmm_counts(kind, E, C, gen, dev)
        bound_ms, bound_by = cs.gmm_bound(E, C, D, Fd, cnt, torch.bfloat16)
        cases.append((label, x, w, cnt, gmm_reference(x, w, cnt), bound_ms))
        print(f"[swap] {label}: bmm {graph_ms(lambda: torch.bmm(x, w)):.4f}"
              f" ms, bound {bound_ms:.4f} ms ({bound_by}), splits "
              f"{gmm_splits(E, C, D, Fd, sms)} on {sms} SMs")
    for name, (lib, info) in built.items():
        if not name.startswith("swap_"):
            continue
        if lib is None:
            print(f"[swap] {name}: build failed: {info}")
            continue
        fn = ctypes.CDLL(str(lib)).repro_moe_gmm
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p]
        row = []
        for label, x, w, cnt, ref, b_ms in cases:
            E, C, D = x.shape
            Fd = w.shape[2]
            chosen = gmm_splits(E, C, D, Fd, sms)
            for splits in (1, 2, 4, 8):
                o = torch.empty((E, C, Fd), dtype=x.dtype, device=dev)
                call = lambda: fn(  # noqa: E731
                    x.data_ptr(), w.data_ptr(), cnt.data_ptr(), o.data_ptr(),
                    SWAP, splits, E, C, D, Fd, stream())
                rc = call()
                torch.cuda.synchronize()
                err = (o.float() - ref.float()).abs().max().item()
                ms = graph_ms(call)
                row.append(f"{label} splits {splits}"
                           f"{' (chosen)' if splits == chosen else ''} "
                           f"{ms:.4f} ms ({100 * b_ms / ms:.1f}% of the "
                           f"bound, err {err:.3g}, rc {rc})")
        print(f"[swap] {name}: {info}: " + "; ".join(row))
    cases = []
    for label, E, C, D, Fd, kind in TF32X3_SHAPES if "gmm_tf32x3" in \
            args.kernels else ():
        x = torch.randn((E, C, D), generator=gen, device=dev)
        w = torch.randn((E, D, Fd), generator=gen, device=dev) * D ** -0.5
        cnt = cs.gmm_counts(kind, E, C, gen, dev)
        bound_ms, bound_by = cs.gmm_bound(E, C, D, Fd, cnt, torch.float32)
        cases.append((label, x, w, cnt, gmm_reference(x, w, cnt), bound_ms))
        print(f"[gmm_tf32x3] {label}: bmm f32 "
              f"{graph_ms(lambda: torch.bmm(x, w)):.4f} ms, split-TF32 "
              f"bound {bound_ms:.4f} ms ({bound_by}), splits "
              f"{gmm_splits(E, C, D, Fd, sms)} on {sms} SMs")
    for name, (lib, info) in built.items():
        if not name.startswith("gtf_"):
            continue
        if lib is None:
            print(f"[gmm_tf32x3] {name}: build failed: {info}")
            continue
        fn = ctypes.CDLL(str(lib)).repro_moe_gmm
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p]
        row = []
        for label, x, w, cnt, ref, b_ms in cases:
            E, C, D = x.shape
            Fd = w.shape[2]
            chosen = gmm_splits(E, C, D, Fd, sms)
            for splits in (1, 2, 4, 8) if C <= 16 else (1,):
                o = torch.empty((E, C, Fd), device=dev)
                call = lambda: fn(  # noqa: E731
                    x.data_ptr(), w.data_ptr(), cnt.data_ptr(), o.data_ptr(),
                    GMM_TF32X3_PATH, splits, E, C, D, Fd, stream())
                rc = call()
                torch.cuda.synchronize()
                err = (o - ref).abs().max().item()
                ms = graph_ms(call)
                row.append(f"{label} splits {splits}"
                           f"{' (chosen)' if splits == chosen else ''} "
                           f"{ms:.4f} ms ({100 * b_ms / ms:.1f}% of the "
                           f"bound, err {err:.3g}, rc {rc})")
        print(f"[gmm_tf32x3] {name}: {info}: " + "; ".join(row))
    cases = []
    for dt in (torch.float32, torch.bfloat16) if "ssd" in args.kernels \
            else ():
        for B, S, strong in SSD_SHAPES:
            a = cs.ssd_inputs(B, S, 64, 64, 128, dt, gen, dev, strong)
            cases.append((B, S, strong, dt, a,
                          ssd_chunked_reference(*a, chunk=256),
                          cs.ssd_bound(B, S, 64, 64, 128, 256, dt)[0]))
    for name, (lib, info) in built.items():
        if not name.startswith("ssd_"):
            continue
        if lib is None:
            print(f"[ssd] {name}: build failed: {info}")
            continue
        so = ctypes.CDLL(str(lib))
        fn = so.repro_ssd_scan
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + \
            [ctypes.c_void_p]
        so.repro_ssd_scan_workspace.argtypes = [ctypes.c_int] * 6
        so.repro_ssd_scan_workspace.restype = ctypes.c_longlong
        row = []
        for B, S, strong, dt, (x, dtv, Bm, Cm, A), (yr, hr), b_ms in cases:
            Q = min(256, S)
            ws = torch.empty(so.repro_ssd_scan_workspace(B, S, 64, 64, 128, Q),
                             dtype=torch.uint8, device=dev)
            y = torch.empty_like(x)
            h = torch.empty((B, 64, 64, 128), device=dev)
            call = lambda: fn(  # noqa: E731
                x.data_ptr(), dtv.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                A.data_ptr(), y.data_ptr(), h.data_ptr(), ws.data_ptr(),
                0 if dt == torch.float32 else 1, B, S, 64, 64, 128, Q,
                stream())
            rc = call()
            torch.cuda.synchronize()
            err = max((y.float() - yr).abs().max().item(),
                      (h - hr).abs().max().item())
            t = graph_ms(call)
            row.append(f"B={B} S={S}{' strong' if strong else ''} "
                       f"{cs.DT_NAME[dt]} {t:.4f} ms ({100 * b_ms / t:.1f}"
                       f"% of the bound, err {err:.3g}, rc {rc})")
        print(f"[ssd] {name}: {info}: " + "; ".join(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
