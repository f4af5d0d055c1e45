#!/usr/bin/env python3
"""Tile sweep of the port's two bf16 tensor-core kernels on one NVIDIA card.

    python3 scripts/torch_tile_sweep.py

Builds variants of ``src/repro_torch/csrc/flash_attention.cu`` (its
bf16 tile constants: kv rows a tile, blocks an SM for
``__launch_bounds__``, the largest head dim whose Q is held in registers)
and of ``moe_gmm.cu`` (the prefill tile: C rows, depth a stage, ring
stages, blocks an SM) into ``build/tile_sweep/``, one nvcc per variant,
all started together. Prints each variant's registers and spills
(``-Xptxas -v``), its device time on the serve shapes (20 calls captured
in a CUDA graph, so the host's launch time is left out), its largest
error against the plain version, and the library call's time beside it
(SDPA, ``torch.bmm``). Exits non-zero without a card.
"""
from __future__ import annotations

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
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels.build import CSRC, NVCC_FLAGS, _nvcc  # noqa: E402
from repro_torch.kernels.flash_attention.ref import naive_attention  # noqa: E402
from repro_torch.kernels.moe_gmm.ref import gmm_reference  # noqa: E402

OUT = ROOT / "build" / "tile_sweep"
# flash: (kv rows a tile, blocks an SM, largest D with Q in registers);
# the first is the source's own
FLASH = [(64, 2, 128), (32, 3, 128), (32, 3, 64), (64, 2, 64), (32, 2, 128)]
FLASH_SHAPES = [(128, 1024, 28, 4, 0), (128, 1024, 16, 16, 0),
                (128, 1024, 28, 4, 64), (256, 1024, 16, 1, 2048),
                (256, 1024, 16, 1, 256)]
# moe_gmm prefill: (BC, BK, STAGES, MINB); the first is the source's own
GMM = [(64, 64, 4, 1), (64, 32, 4, 1), (64, 32, 4, 3), (128, 32, 4, 1),
       (64, 64, 3, 1), (128, 64, 3, 1)]
GMM_SHAPES = [("decode gate/up", 8, 2048, 1024, "decode"),
              ("prefill T=1024 gate/up", 160, 2048, 1024, "route1024"),
              ("prefill T=1024 down", 160, 1024, 2048, "route1024"),
              ("prefill T=300 gate/up", 48, 2048, 1024, "route300")]


def flash_source(var) -> str:
    bk, minb, q_regs_d = var
    text = (CSRC / "flash_attention.cu").read_text()
    for old, new in (("TC_BK = 64, TC_MINB = 2;",
                      f"TC_BK = {bk}, TC_MINB = {minb};"),
                     ("  return D <= 128;", f"  return D <= {q_regs_d};")):
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    return text


def gmm_source(var) -> str:
    bc, bk, stages, mb = var
    text = (CSRC / "moe_gmm.cu").read_text()
    for old, new in (("constexpr int TC_STAGES = 4;",
                      f"constexpr int TC_STAGES = {stages};"),
                     ("SWAP ? 2 : 1)", f"SWAP ? 2 : {mb})"),
                     ("return launch_tc<64, 64, false>(",
                      f"return launch_tc<{bc}, {bk}, false>(")):
        assert old in text, old
        text = text.replace(old, new)
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
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib),
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
    if not torch.cuda.is_available():
        print("torch_tile_sweep: needs an NVIDIA card", file=sys.stderr)
        return 2
    jobs = [(f"flash_bk{v[0]}_minb{v[1]}_qregs_to_d{v[2]}",
             "flash_attention.cu", flash_source(v),
             r"flash_fwd_tc<(128|256)>") for v in FLASH]
    jobs += [(f"gmm_bc{v[0]}_bk{v[1]}_stages{v[2]}_minb{v[3]}", "moe_gmm.cu",
              gmm_source(v), rf"gmm_tc<{v[0]}, {v[1]}, false>") for v in GMM]
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
    for d, S, Hq, Hkv, window in FLASH_SHAPES:
        q, k, v = (torch.randn((1, S, h, d), generator=gen, device=dev)
                   .bfloat16() for h in (Hq, Hkv, Hkv))
        ref = naive_attention(q, k, v, causal=True, window=window)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        if window:
            i = torch.arange(S, device=dev)
            mask = (i[None] <= i[:, None]) & (i[None] > i[:, None] - window)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qh, kh, vh, attn_mask=mask, enable_gqa=True)
        else:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qh, kh, vh, is_causal=True, enable_gqa=True)
        cases.append((d, S, Hq, Hkv, window, q, k, v, ref, graph_ms(lib)))
        print(f"[flash] D={d} S={S} Hq={Hq} Hkv={Hkv} window={window}: "
              f"sdpa {cases[-1][-1]:.4f} ms")
    for name, (lib, info) in built.items():
        if not name.startswith("flash_"):
            continue
        if lib is None:
            print(f"[flash] {name}: build failed: {info}")
            continue
        fn = ctypes.CDLL(str(lib)).repro_flash_attention_fwd_bshd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + \
            [ctypes.c_float, ctypes.c_void_p]
        row = []
        for d, S, Hq, Hkv, window, q, k, v, ref, _ in cases:
            o = torch.empty_like(q)
            call = lambda: fn(  # noqa: E731
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1,
                Hq, Hkv, S, S, d, 1, window, d ** -0.5, stream())
            rc = call()
            torch.cuda.synchronize()
            err = (o.float() - ref.float()).abs().max().item()
            row.append(f"{graph_ms(call):.4f} ms (err {err:.3g}, rc {rc})")
        print(f"[flash] {name}: {info}: " + "; ".join(row))
    cases = []
    for label, C, D, Fd, kind in GMM_SHAPES:
        x = torch.randn((64, C, D), generator=gen, device=dev).bfloat16()
        w = (torch.randn((64, D, Fd), generator=gen, device=dev)
             * D ** -0.5).bfloat16()
        cnt = cs.gmm_counts(kind, 64, C, gen, dev)
        cases.append((label, x, w, cnt, gmm_reference(x, w, cnt),
                      graph_ms(lambda: torch.bmm(x, w))))
        print(f"[gmm] {label}: bmm {cases[-1][-1]:.4f} ms")
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
                x.data_ptr(), w.data_ptr(), cnt.data_ptr(), o.data_ptr(), 1,
                E, C, D, w.shape[2], stream())
            rc = call()
            torch.cuda.synchronize()
            err = (o.float() - ref.float()).abs().max().item()
            row.append(f"{graph_ms(call):.4f} ms (err {err:.3g}, rc {rc})")
        print(f"[gmm] {name}: {info}: " + "; ".join(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
