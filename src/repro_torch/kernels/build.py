"""Build the port's CUDA sources into shared libraries with a plain C
interface, at first use.

Each library is built by ``nvcc`` for ``sm_90a`` from the sources in
``repro_torch/csrc`` alone, into ``build/<name>-<hash>/`` at the root of
the checkout (listed in ``.gitignore``). The directory name carries a hash
of the sources, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source or header builds anew and an unchanged one is loaded as it
is.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class Built:
    lib: ctypes.CDLL
    path: Path
    seconds: float     # 0.0 when an earlier build was loaded
    log: str           # nvcc's output (ptxas register / shared-memory report)


def _tool(name: str) -> str:
    """A CUDA toolkit program (nvcc, cuobjdump): on PATH or in CUDA_HOME."""
    found = shutil.which(name)
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / name
    if cand.exists():
        return str(cand)
    raise RuntimeError(f"{name} not found: the CUDA kernels are built on the "
                       f"machine with the card, with the CUDA toolkit")


def build(name: str, sources: tuple[str, ...]) -> Built:
    """Compile ``sources`` (file names under csrc/) into ``lib<name>.so``
    unless a build of the same sources exists, then load it."""
    paths = [CSRC / s for s in sources]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths + sorted(CSRC.glob("*.cuh")):   # the shared headers too
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out_dir = BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}"
    lib_path = out_dir / f"lib{name}.so"
    log_path = out_dir / "nvcc.log"
    seconds = 0.0
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [_tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp), *map(str, paths)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        log_path.write_text(res.stdout + res.stderr)
        os.replace(tmp, lib_path)
    log = log_path.read_text() if log_path.exists() else ""
    return Built(lib=ctypes.CDLL(str(lib_path)), path=lib_path,
                 seconds=seconds, log=log)


def ptxas_report(log: str) -> list[dict]:
    """Registers, static shared memory and spills of each kernel in an
    ``nvcc -Xptxas -v`` log, names demangled where c++filt is there."""
    kernels, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"kernel": m.group(1), "registers": 0, "static_smem": 0,
                   "spill_stores": 0, "spill_loads": 0}
            kernels.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(sm.group(1)) if sm else 0
    try:
        names = subprocess.run(
            ["c++filt"], input="\n".join(k["kernel"] for k in kernels),
            capture_output=True, text=True, timeout=60,
            check=True).stdout.splitlines()
        if len(names) == len(kernels):
            for k, n in zip(kernels, names):   # name<template args>
                n = n.replace("(anonymous namespace)::", "")
                k["kernel"] = n.removeprefix("void ").split("(")[0]
    except (OSError, subprocess.SubprocessError):
        pass
    return kernels


def sass_counts(lib: Path, kernel: str,
                opcodes: tuple[str, ...]) -> dict[str, dict]:
    """How many instructions of each of ``opcodes`` the SASS of each kernel
    whose mangled name contains ``kernel`` holds in the built library
    (``cuobjdump -sass``), by mangled name; raises if no kernel matches."""
    sass = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    bodies = {f.split("\n", 1)[0].strip(): f
              for f in re.split(r"\n\s*Function : ", sass)[1:]
              if kernel in f.split("\n", 1)[0]}
    if not bodies:
        raise RuntimeError(f"no kernel {kernel!r} in the SASS of {lib}")
    return {name: {op: len(re.findall(rf"\b{op}\b", b)) for op in opcodes}
            for name, b in bodies.items()}
