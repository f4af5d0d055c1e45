"""The port's writer of ``BENCH_*_torch.json`` files.

Each file carries the provenance header the JAX package's benches stamp
(``benchmarks/run.py`` there): ``schema_version``, ``git_sha``, ``host``,
and ``config`` / ``config_digest`` when a resolved ``ExperimentConfig`` is
passed. The port never writes the JAX package's files.
"""
from __future__ import annotations

import json
import os
import platform
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]

# the JAX package's header version: the payloads keep its shape
BENCH_SCHEMA_VERSION = 2


def git_sha() -> "str | None":
    """HEAD commit of the checkout the bench ran from (None outside one)."""
    try:
        p = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                           capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return None
    sha = p.stdout.strip()
    return sha if p.returncode == 0 and sha else None


def write_bench_json(path, payload: dict, config=None) -> str:
    """Stamp the provenance header onto ``payload`` and write it to
    ``path``. The header keys always win over the payload's."""
    doc = dict(payload)
    doc["schema_version"] = BENCH_SCHEMA_VERSION
    doc["git_sha"] = git_sha()
    if config is not None:
        doc["config"] = config.to_dict()
        doc["config_digest"] = config.content_digest()
    doc["host"] = {
        "platform": platform.platform(),
        "machine": platform.machine(),
        "python": platform.python_version(),
        "cpu_count": os.cpu_count(),
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    return str(path)


def device_info(device) -> dict:
    """What ran the numbers: the card's name and ``nvidia-smi``'s name and
    power limit line, or the CPU."""
    import torch
    if device.type != "cuda":
        return {"kind": "cpu"}
    info = {"kind": torch.cuda.get_device_name(device)}
    try:
        info["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        info["nvidia_smi"] = None
    return info
