"""Checkpoints of the port in the JAX package's on-disk format
(counterpart of ``repro.checkpoint.ckpt``), so that a checkpoint written
by either package restores in the other.

Format: <dir>/step_<N>/manifest.json + leaf_<i>.npy files, one a leaf of
the nested-dict state, in JAX's flatten order (dict keys sorted), each
leaf's path its keys joined by "/"; <dir>/step_<N>.done marks a complete
checkpoint (a save writes .tmp_step_<N> and renames it). ``save`` takes a
host copy of every leaf synchronously, then writes in a thread.

bfloat16 leaves: numpy has no bfloat16 of its own. JAX's leaves carry
ml_dtypes' type, which ``np.save`` stores as 2-byte void ('V2') with
"bfloat16" in the manifest; the port writes the same bytes from the
tensor's bits and rebuilds a bfloat16 tensor from them on restore, so
bf16 leaves round-trip bit for bit without ml_dtypes.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _flatten_with_paths(tree, prefix: Tuple[str, ...] = ()):
    """[(path, leaf)] in JAX's order: dict keys sorted, depth first."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _flatten_with_paths(tree[k], prefix + (str(k),))]
    return [("/".join(prefix), tree)]


def _unflatten_like(like, leaves: Dict[str, Any], prefix=()):
    if isinstance(like, dict):
        return {k: _unflatten_like(v, leaves, prefix + (str(k),))
                for k, v in like.items()}
    return leaves["/".join(prefix)]


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` that later steps cannot change."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if not arr.flags.c_contiguous:
        arr = np.array(arr, order="C")
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self.save_count = 0

    # ------------------------------------------------------------------
    def _save_sync(self, leaves: List[Tuple[str, np.ndarray, str]],
                   step: int, extra: Dict[str, Any]):
        tmp = os.path.join(self.dir, f".tmp_step_{step}")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "extra": extra, "leaves": []}
        for i, (path, arr, dtype) in enumerate(leaves):
            fname = f"leaf_{i}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"].append(
                {"path": path, "file": fname, "shape": list(arr.shape),
                 "dtype": dtype})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        with open(final + ".done", "w") as f:
            f.write(str(time.time()))
        self.save_count += 1
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)
            try:
                os.remove(os.path.join(self.dir, f"step_{s}.done"))
            except OSError:
                pass

    def save(self, state, step: int, extra: Optional[Dict[str, Any]] = None,
             blocking: bool = False):
        """Async by default: snapshot to host, then write in a thread."""
        extra = extra or {}
        leaves = [(path, _to_host(t), str(t.dtype).removeprefix("torch."))
                  for path, t in _flatten_with_paths(state)]
        self.wait()
        if blocking:
            self._save_sync(leaves, step, extra)
        else:
            self._thread = threading.Thread(
                target=self._save_sync, args=(leaves, step, extra),
                daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ------------------------------------------------------------------
    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.endswith(".done") and name.startswith("step_"):
                steps.append(int(name[len("step_"):-len(".done")]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like, step: Optional[int] = None
                ) -> Tuple[Any, Dict[str, Any]]:
        """``like``: a tree of tensors that gives the structure and, leaf
        by leaf, the device. Returns (the tree with the stored leaves, in
        their stored dtypes, on those devices; the ``extra`` dict)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        final = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(final, "manifest.json")) as f:
            manifest = json.load(f)
        by_path = {e["path"]: e for e in manifest["leaves"]}
        out = {}
        for path, leaf in _flatten_with_paths(like):
            entry = by_path[path]
            arr = np.load(os.path.join(final, entry["file"]))
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch at {path}: "
                                 f"{arr.shape} vs {tuple(leaf.shape)}")
            out[path] = _from_host(arr, entry["dtype"]).to(leaf.device)
        return _unflatten_like(like, out), manifest["extra"]
