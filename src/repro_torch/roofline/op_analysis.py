"""Per-callable cost analysis of the port: its counterpart of
``repro.roofline.hlo_analysis``, with the same result keys, so that the
report and the dry-run cells share one schema.

JAX's analysis reads the compiled HLO; the port runs eagerly, so
``analyze(fn, *args, **kw)`` runs ``fn`` once under a
``TorchDispatchMode`` and counts every aten op it dispatches:

* ``flops``: 2 M K N for each matrix product (``layers.DOTS``) and
  2 x output elements x (weight elements / output channels) for each
  convolution, as the HLO analysis counts dot and convolution ops;
* ``bytes``: each dispatched op reads its operands and writes its output
  once: the eager port's own memory boundary, as a fusion is JAX's. Views
  move nothing and uninitialised allocations write nothing. An indexed
  read (an embedding lookup) reads the rows it gathers, not its whole
  table, and an indexed write into a buffer (a cache update) reads and
  writes the rows it writes, not the whole buffer: the counterparts of
  the HLO analysis' gather and in-place dynamic-update-slice;
* ``collective_bytes``: the output bytes of each c10d collective (0 on
  one device), under JAX's kind names.

A hand-written kernel launches through ``ctypes``, which no dispatcher
sees, so each kernel wrapper reports its work (``work.charged``): the
analysis charges the kernel's operations and bytes from its shapes
(``roofline.work``) and puts the bytes of the ops dispatched inside the
wrapper (the plain version on the CPU, the launch's staging copies on the
card) into ``bytes_inner_loops`` and their products into no count: the
counterpart of the HLO analysis' depth >= 2 loop traffic, which the
Pallas kernels keep in VMEM. So one callable gives the same ``flops`` and
``bytes`` on the CPU and on the card.

The callable really runs. The kernels' launch counters are restored
afterwards, so an analysis never moves the counts a card check holds.

On a mesh the analysis counts one device: an op on DTensors is passed on
(the mode returns ``NotImplemented`` for it) to DTensor's dispatch, whose
ops on the local shards, and the collectives of its redistributions, are
the ones counted. Under a ``FakeTensorMode`` (the dry run) nothing is
computed; ``memory=True`` then also tracks the bytes of the tensors the
call's ops allocate while they live, for ``peak_bytes``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels.flash_attention import ops as _fa
from repro_torch.kernels.moe_gmm import ops as _gmm
from repro_torch.kernels.rglru_scan import ops as _rg
from repro_torch.kernels.ssd_scan import ops as _ssd
from repro_torch.kernels.ssm_glue import ops as _glue
from repro_torch.models.layers import DOTS
from repro_torch.roofline import work

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# c10d's functional collectives (and their in-place forms) -> JAX's kinds
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all"}
# ops that move no data: allocations left uninitialised, and the view the
# matmul decompositions return without a schema alias
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "_unsafe_view", "device"}
# indexed reads and writes: the first operand is the table or the buffer
_GATHERS = {"index", "embedding", "index_select", "gather"}
_SCATTERS = {"index_put", "index_put_", "index_copy", "index_copy_",
             "scatter", "scatter_", "index_add", "index_add_",
             "scatter_add", "scatter_add_"}
_CONV = torch.ops.aten.convolution.default
_KERNEL_MODULES = (_fa, _gmm, _ssd, _rg, _glue)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _shapes(tree) -> str:
    return ", ".join(f"{str(t.dtype).removeprefix('torch.')}"
                     f"{list(t.shape)}" for t in tree_leaves(tree)
                     if isinstance(t, torch.Tensor))


def _flops(func, args, out) -> int:
    """2 M K N of a matrix product (a leading bias operand of addmm /
    baddbmm is skipped), 2 x outputs x (C_in / groups) x kernel window of
    a convolution; 0 for every other op."""
    if func in DOTS:
        a, b = args[-2], args[-1]
        return 2 * a.numel() * b.shape[-1]
    if func is _CONV:
        w = args[1]
        return 2 * out.numel() * (w.numel() // w.shape[0])
    return 0


class _Counter(TorchDispatchMode):
    def __init__(self, memory: bool = False):
        super().__init__()
        self.memory = memory
        self.live = 0           # bytes of op outputs alive (memory=True)
        self.peak = 0
        self.flops = 0
        self.bytes = 0
        self.bytes_inner = 0
        self.depth = 0          # kernel wrappers entered, nested
        self.paused = False     # a kernel's work is being counted
        self.ops = 0
        self.coll_bytes = {c: 0 for c in COLLECTIVES}
        self.coll_counts = {c: 0 for c in COLLECTIVES}
        self.by_op: Dict[str, List] = {}       # name -> [bytes, calls, sig]
        self.by_coll: Dict[str, List] = {}
        self.kernels: Dict[str, Dict[str, int]] = {}

    def kernel(self, name: str, work: Callable[[], Tuple[int, int]]
               ) -> "_Kernel":
        return _Kernel(self, name, work)

    def _alloc(self, out) -> None:
        """Count each output tensor while it lives."""
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            n = t.numel() * t.element_size()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # count DTensor's local ops instead
        out = func(*args, **(kwargs or {}))
        if self.paused:
            return out
        self.ops += 1
        op = func.overloadpacket.__name__
        if self.memory and not func.is_view and not op.endswith("_") \
                and not func._schema.is_mutable:
            self._alloc(out)
        if func.is_view or op in _NO_TRAFFIC:
            return out
        if op in _GATHERS:        # the rows read, the indices, the output
            b = 2 * _nbytes(out) + _nbytes((args[1:], kwargs))
        elif op in _SCATTERS:     # the values and indices, the rows written
            b = 2 * _nbytes((args[1:], kwargs))
        else:
            b = _nbytes((args, kwargs)) + _nbytes(out)
        if self.depth:
            self.bytes_inner += b
            return out
        self.flops += _flops(func, args, out)
        self.bytes += b
        name = str(func)
        rec = self.by_op.setdefault(name, [0, 0, _shapes(args)])
        rec[0] += b
        rec[1] += 1
        kind = _COLLECTIVE_OPS.get(op)
        if kind and func.namespace in ("_c10d_functional", "c10d"):
            cb = _nbytes(out)
            self.coll_bytes[kind] += cb
            self.coll_counts[kind] += 1
            rec = self.by_coll.setdefault(name, [0, 0, _shapes(out)])
            rec[0] += cb
            rec[1] += 1
        return out


class _Kernel:
    """One kernel wrapper call under an analysis: its work is charged on
    entry (the outermost wrapper only; the ops that count it are not
    counted), and the ops inside are its own."""

    def __init__(self, counter: _Counter, name: str,
                 work: Callable[[], Tuple[int, int]]):
        self.counter, self.name, self.work = counter, name, work

    def __enter__(self) -> None:
        c = self.counter
        if not c.depth:
            c.paused = True
            try:
                ops, nbytes = self.work()
            finally:
                c.paused = False
            c.flops += ops
            c.bytes += nbytes
            k = c.kernels.setdefault(self.name, {"calls": 0, "flops": 0,
                                                 "bytes": 0})
            k["calls"] += 1
            k["flops"] += ops
            k["bytes"] += nbytes
        c.depth += 1

    def __exit__(self, *exc) -> bool:
        self.counter.depth -= 1
        return False


def _top(recs: Dict[str, List], n: int) -> List[Dict]:
    rows = sorted(((b, name, calls, sig) for name, (b, calls, sig)
                   in recs.items()), reverse=True)[:n]
    return [{"bytes": float(b), "kind": name, "mult": float(calls),
             "sig": sig[:90]} for b, name, calls, sig in rows]


def analyze(fn, *args, memory: bool = False, result: list | None = None,
            **kw) -> Dict[str, object]:
    """Run ``fn(*args, **kw)`` once and count its FLOPs, bytes and
    collective bytes (see the module docstring); the keys of
    ``repro.roofline.hlo_analysis.analyze``, plus ``ops`` (the aten ops
    dispatched), ``kernels`` (per kernel wrapper: calls and the
    operations and bytes charged) and, with ``memory``, ``peak_bytes``.
    ``result``, a list, receives ``fn``'s return value. A wrapper that
    raises raises here."""
    counter = _Counter(memory)
    saved = [(m.launches, dict(getattr(m, "launches_by_path", {})))
             for m in _KERNEL_MODULES]
    prev = work.set_current(counter)
    prop = DTensor._op_dispatcher.sharding_propagator
    name = "_propagate_tensor_meta_non_cached"
    outer = vars(prop).get(name)          # an enclosing analysis's patch
    meta = getattr(prop, name)

    def shapes_only(*a, **k):
        # DTensor runs an op on fake tensors of the global shapes to find
        # its output's shape: no device runs that
        paused, counter.paused = counter.paused, True
        try:
            return meta(*a, **k)
        finally:
            counter.paused = paused

    setattr(prop, name, shapes_only)
    try:
        with counter:
            out = fn(*args, **kw)
            if result is not None:
                result.append(out)
    finally:
        if outer is None:
            delattr(prop, name)
        else:
            setattr(prop, name, outer)
        work.set_current(prev)
        for m, (n, by_path) in zip(_KERNEL_MODULES, saved):
            m.launches = n
            if by_path:
                m.launches_by_path.update(by_path)
    coll_total = sum(counter.coll_bytes.values())
    return {
        "flops": float(counter.flops),
        "bytes": float(counter.bytes),
        "bytes_inner_loops": float(counter.bytes_inner),
        "collective_bytes": {k: float(v)
                             for k, v in counter.coll_bytes.items()},
        "collective_counts": {k: float(v)
                              for k, v in counter.coll_counts.items()},
        "collective_total": float(coll_total),
        "top_collectives": _top(counter.by_coll, 20),
        "top_bytes_ops": _top(counter.by_op, 25),
        "ops": counter.ops,
        "kernels": counter.kernels,
        "peak_bytes": float(counter.peak),
    }
