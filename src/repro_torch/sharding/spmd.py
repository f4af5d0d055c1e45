"""The port's ``shard_map``: a per-device body over the local shards of
DTensors, with explicit collectives over named mesh axes.

``shard_map(fn, mesh, in_specs, out_specs)`` redistributes each DTensor
argument to its placements, runs ``fn`` on the local tensors and wraps
the outputs as DTensors with ``out_specs``' placements (an argument
whose spec is None passes as it is). As in JAX's ``shard_map``, an input
replicated over a mesh axis is used by every device of that axis, so its
gradient is the sum over that axis (its gradient placement there is
``Partial``), and the gradient of an output replicated over an axis is
divided by the axis size (``_wrap``): a product computed alike on every
device of the axis is then counted once. An output placement ``Partial``
is a per-device partial sum that DTensor reduces where it is next read.

The collectives are ``torch.distributed._functional_collectives`` over
the process group of one mesh axis, each result waited on; over an axis
of one device they are the identity and issue nothing. The gather,
scatter and all-to-all are the autograd forms (their backward is the
matching collective); ``psum`` and ``pmax`` are forward-only, for the
decode paths.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Sequence, Tuple, Union

import torch
import torch.distributed._functional_collectives as fc
from torch.distributed.tensor import DTensor, Partial, Replicate

Axes = Union[str, Tuple[str, ...]]


def _group(mesh, axis: str):
    return mesh.get_group(axis)


def _axes(mesh, axes: Axes) -> tuple:
    """The axes of ``axes`` with more than one device: a collective over
    one device is the identity, and is not issued."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(a for a in axes
                 if mesh.size(mesh.mesh_dim_names.index(a)) > 1)


def axis_index(mesh, axes: Axes) -> int:
    """This device's coordinate along ``axes`` (several axes: row-major,
    the first the slowest)."""
    if isinstance(axes, str):
        return mesh.get_local_rank(axes)
    idx = 0
    for a in axes:
        idx = idx * mesh.size(mesh.mesh_dim_names.index(a)) + \
            mesh.get_local_rank(a)
    return idx


def all_gather(x, mesh, axes: Axes, dim: int):
    """Concatenate the devices' ``x`` along ``dim`` over ``axes`` (JAX's
    ``all_gather(..., tiled=True)``); several axes gather the last first,
    so the result is ordered as ``axis_index``."""
    for a in reversed(_axes(mesh, axes)):
        x = fc.wait_tensor(fc.all_gather_tensor_autograd(
            x.contiguous(), dim, _group(mesh, a)))
    return x


def reduce_scatter(x, mesh, axis: str, dim: int):
    """Sum ``x`` over ``axis`` and keep this device's slice of ``dim``
    (JAX's ``psum_scatter(..., tiled=True)``)."""
    if not _axes(mesh, axis):
        return x
    return fc.wait_tensor(fc.reduce_scatter_tensor_autograd(
        x.contiguous(), "sum", dim, _group(mesh, axis)))


def all_to_all(x, mesh, axis: str):
    """Row block i of ``x`` (split evenly along dim 0) goes to device i of
    ``axis``; the result holds, in block i, what device i sent here
    (JAX's ``all_to_all(split_axis=0, concat_axis=0)``)."""
    if not _axes(mesh, axis):
        return x
    return fc.wait_tensor(fc.all_to_all_single_autograd(
        x.contiguous(), None, None, _group(mesh, axis)))


def psum(x, mesh, axes: Axes):
    """Sum over ``axes`` (forward only)."""
    for a in _axes(mesh, axes):
        x = fc.wait_tensor(fc.all_reduce(x.contiguous(), "sum",
                                         _group(mesh, a)))
    return x


def pmax(x, mesh, axis: str):
    """Maximum over ``axis`` (forward only)."""
    if not _axes(mesh, axis):
        return x
    return fc.wait_tensor(fc.all_reduce(x.contiguous(), "max",
                                        _group(mesh, axis)))


def _grad_placements(pl: Sequence) -> tuple:
    return tuple(Partial() if isinstance(p, Replicate) else p for p in pl)


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the gradient times ``scale`` backward."""

    @staticmethod
    def forward(ctx, x, scale: float):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _wrap(o, mesh, pl):
    """``o`` as a DTensor with placements ``pl``. An output replicated over
    a mesh axis was computed alike by every device of that axis, and each
    device's body adds its gradient to inputs whose gradient is summed
    over the axis: so the gradient arriving at such an output is divided
    by the axis size here, as JAX's shard_map transposes an unmapped
    output."""
    pl = tuple(pl)
    n = 1
    for i, p in enumerate(pl):
        if isinstance(p, Replicate):
            n *= mesh.size(i)
    if n > 1 and o.requires_grad:
        o = _ScaleGrad.apply(o, 1.0 / n)
    return DTensor.from_local(o, mesh, pl, run_check=False)


def shard_map(fn: Callable, mesh, in_specs: Sequence, out_specs):
    """``fn`` over the local shards (see the module docstring). An
    ``in_specs`` entry is a tuple of placements or None; ``out_specs`` is
    one tuple of placements, or a tuple of them for a tuple of outputs."""
    def run(*args):
        local = []
        for a, pl in zip(args, in_specs):
            if pl is None or not isinstance(a, DTensor):
                local.append(a)
                continue
            pl = tuple(pl)
            if tuple(a.placements) != pl:
                a = a.redistribute(mesh, pl)
            local.append(a.to_local(grad_placements=_grad_placements(pl)))
        out = fn(*local)
        if isinstance(out, tuple):
            return tuple(o if pl is None else _wrap(o, mesh, pl)
                         for o, pl in zip(out, out_specs))
        return _wrap(out, mesh, out_specs)
    return run


def follow(pl: Sequence, dims: dict) -> tuple:
    """Placements of a tensor laid out like one with placements ``pl``:
    where ``pl`` shards its dim d, shard dim ``dims[d]`` (replicate where
    ``dims`` has no entry for d, or maps it to None)."""
    from torch.distributed.tensor import Shard
    return tuple(Shard(dims[p.dim]) if isinstance(p, Shard) and
                 dims.get(p.dim) is not None else Replicate() for p in pl)


def placements(mesh, **dims) -> tuple:
    """Placements with ``Shard(d)`` on each named axis (``axis=d``) and
    ``Replicate()`` elsewhere; ``axis=None`` leaves it replicated and
    ``axis="partial"`` makes it ``Partial``."""
    from torch.distributed.tensor import Shard
    out = []
    for a in mesh.mesh_dim_names:
        d = dims.get(a)
        out.append(Replicate() if d is None else
                   Partial() if d == "partial" else Shard(d))
    return tuple(out)


@contextlib.contextmanager
def implicit_replication(on: bool = True):
    """Inside, plain tensors (positions, masks, RoPE frequencies) enter
    DTensor ops as replicated, as in torch's ``implicit_replication``;
    on exit the previous setting comes back, so a nested use keeps the
    outer one and the setting never outlives the call. The model's entry
    points hold it for their forward, the train step for its backward too
    (the recompute of a checkpointed block runs there)."""
    disp = DTensor._op_dispatcher
    prev = disp._allow_implicit_replication
    disp._allow_implicit_replication = prev or on
    try:
        yield
    finally:
        disp._allow_implicit_replication = prev
