"""Logical-axis sharding rules of the port (counterpart of
``repro.sharding.partition``, MaxText-style).

Every parameter and key activation is annotated with a tuple of *logical*
axis names. ``Rules`` maps logical names to mesh axes with JAX's conflict
resolution (a mesh axis appears at most once per spec; later claims are
dropped) and divisibility fallback (a dim not divisible by its mesh axes
tries shorter prefixes of them, then stays replicated).

``Rules.spec`` returns the tuple JAX's ``PartitionSpec`` holds, entry for
entry; ``Rules.placements`` turns it into ``torch.distributed.tensor``
placements, one per mesh dim. A rule reads only the mesh's axis names and
sizes, so the mesh may be a ``DeviceMesh``, the port's ``OneDeviceMesh``,
a plain ``{name: size}`` mapping, or any object whose ``shape`` is one.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

from torch.distributed.tensor import DTensor, Replicate, Shard

MeshAxes = Union[None, str, Tuple[str, ...]]


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} in mesh order, of any mesh the rules take."""
    if mesh is None:
        return {}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(mesh.shape)


class Rules:
    def __init__(self, table: Dict[str, MeshAxes], mesh):
        self.table = dict(table)
        self.mesh = mesh
        self.shape = mesh_shape(mesh)

    def axis_size(self, axes: MeshAxes) -> int:
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        return math.prod(self.shape[a] for a in axes)

    def spec(self, logical: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None) -> tuple:
        """JAX's ``PartitionSpec`` entries for a tensor with the given
        logical dim names: per dim None, a mesh axis name, or a tuple of
        them; trailing Nones trimmed. If ``shape`` is given, a dim not
        divisible by its mesh-axis product takes the longest prefix of
        its axes that divides it, or none."""
        used: set = set()
        out = []
        for i, name in enumerate(logical):
            axes = self.table.get(name) if name else None
            if axes is None:
                out.append(None)
                continue
            if isinstance(axes, str):
                axes = (axes,)
            axes = tuple(a for a in axes if a in self.shape and a not in used)
            if shape is not None:
                while axes and shape[i] % self.axis_size(axes) != 0:
                    axes = axes[:-1]
            if not axes:
                out.append(None)
                continue
            used.update(axes)
            out.append(axes if len(axes) > 1 else axes[0])
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    def placements(self, logical: Sequence[Optional[str]],
                   shape: Optional[Sequence[int]] = None) -> tuple:
        """One placement per mesh dim: ``Shard(d)`` where ``spec`` puts
        that mesh axis on tensor dim d, else ``Replicate()``. A tensor dim
        over several mesh axes is sharded over them in mesh order, which is
        the order ``spec`` lists them in (the rule tables list them so)."""
        spec = self.spec(logical, shape)
        by_axis = {}
        for d, axes in enumerate(spec):
            for a in ((axes,) if isinstance(axes, str) else axes or ()):
                by_axis[a] = d
        return tuple(Shard(by_axis[a]) if a in by_axis else Replicate()
                     for a in self.shape)

    def local_shape(self, logical, shape) -> Tuple[int, ...]:
        """One device's shard of a tensor of ``shape`` under ``spec``."""
        spec = self.spec(logical, shape)
        out = list(shape)
        for d, axes in enumerate(spec):
            if axes is not None:
                out[d] //= self.axis_size(axes)
        return tuple(out)


def multi_device(mesh) -> bool:
    """A mesh of more than one device: its tensors are DTensors."""
    return any(n > 1 for n in mesh_shape(mesh).values())


def batch_axes(mesh, parallel, batch: Optional[int] = None
               ) -> Tuple[str, ...]:
    """The mesh axes a batch dim is sharded over: pod (if the mesh has
    one), then data. With ``batch`` (the global batch), the longest prefix
    of them whose size divides it, as ``Rules.spec`` falls back (a batch of
    1 stays replicated)."""
    shape = mesh_shape(mesh)
    axes = tuple(a for a in (parallel.pod_axis, parallel.data_axis)
                 if a and a in shape)
    if batch is not None:
        while axes and batch % math.prod(shape[a] for a in axes):
            axes = axes[:-1]
    return axes


def make_rules(mesh, parallel) -> Tuple[Rules, Rules]:
    """(param_rules, act_rules) for a ParallelConfig on the given mesh:
    JAX's two tables as they are."""
    shape = mesh_shape(mesh)
    data_axes: Tuple[str, ...] = (parallel.data_axis,)
    if parallel.pod_axis and parallel.pod_axis in shape:
        batch_axes: MeshAxes = (parallel.pod_axis, parallel.data_axis)
    else:
        batch_axes = (parallel.data_axis,)
    model = parallel.model_axis if parallel.tensor_parallel else None

    fsdp_axes: MeshAxes = None
    if parallel.fsdp:
        fsdp_axes = data_axes
        if parallel.fsdp_pod and parallel.pod_axis and \
                parallel.pod_axis in shape:
            fsdp_axes = (parallel.pod_axis, parallel.data_axis)

    param_table: Dict[str, MeshAxes] = {
        "embed": fsdp_axes,          # d_model dim of weights (ZeRO-3 style)
        "vocab": model,
        "vocab_in": fsdp_axes,       # untied input table: rows over fsdp,
        "embed_in": model,           # cols over model (gather stays local)
        "heads": model,              # flattened q_dim
        "kv": model,                 # flattened kv_dim
        "mlp": model,
        "experts": model if parallel.expert_parallel else None,
        "expert_mlp": data_axes,     # weight-stationary MoE: d_ff over data
        "ssm_inner": model,
        "ssm_heads": model,
        "ssm_state": None,
        "lru": model,
        "lru_blocks": model,
        "conv": None,
        "layers": None,              # layer-stack dim
        "frames": None,
    }
    act_table: Dict[str, MeshAxes] = {
        "batch": batch_axes,
        "seq": model if parallel.sequence_parallel else None,
        "kv_seq": model if parallel.shard_kv_seq_on_decode else None,
        "heads": model,
        "kv": model,
        "mlp": model,
        "vocab": model,
        "experts": model if parallel.expert_parallel else None,
        "embed": None,
        "ssm_inner": model,
        "ssm_heads": model,
        "lru": model,
        "frames": None,
    }
    return Rules(param_table, mesh), Rules(act_table, mesh)


def constrain(x, rules: Optional[Rules], logical: Sequence[Optional[str]]):
    """Redistribute a DTensor to the rule's placements for ``logical``
    (JAX's ``with_sharding_constraint``); a plain tensor, or no rules,
    returns ``x`` unchanged. A ``Partial`` input is reduced on the way."""
    if rules is None or not isinstance(x, DTensor):
        return x
    want = rules.placements(logical, x.shape)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def tree_specs(logical_tree, rules: Rules, shape_tree):
    """Map nested dicts of logical tuples + shapes (tuples, or anything
    with ``.shape``) to nested dicts of ``Rules.spec`` tuples."""
    if isinstance(logical_tree, dict):
        return {k: tree_specs(logical_tree[k], rules, shape_tree[k])
                for k in logical_tree}
    sh = shape_tree.shape if hasattr(shape_tree, "shape") else shape_tree
    return rules.spec(logical_tree, tuple(sh))
