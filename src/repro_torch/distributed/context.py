"""The mesh a step runs on, and logical activation-sharding constraints:
the JAX package's `distributed/context.py` on `torch.distributed`.

`mesh_context(mesh)` makes `mesh` (a DeviceMesh with a "model" axis and
"data", or "pod" and "data") the current one; the model reads it to find
its tensor-parallel group (`model_group`) and the train step its
data-parallel groups (`data_groups`). With no mesh, or a mesh whose axes
are all 1, nothing changes: every single-process path runs as before.

`constrain(x, "dp", None, "tp", None)` maps logical axes onto the mesh
as the reference does:

    "dp" -> ("pod", "data") | ("data",)   batch-like dims
    "tp" -> "model"                       head and channel dims
    None -> replicated;  "free" -> UNCONSTRAINED

and an axis that does not divide its dim is dropped (UNCONSTRAINED).
With no mesh it is the identity. With one it redistributes a DTensor to
those placements (an UNCONSTRAINED dim keeps its own) and returns a
plain tensor unchanged: the port's tensor-parallel step holds each
rank's local blocks as plain tensors, laid out by the model code itself,
where the reference hands XLA's partitioner a constraint.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

from repro_torch.distributed.sharding import P

_state = threading.local()

#: A dim the partitioner may lay out as it likes (the reference's
#: `P.UNCONSTRAINED`).
UNCONSTRAINED = "unconstrained"


def current_mesh():
    return getattr(_state, "mesh", None)


def _multi_pod() -> bool:
    return getattr(_state, "multi_pod", False)


@contextlib.contextmanager
def mesh_context(mesh, *, multi_pod: bool = False):
    prev = (current_mesh(), _multi_pod())
    _state.mesh, _state.multi_pod = mesh, multi_pod
    try:
        yield
    finally:
        _state.mesh, _state.multi_pod = prev


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(name, mesh=None) -> int:
    """The size of axis `name` (or the product over a tuple of names) of
    `mesh` (the current one by default); 1 without a mesh or the axis."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return 1
    sizes = _sizes(mesh)
    names = name if isinstance(name, (tuple, list)) else (name,)
    return math.prod(sizes.get(n, 1) for n in names)


def model_group(mesh=None):
    """The process group of the "model" axis of `mesh` (the current one
    by default), or None where there is no such axis wider than 1."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None or axis_size("model", mesh) <= 1:
        return None
    return mesh.get_group("model")


def model_index(mesh=None) -> int:
    """This rank's index along "model" (0 without the axis)."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return 0
    return mesh.get_coordinate()[mesh.mesh_dim_names.index("model")]


def data_groups(mesh=None) -> list:
    """The groups of the data-parallel axes of `mesh` wider than 1
    ("pod" and "data"), in that order."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return []
    return [mesh.get_group(n) for n in ("pod", "data")
            if n in mesh.mesh_dim_names and axis_size(n, mesh) > 1]


def data_index(mesh=None) -> tuple:
    """(this rank's index along the data-parallel axes, their size): the
    batch block it takes."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return 0, 1
    coord = mesh.get_coordinate()
    idx, n = 0, 1
    for name in ("pod", "data"):
        if name in mesh.mesh_dim_names:
            i = mesh.mesh_dim_names.index(name)
            idx, n = idx * mesh.shape[i] + coord[i], n * mesh.shape[i]
    return idx, n


def logical_spec(shape, logical, mesh=None, *, multi_pod=None) -> P:
    """The physical spec `constrain` lays a tensor of `shape` out by: one
    entry a dim, an axis name, a tuple of names, None or UNCONSTRAINED."""
    mesh = mesh if mesh is not None else current_mesh()
    multi_pod = _multi_pod() if multi_pod is None else multi_pod
    dp = ("pod", "data") if multi_pod else ("data",)
    parts = []
    for dim, l in zip(shape, logical):
        if l is None:
            parts.append(None)
        elif l == "free":
            parts.append(UNCONSTRAINED)
        else:
            phys = dp if l == "dp" else "model"
            parts.append(phys if dim % axis_size(phys, mesh) == 0
                         else UNCONSTRAINED)
    return P(*parts)


def constrain(x, *logical):
    """x laid out by the logical axes on the current mesh (see the
    module's docstring): a DTensor is redistributed; a plain tensor, or
    any tensor with no mesh, comes back as it is."""
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    spec = logical_spec(x.shape, logical, mesh)
    placements = list(x.placements)
    names = list(mesh.mesh_dim_names)
    for d, part in enumerate(spec):
        if part == UNCONSTRAINED:
            continue
        for i, pl in enumerate(x.placements):
            if isinstance(pl, Shard) and pl.dim == d:
                placements[i] = Replicate()
        for name in () if part is None else (
                part if isinstance(part, tuple) else (part,)):
            placements[names.index(name)] = Shard(d)
    if placements == list(x.placements):
        return x
    return x.redistribute(mesh, placements)
