"""Named mesh axes for every layer of the port: shapes, placements and
collectives over the dims of a `torch.distributed` `DeviceMesh`.

A mesh is a `DeviceMesh` with named dims (`launch.mesh` builds them and
starts the process group) or, for the sharding tables, a bare shape: a
mapping of axis name -> size in mesh order such as {"data": 16,
"model": 16}. A spec is what the reference's `PartitionSpec` holds, as a
plain tuple: one entry a dim, each None (replicated), a mesh axis name,
or a tuple of axis names (the dim split over their product, the first
outermost). Ranks are laid out row-major: rank r sits at the coordinates
of r in the mesh's shape.

Every collective here is counted: `read_collectives()` gives, by op,
the calls and the bytes of their outputs ({op: {"count", "bytes"},
"total_bytes"}), an all-reduce weighted 2x as the reference's roofline
weights it (a ring moves each reduced byte twice), and
`reset_collectives()` zeroes the counts. Ranks and serving threads may
issue collectives at once, so every update and read takes one lock, as
the kernels' launch counters do (`kernels.counters`).
"""
from __future__ import annotations

import math
import threading
from collections.abc import Mapping
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

BATCH_AXES = ("pod", "data")

COLLECTIVE_OPS = ("all-reduce", "all-gather")
_WEIGHT = {"all-reduce": 2, "all-gather": 1}   # bytes moved per output byte
_LOCK = threading.Lock()
_COUNTS = {op: {"count": 0, "bytes": 0} for op in COLLECTIVE_OPS}


def _count(op: str, out: torch.Tensor) -> None:
    with _LOCK:
        _COUNTS[op]["count"] += 1
        _COUNTS[op]["bytes"] += _WEIGHT[op] * out.numel() * out.element_size()


def read_collectives() -> dict:
    """The collectives issued since the last reset, read at one instant:
    {op: {"count", "bytes"}, "total_bytes"}."""
    with _LOCK:
        out = {op: dict(c) for op, c in _COUNTS.items()}
    out["total_bytes"] = sum(c["bytes"] for c in out.values())
    return out


def reset_collectives() -> None:
    """Set every collective count to 0."""
    with _LOCK:
        for c in _COUNTS.values():
            c["count"] = c["bytes"] = 0


def mesh_shape(mesh) -> dict:
    """Axis name -> size, in mesh order, of a `DeviceMesh` or a bare shape."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    if isinstance(mesh, Mapping):
        return dict(mesh)
    raise TypeError(f"not a mesh or a mesh shape: {mesh!r}")


def batch_axes(mesh) -> tuple:
    """The axes the batch is sharded over: ("pod", "data") where present."""
    names = mesh_shape(mesh)
    return tuple(a for a in BATCH_AXES if a in names)


def mesh_chips(mesh, axes: Sequence[str] | None = None) -> int:
    """The number of ranks over the mesh dims `axes` (default: all)."""
    sizes = mesh_shape(mesh)
    return math.prod(sizes[a] for a in (sizes if axes is None else axes))


def _check_axes(mesh: DeviceMesh, axes: Sequence[str]) -> list:
    names = list(mesh.mesh_dim_names)
    axes = list(axes)
    if not axes or axes != [n for n in names if n in axes]:
        raise ValueError(f"axes {axes} must be dims of the mesh {names}, in its order")
    return axes


def flat_index(mesh: DeviceMesh, axes: Sequence[str]) -> int:
    """This rank's row-major position over the mesh dims `axes` (the
    reference's `_flat_axis_index`)."""
    idx = 0
    for a in _check_axes(mesh, axes):
        idx = idx * mesh.size(mesh.mesh_dim_names.index(a)) + mesh.get_local_rank(a)
    return idx


def all_gather_axes(x: torch.Tensor, mesh: DeviceMesh, axes: Sequence[str],
                    dim: int = 0) -> torch.Tensor:
    """Every rank's `x` over the mesh dims `axes`, concatenated along
    `dim` in `flat_index` order (the reference's tiled `all_gather`): one
    gather a mesh dim, the innermost first."""
    for a in reversed(_check_axes(mesh, axes)):
        group = mesh.get_group(a)
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        x = torch.cat(parts, dim=dim)
        _count("all-gather", x)
    return x


def all_reduce_axes(x: torch.Tensor, mesh: DeviceMesh, axes: Sequence[str]) -> torch.Tensor:
    """Sum `x` in place over the mesh dims `axes` (one all-reduce a dim)
    and return it."""
    for a in _check_axes(mesh, axes):
        dist.all_reduce(x, group=mesh.get_group(a))
        _count("all-reduce", x)
    return x


def argmax_axes(x: torch.Tensor, offset: int, mesh: DeviceMesh,
                axes: Sequence[str]) -> torch.Tensor:
    """The argmax over the last dim of a tensor split along that dim over
    the mesh dims `axes` (this rank's columns start at global column
    `offset`): int64 global indices, equal to `torch.argmax` of the whole
    tensor, the lowest index winning a tie. Each rank's max and its first
    index go round in one all-gather (as float64, exact for both), and
    every rank reduces them in rank order, which is column order."""
    val, idx = x.max(dim=-1)            # the first index of the max
    mine = torch.stack([val.double(), (idx + offset).double()], dim=-1)
    every = all_gather_axes(mine[None], mesh, axes)          # (ranks, ..., 2)
    best = every[..., 0].argmax(dim=0, keepdim=True)          # the lowest rank wins ties
    return every[..., 1].gather(0, best)[0].long()


def spec_axes(entry) -> tuple:
    """The mesh axes one spec entry names."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec: Sequence, mesh: DeviceMesh) -> tuple:
    """DTensor placements over `mesh`'s dims for a spec: `Shard(d)` on
    each mesh dim that entry d names, `Replicate()` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for a in spec_axes(entry):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def local_shard(full: torch.Tensor, mesh: DeviceMesh, place: Sequence) -> torch.Tensor:
    """This rank's shard (a view) of a tensor every rank holds whole:
    `Shard(d)` on mesh dim i keeps chunk (coordinate i) of dim d, mesh
    dims in order, as DTensor lays shards out. No collective."""
    from torch.distributed.tensor import Shard

    for i, p in enumerate(place):
        if isinstance(p, Shard):
            full = full.chunk(mesh.size(i), dim=p.dim)[mesh.get_local_rank(i)]
    return full
