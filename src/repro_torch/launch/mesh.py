"""Device meshes over `torch.distributed` — counterpart of
`repro.launch.mesh`.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` with named dims
over the default process group, one rank a device: `make_local_mesh`
((world // model_par, model_par) over ("data", "model")),
`make_macro_mesh` (1-D over ("macro",), the retrieval index's macros)
and `make_production_mesh` ((16, 16) over ("data", "model"), or (2, 16,
16) over ("pod", "data", "model") with `multi_pod`; the `pod` axis
shards the batch too). Ranks are laid out row-major: rank r sits at the
coordinates of r in the mesh's shape.

A mesh needs a process group, and neither machine this runs on has a
network: `init_distributed` starts it with an explicit rank, world size
and `FileStore`, NCCL for the card and gloo for the CPU, never
`env://`. `distributed(...)` is the same as a context that destroys the
group on exit.

The shapes, placements and collectives over a mesh's named dims live in
`repro_torch.spmd`, which every layer uses; `batch_axes` and
`mesh_chips` are also importable from here, as in the reference. The
sharding tables (`models.sharding`, `optim.adamw.zero1_spec` /
`state_shardings`) also take a bare shape, a mapping of axis name ->
size in mesh order such as `production_mesh_shape()` = {"data": 16,
"model": 16}: no process group is needed to build them.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.spmd import batch_axes, mesh_chips  # noqa: F401  (the reference's names)


def init_distributed(rank: int, world_size: int, *, store_path: str,
                     device: DeviceLike = None) -> torch.device:
    """Start the default process group as rank `rank` of `world_size` and
    return this rank's device: the card (`cuda:rank % cards`, NCCL) unless
    `device` is the CPU (gloo). The ranks meet at a `FileStore` at
    `store_path`, a file every rank can reach, absent before the first
    rank starts."""
    if dist.is_initialized():
        raise RuntimeError("a default process group is already running")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside world size {world_size}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for {dev}")
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                            device_id=dev if dev.type == "cuda" else None)
    return dev


@contextlib.contextmanager
def distributed(rank: int, world_size: int, **kw):
    """`init_distributed(...)` for the body of a `with`; the group is
    destroyed on the way out, whatever the body raised."""
    dev = init_distributed(rank, world_size, **kw)
    try:
        yield dev
    finally:
        dist.destroy_process_group()


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("a device mesh needs a process group: start one with "
                           "repro_torch.launch.mesh.init_distributed")
    return dist.get_world_size()


def _mesh(device: DeviceLike, shape: Sequence[int], names: Sequence[str]) -> DeviceMesh:
    dev = resolve_device(device)
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(names))


def make_local_mesh(model_par: int = 1, device: DeviceLike = None) -> DeviceMesh:
    """(world // model_par, model_par) over ("data", "model"): every rank
    of the process group, on the card unless `device` is the CPU."""
    n = _world()
    if model_par < 1 or n % model_par:
        raise ValueError(f"model_par {model_par} does not divide world size {n}")
    return _mesh(device, (n // model_par, model_par), ("data", "model"))


def make_macro_mesh(n_devices: Optional[int] = None,
                    device: DeviceLike = None) -> DeviceMesh:
    """1-D retrieval mesh over ("macro",), one rank per group of DIRC
    macros: what `ShardedDircIndex(parallelism="shard_map")` scores over.
    `n_devices` None is the world size, the only size it may take."""
    n = _world()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"a macro mesh of {n_devices} devices needs world size "
                         f"{n_devices}, this process group has {n}")
    return _mesh(device, (n,), ("macro",))


def production_mesh_shape(multi_pod: bool = False) -> dict:
    """The production mesh as a bare shape: {"data": 16, "model": 16}, or
    {"pod": 2, "data": 16, "model": 16}."""
    return {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> DeviceMesh:
    """The (16, 16) (or (2, 16, 16)) mesh, over a process group of exactly
    its size; any other world size raises ValueError naming the size."""
    shape = production_mesh_shape(multi_pod)
    need = math.prod(shape.values())
    have = dist.get_world_size() if dist.is_initialized() else None
    if have != need:
        raise ValueError(f"the production mesh {tuple(shape.values())} needs world size "
                         f"{need}, the process group has {have}")
    return _mesh(device, tuple(shape.values()), tuple(shape))
