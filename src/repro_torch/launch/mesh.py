"""Meshes over ``torch.distributed``: one process per device, SPMD.

Every rank runs the same host loop; a :class:`Mesh` wraps a
``DeviceMesh`` with the reference's axes ``("data", "model")`` and exposes
what the port's mesh path reads: ``shape`` (axis -> size, the contract the
partition rules of ``sharding/specs.py`` read), ``group(axis)``,
``coords`` (this rank's place on each axis) and ``device``.  Ranks talk
over ``nccl`` on the card and ``gloo`` on the CPU.

A multi-rank mesh needs its process group started by the launcher, one
process per device, with ``torch.distributed.init_process_group``'s
address, world size and rank given explicitly.  One H100 holds one rank
(NCCL refuses two ranks on one device), so the card runs the ``(1, 1)``
mesh, for which :func:`make_serving_mesh` starts a world-size-1 group on a
``HashStore`` itself (no TCP port); larger meshes run on the CPU over
gloo in the tests.

The dry run (``launch/dryrun.py``) stands in for the reference's 512
forced host devices with :func:`dryrun_world`: a ``fake`` process group
of 256 or 512 ranks in this one process, whose collectives return at once
and whose tensors are ``meta`` tensors, so it needs no card.

Functions, not module-level constants: importing this module touches no
process group.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Tuple

import torch
import torch.distributed as dist


class Mesh:
    """A ``DeviceMesh`` with the reading the port's mesh path needs."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.axes: Tuple[str, ...] = tuple(device_mesh.mesh_dim_names)
        self.shape: Dict[str, int] = {a: device_mesh.size(i)
                                      for i, a in enumerate(self.axes)}
        self.device = device

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def coord(self, axis: str) -> int:
        return self.device_mesh.get_local_rank(axis)

    @property
    def coords(self) -> Tuple[int, ...]:
        return tuple(self.coord(a) for a in self.axes)

    @property
    def world(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    def sub(self, axis: str) -> "Mesh":
        """The one-axis sub-mesh this rank sits in (e.g. the L tier's
        ``model`` group)."""
        return Mesh(self.device_mesh[axis], self.device)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, coords={self.coords}, {self.device})"


# one Mesh per (shape, device) in a process: building a DeviceMesh creates
# process groups, collectively on every rank, and groups are not freed
# until the process group is destroyed
_MESHES: Dict[Tuple, Mesh] = {}


def _start_single_rank(backend: str) -> None:
    """A world-size-1 group on an in-process store: no port, no launcher."""
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_serving_mesh(data: int = 1, model: int = 1,
                      device: str = "cuda") -> Mesh:
    """(data, model) mesh for the mesh-sharded serving scheduler.

    ``data`` is the S-tier replica count (each replica owns its own slots
    and paged pool), ``model`` the L tier's tensor-parallel axis.  A
    (1, 1) mesh is the debug configuration: the mesh path runs on one
    device and must be token-identical to the single-device path.  The
    world size is checked up front: a launcher that started the wrong
    number of ranks gets told how to launch, not an opaque failure in the
    first collective."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device "
                           "is available")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    need = data * model
    if not dist.is_initialized():
        if need != 1:
            raise RuntimeError(
                f"serving mesh ({data}, {model}) needs {need} ranks, and no "
                "process group is started; launch one process per device "
                f"and call torch.distributed.init_process_group('{backend}', "
                f"init_method=..., world_size={need}, rank=...) in each "
                "before building the mesh")
        _start_single_rank(backend)
    world = dist.get_world_size()
    if world != need:
        raise RuntimeError(
            f"serving mesh ({data}, {model}) needs {need} ranks, the process "
            f"group has {world}; start world_size={need} (one process per "
            "device)")
    if dev.type == "cuda":
        if need > torch.cuda.device_count():
            raise RuntimeError(
                f"serving mesh ({data}, {model}) needs {need} devices, have "
                f"{torch.cuda.device_count()}: NCCL takes one rank per "
                "device")
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    key = (data, model, str(dev))
    if key not in _MESHES:
        from torch.distributed.device_mesh import init_device_mesh
        dm = init_device_mesh(dev.type, (data, model),
                              mesh_dim_names=("data", "model"))
        _MESHES[key] = Mesh(dm, dev)
    return _MESHES[key]


def make_debug_mesh(data: int = 1, model: int = 1,
                    device: str = "cuda") -> Mesh:
    """Tiny mesh over however many ranks were started (tests)."""
    return make_serving_mesh(data, model, device)


@contextlib.contextmanager
def dryrun_world(world: int, rank: int = 0) -> Iterator[None]:
    """A ``fake`` process group of ``world`` ranks, this process as
    ``rank``, for the block: collectives on it move nothing (the dry run
    counts their bytes).  On exit the group is destroyed and the meshes
    made inside the block are forgotten, so a later
    :func:`make_serving_mesh` starts from no group."""
    if dist.is_initialized():
        raise RuntimeError("dry-run world: a process group is already "
                           "started in this process")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    before = set(_MESHES)
    try:
        yield
    finally:
        for key in set(_MESHES) - before:
            del _MESHES[key]
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False,
                         device: str = "cuda") -> Mesh:
    """The reference's production mesh: 16 x 16 = 256 ranks, axes (data,
    model), or 2 x 16 x 16 = 512 with ``pod`` in front."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for s in shape:
        need *= s
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise RuntimeError(
            f"need {need} ranks for mesh {shape}, have {have}; launch one "
            "process per device with torch.distributed")
    from torch.distributed.device_mesh import init_device_mesh
    dev = torch.device(device)
    return Mesh(init_device_mesh(dev.type, shape, mesh_dim_names=axes), dev)
