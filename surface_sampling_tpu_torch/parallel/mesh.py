"""Rank meshes over a ``torch.distributed`` world.

The counterpart of ``surface_sampling_tpu/parallel/mesh.py``. A JAX mesh
is a grid of devices with named axes; here it is a grid of the global
ranks of an initialised default process group, one rank per card (or per
CPU process), with named axes and one subgroup per row and per column,
built once when the mesh is made so that every rank creates the same
groups in the same order. Each rank owns one device: ``cuda:{local rank}``
on the card (the NCCL backend), or the CPU when the caller asks for it
(the gloo backend).

The mesh never starts a world: the caller does (``torchrun``, or
:func:`spawn_ranks` on one host), so that a missing card or a failed
rendezvous fails instead of falling back to another backend.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from surface_sampling_tpu_torch.device import resolve_device

Axis = str | tuple[str, ...]


def _world() -> tuple[int, int]:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised default process group "
                           "(torch.distributed.init_process_group, torchrun, or spawn_ranks)")
    return dist.get_rank(), dist.get_world_size()


def _rank_device(device) -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK}`` (the global rank when the
    launcher sets none) unless ``device`` names another one; the backend
    must match it (NCCL on the card, gloo on the CPU)."""
    rank, _ = _world()
    if device is None or torch.device(device) == torch.device("cuda"):
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', rank))}"
    dev = resolve_device(device)
    backend = dist.get_backend()
    want = "nccl" if dev.type == "cuda" else "gloo"
    if backend != want:
        raise ValueError(f"a mesh on {dev} needs the {want} backend, the world runs {backend}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


class RankMesh:
    """A grid of global ranks with named axes (the JAX ``Mesh``).

    ``ranks`` is the numpy grid (one dimension per name in ``axis_names``)
    and ``shape`` maps each name to its size. ``device`` is this rank's
    device. For an axis (a name, or the tuple of every name in mesh order,
    which flattens the grid row-major) ``axis_size`` is the number of ranks
    along it, ``axis_index`` this rank's place along it and ``group`` the
    subgroup of the ranks that share this rank's place on the other axes.
    A rank outside the grid has no place and no group."""

    def __init__(self, ranks: np.ndarray, axis_names: tuple[str, ...], device=None):
        ranks = np.asarray(ranks, dtype=np.int64)
        if ranks.ndim != len(axis_names) or ranks.ndim not in (1, 2):
            raise ValueError(f"a mesh has 1 or 2 named axes, got grid {ranks.shape} "
                             f"and names {axis_names}")
        self.ranks, self.axis_names = ranks, tuple(axis_names)
        self.shape = dict(zip(self.axis_names, ranks.shape))
        self.rank = dist.get_rank()
        self.device = _rank_device(device)
        where = np.argwhere(ranks == self.rank)
        self.coords = tuple(int(c) for c in where[0]) if len(where) else None
        # every rank creates every group, in this order: the whole grid,
        # then the lines along each axis (new_group is collective over the
        # world)
        self._groups: dict = {}
        lines = {self.axis_names: [ranks.reshape(-1)]}
        if ranks.ndim == 2:
            lines[(self.axis_names[0],)] = [ranks[:, j] for j in range(ranks.shape[1])]
            lines[(self.axis_names[1],)] = [ranks[i, :] for i in range(ranks.shape[0])]
        else:
            lines[(self.axis_names[0],)] = lines[self.axis_names]
        made = {}
        for key, members in lines.items():
            for line in members:
                ids = tuple(int(r) for r in line)
                if ids not in made:
                    made[ids] = dist.new_group(list(ids))
                if self.rank in ids:
                    self._groups[key] = (made[ids], ids)

    def _key(self, axis: Axis) -> tuple[str, ...]:
        key = (axis,) if isinstance(axis, str) else tuple(axis)
        if key not in ((self.axis_names[0],), (self.axis_names[-1],), self.axis_names):
            raise ValueError(f"axis {axis!r} is not a name of the mesh {self.axis_names} "
                             f"or all of them in order")
        return key

    def axis_size(self, axis: Axis) -> int:
        return int(np.prod([self.shape[a] for a in self._key(axis)]))

    def axis_index(self, axis: Axis) -> int:
        key = self._key(axis)
        if self.coords is None:
            raise ValueError(f"rank {self.rank} is not in the mesh")
        idx = 0
        for a in key:
            i = self.axis_names.index(a)
            idx = idx * self.shape[a] + self.coords[i]
        return idx

    def group(self, axis: Axis):
        """(process group, its member ranks in axis order) along ``axis``."""
        key = self._key(axis)
        if key not in self._groups:
            raise ValueError(f"rank {self.rank} is not in the mesh")
        return self._groups[key]


def all_gather_blocks(x: torch.Tensor, mesh: RankMesh, axis: Axis) -> torch.Tensor:
    """Every rank's block along ``axis`` concatenated on the leading axis,
    in axis order (the blocks must have one shape)."""
    group, members = mesh.group(axis)
    if len(members) == 1:
        return x
    parts = [torch.empty_like(x) for _ in members]
    dist.all_gather(parts, x.contiguous(), group=group)
    # all_gather lists the blocks by group rank, the order of sorted ranks
    by_rank = dict(zip(sorted(members), parts))
    return torch.cat([by_rank[r] for r in members], dim=0)


def all_reduce_mean(x: torch.Tensor, mesh: RankMesh, axis: Axis) -> torch.Tensor:
    """The mean of ``x`` over the ranks along ``axis`` (the sum, then a
    division by their number: JAX's ``pmean``)."""
    group, members = mesh.group(axis)
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x / len(members)


def chain_mesh(n_devices: int | None = None, axis: str = "chains", device=None) -> RankMesh:
    """1-D mesh over every rank of the world, or the first ``n_devices``."""
    _, world = _world()
    n = world if n_devices is None else int(n_devices)
    if n > world:
        raise ValueError(f"need {n} ranks, have {world}")
    return RankMesh(np.arange(n), (axis,), device)


def chain_ensemble_mesh(n_chain: int, n_ensemble: int, device=None) -> RankMesh:
    """2-D mesh: chains x ensemble members (for sharded NN ensembles)."""
    _, world = _world()
    need = n_chain * n_ensemble
    if need > world:
        raise ValueError(f"need {need} ranks, have {world}")
    return RankMesh(np.arange(need).reshape(n_chain, n_ensemble), ("chains", "ensemble"), device)


def pod_mesh(n_pods: int, devices_per_pod: int | None = None, device=None) -> RankMesh:
    """Hierarchical 2-D mesh: outer axis "pod", inner axis "chains".

    Ranks are ordered host-major (torchrun numbers the ranks of one node
    contiguously), so a pod-major reshape keeps each row of the mesh on one
    host, as the JAX package keeps each row inside one ICI domain: a
    collective over "chains" stays in its pod and only "pod"-axis traffic
    crosses hosts."""
    _, world = _world()
    if devices_per_pod is None:
        if world % n_pods:
            raise ValueError(f"{world} ranks do not split into {n_pods} pods")
        devices_per_pod = world // n_pods
    need = n_pods * devices_per_pod
    if world < need:
        raise ValueError(f"need {need} ranks, have {world}")
    return RankMesh(np.arange(need).reshape(n_pods, devices_per_pod), ("pod", "chains"), device)


# ----------------------------------------------------------------------
# A world of processes on one host
# ----------------------------------------------------------------------
def _rank_main(rank: int, fn: Callable, world_size: int, backend: str, store_path: str,
               args: tuple) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    store = dist.FileStore(store_path, world_size)
    # NCCL binds each rank to its card at once (no guess from the rank)
    device_id = torch.device("cuda", rank) if backend == "nccl" else None
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                            device_id=device_id)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world_size: int, device_type: str = "cuda", args: tuple = ()):
    """Run ``fn(rank, *args)`` in ``world_size`` new processes of this host,
    each a rank of a default process group (NCCL for ``device_type``
    "cuda", one card a rank; gloo for "cpu") met through a ``FileStore`` in
    a fresh temporary directory, which is removed afterwards. ``fn`` must
    be importable by name (a module-level function). Raises if a rank
    raises; every process has ended when it returns."""
    backend = {"cuda": "nccl", "cpu": "gloo"}[device_type]
    if device_type == "cuda" and torch.cuda.device_count() < world_size:
        raise RuntimeError(f"{world_size} ranks on the card need {world_size} cards, "
                           f"have {torch.cuda.device_count()}")
    tmp = tempfile.mkdtemp(prefix="ranks_")
    try:
        torch.multiprocessing.spawn(
            _rank_main, args=(fn, world_size, backend, os.path.join(tmp, "store"), args),
            nprocs=world_size, join=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
