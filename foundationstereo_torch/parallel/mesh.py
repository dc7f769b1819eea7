"""Meshes: the port of the JAX package's ``parallel/mesh.py``.

Two kinds, both made current with ``mesh_context``:

* ``RankMesh`` -- the ranks of a ``torch.distributed`` process group as a
  (data, spatial) grid, one process per entry. This is what ``make_mesh``
  returns once ``distributed.initialize`` has run. Each rank runs the same
  model code on its part: its slice of the batch along ``data`` and, where
  ``spatial`` > 1, its columns of the image width from the cost volume on
  (``parallel/spatial.py``, the counterpart of GSPMD's partitioning under
  ``shard_spatial``) and its share of the ViT attention's heads, gathered
  over its spatial group (``ops/sharded.py:flash_attention_sharded``).
* ``Mesh`` -- a grid of ``torch.device``s seen from one process (the JAX
  package's single-controller mesh), over which the sharded kernels run
  shard by shard.

Both have the named axes:

* ``data``    -- batch parallelism;
* ``spatial`` -- image-width sharding of the cost volume and its lookup
  (and, under a ``RankMesh``, of the partitioned forward), and head
  sharding of the ViT attention.

The sharded kernels (``ops/sharded.py``) run each shard on its own entry of
the mesh, under that device's guard, and gather the results on the device
the caller's tensors live on. A mesh may name one card several times
(``make_mesh(devices=[torch.device("cuda:0")] * 4)``): its shards then run
one after another on that card at the per-device shapes of a 4-card mesh,
as the JAX tests run on virtual CPU devices. ``devices=[torch.device("cpu")]
* n`` gives a mesh on the CPU, where every kernel wrapper takes its twin.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

_ACTIVE_MESH: contextvars.ContextVar[Optional["Mesh | RankMesh"]] = contextvars.ContextVar(
    "fstorch_mesh", default=None)


class Mesh:
    """``devices``: an object ndarray of ``torch.device`` whose axes are
    ``axis_names``; ``shape`` maps each axis name to its size and ``size``
    counts the entries (a card named twice counts twice)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes {self.axis_names}")
        self.devices = devices
        self.shape = dict(zip(self.axis_names, devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device(self, **coords: int) -> torch.device:
        """The entry at the given axis coordinates (0 along any axis not named)."""
        return self.devices[tuple(coords.get(n, 0) for n in self.axis_names)]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def factor(n: int) -> tuple[int, int]:
    """(data, spatial) of ``n`` entries as the JAX package factors them:
    ``spatial`` takes the largest power of two <= 4 that divides n, ``data``
    the rest."""
    spatial = 1
    while spatial < 4 and n % (spatial * 2) == 0:
        spatial *= 2
    return n // spatial, spatial


def _group(ranks: list[int]):
    """A process group over ``ranks`` (None for one rank, the default group
    for all of them). Every rank must call this for every group, in the
    same order."""
    if len(ranks) == 1:
        return None
    if len(ranks) == dist.get_world_size():
        return dist.group.WORLD
    return dist.new_group(ranks)


class RankMesh:
    """The ranks of the default process group as a (data, spatial) grid:
    rank r sits at (r // spatial, r % spatial), as the JAX package lays its
    devices out. ``shape``, ``size`` and ``axis_names`` as a ``Mesh``'s;
    ``data_index``/``spatial_index`` are this rank's coordinates,
    ``data_group`` the ranks that share its spatial index (None for one),
    ``spatial_group`` those that share its data index (None for one) and
    ``group`` all of them. Building one is collective: every rank builds the
    same shape at the same point."""

    axis_names = ("data", "spatial")

    def __init__(self, shape: Sequence[int] | None = None):
        if not dist.is_initialized():
            raise RuntimeError("a RankMesh needs a process group: call "
                               "parallel.distributed.initialize first")
        world, rank = dist.get_world_size(), dist.get_rank()
        nd, ns = factor(world) if shape is None else tuple(shape)
        if nd * ns != world:
            raise ValueError(f"mesh shape {(nd, ns)} != {world} ranks")
        self.shape = {"data": nd, "spatial": ns}
        self.data_index, self.spatial_index = divmod(rank, ns)
        self.group = dist.group.WORLD
        for d in range(nd):
            g = _group([d * ns + s for s in range(ns)])
            if d == self.data_index:
                self.spatial_group = g
        for s in range(ns):
            g = _group([d * ns + s for d in range(nd)])
            if s == self.spatial_index:
                self.data_group = g

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["spatial"]

    def __repr__(self) -> str:
        return (f"RankMesh({self.shape}, rank at data {self.data_index}, "
                f"spatial {self.spatial_index})")


def make_mesh(n_devices: int | None = None,
              axis_names: Sequence[str] = ("data", "spatial"),
              shape: Sequence[int] | None = None,
              devices=None) -> Mesh | RankMesh:
    """With a process group and no ``devices``: the ``RankMesh`` of its
    ranks (``n_devices``, where given, must be the world size). Otherwise a
    ``Mesh`` over the first ``n_devices`` of ``devices`` (every CUDA device
    when not given; raises without one).

    If ``shape`` is not given, the count is factored as the JAX package
    factors it (``factor``).
    """
    if devices is None and dist.is_initialized():
        world = dist.get_world_size()
        if n_devices not in (None, world):
            raise ValueError(f"n_devices {n_devices} but the process group has {world} ranks")
        if tuple(axis_names) != RankMesh.axis_names:
            raise ValueError(f"a RankMesh has the axes {RankMesh.axis_names}, not {axis_names}")
        return RankMesh(shape)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass devices=[torch.device('cpu')] * n for a "
                               "mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if shape is None:
        if len(axis_names) == 1:
            shape = (n,)
        else:
            shape = factor(n) + (1,) * (len(axis_names) - 2)
    if math.prod(shape) != n:
        raise ValueError(f"shape {tuple(shape)} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(tuple(shape)), axis_names)


def current_mesh() -> Optional[Mesh | RankMesh]:
    return _ACTIVE_MESH.get()


@contextlib.contextmanager
def mesh_context(mesh: Optional[Mesh | RankMesh]):
    """Make ``mesh`` the one the model runs over: a ``Mesh``'s devices for
    the sharded kernels, or a ``RankMesh``'s ranks for the partition."""
    token = _ACTIVE_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE_MESH.reset(token)
