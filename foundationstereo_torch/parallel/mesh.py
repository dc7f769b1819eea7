"""Device mesh: the port of the JAX package's ``parallel/mesh.py``.

A ``Mesh`` is a grid of ``torch.device``s with named axes, as one process
sees it (the JAX package's single-controller mesh):

* ``data``    -- batch parallelism;
* ``spatial`` -- image-width sharding of the cost volume and its lookup,
  and head sharding of the ViT attention.

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

_ACTIVE_MESH: contextvars.ContextVar[Optional["Mesh"]] = contextvars.ContextVar(
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


def make_mesh(n_devices: int | None = None,
              axis_names: Sequence[str] = ("data", "spatial"),
              shape: Sequence[int] | None = None,
              devices=None) -> Mesh:
    """A mesh over the first ``n_devices`` of ``devices`` (every CUDA device
    when not given; raises without one).

    If ``shape`` is not given, the device count is factored as the JAX
    package factors it: ``spatial`` gets the largest power of two <= 4 that
    divides it and ``data`` the rest.
    """
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
            spatial = 1
            while spatial < 4 and n % (spatial * 2) == 0:
                spatial *= 2
            shape = (n // spatial, spatial) + (1,) * (len(axis_names) - 2)
    if math.prod(shape) != n:
        raise ValueError(f"shape {tuple(shape)} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(tuple(shape)), axis_names)


def current_mesh() -> Optional[Mesh]:
    return _ACTIVE_MESH.get()


@contextlib.contextmanager
def mesh_context(mesh: Optional[Mesh]):
    """Make ``mesh`` the one the model's sharded kernels run over."""
    token = _ACTIVE_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE_MESH.reset(token)
