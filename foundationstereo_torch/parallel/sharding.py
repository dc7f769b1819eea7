"""The port's ``shard_map``: one function run per shard of a device mesh.

The JAX package's sharded kernels (``ops/pallas_kernels.py:
build_cost_volume_pallas_sharded``, ``disparity_lookup_pallas_sharded``,
``models/dinov2.py:flash_vit_attention_sharded``) wrap a per-device function
in ``jax.shard_map``. Here one process does the same over a
``parallel.mesh.Mesh`` of ``torch.device``s: a ``ShardPlan`` fixes the
shards of one call, ``split`` cuts an input into its shards on their
devices, and ``run`` calls the per-shard function under each shard device's
guard and concatenates the outputs on the home device (where the caller's
tensors live).

Which axes shard is the JAX package's rule (``pallas_kernels.py:342-344``,
``:562-564``; ``dinov2.py:124-128``): the batch goes on ``data`` only when
``data > 1`` and it divides B, the split axis on ``spatial`` only when
``spatial > 1`` and it divides that axis; otherwise the axis stays
replicated. A replicated axis is computed once, on the mesh's first entry
along it, where JAX computes the same values on every device.

The training placements (``sharding.py:26-33,64-71`` there) are one
process per rank here (``parallel/distributed.py``): ``place_batch`` moves a
rank's local batch to its card, the counterpart of placing the global batch
on the ``data`` axis, and ``replicate`` broadcasts rank 0's parameters,
buffers and EMA copies, the counterpart of the replicated state.

The JAX module's ``shard_batch`` and ``shard_spatial`` (hints with which
GSPMD partitions the filter stack and the GRU convs along width, with halo
exchanges) are one process per rank too: ``parallel/spatial.py`` under a
``RankMesh`` (``parallel/mesh.py``). The batch goes on ``data``
(``distributed.local_slice``), and from the cost volume on each rank of
``spatial`` holds its columns, at the points where the JAX forward places
``shard_spatial`` (``models/foundation_stereo.py``). The device ``Mesh``
and ``ShardPlan`` here stay the single-process path of the sharded kernels.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from foundationstereo_torch.parallel.mesh import Mesh


def device_guard(device: torch.device):
    """``torch.cuda.device(device)`` for a CUDA device, nothing for the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def place_batch(batch: dict, device) -> dict:
    """A host batch (numpy arrays or CPU tensors) as tensors on ``device``,
    pinned and copied without blocking on a card; ``rng`` stays on the host."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        if k == "rng":
            out[k] = v
            continue
        t = torch.as_tensor(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


@torch.no_grad()
def replicate(state, src: int = 0) -> None:
    """Every tensor of ``state`` (a module's parameters and buffers, or a
    dict or list of tensors such as the EMA copies) overwritten in place
    with rank ``src``'s, one broadcast per tensor. Without a process group,
    nothing to do."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    if isinstance(state, torch.nn.Module):
        tensors = [*state.parameters(), *state.buffers()]
    else:
        tensors = list(state.values()) if isinstance(state, dict) else list(state)
    for t in tensors:
        dist.broadcast(t.data, src=src)


def _gather(parts: list[torch.Tensor], dim: int, home: torch.device) -> torch.Tensor:
    if len(parts) == 1:
        return parts[0].to(home)
    return torch.cat([p.to(home) for p in parts], dim=dim)


class ShardPlan:
    """The shards of one sharded call on ``mesh``: ``n_batch`` along the
    batch (on ``data``) by ``n_split`` along one axis of length ``split``
    (on ``spatial``), with ``devices[i][j]`` the device of shard (i, j), and
    ``home`` the device the outputs are gathered on."""

    def __init__(self, mesh: Mesh, batch: int, split: int, home: torch.device):
        nd = mesh.shape.get("data", 1)
        ns = mesh.shape.get("spatial", 1)
        self.n_batch = nd if nd > 1 and batch % nd == 0 else 1
        self.n_split = ns if ns > 1 and split % ns == 0 else 1
        self.devices = [[mesh.device(data=i, spatial=j) for j in range(self.n_split)]
                        for i in range(self.n_batch)]
        self.home = torch.device(home)

    def split(self, x: torch.Tensor, dim: int | None = None) -> list[list[torch.Tensor]]:
        """``x`` cut into its shards, each contiguous on its shard's device:
        ``n_batch`` chunks along axis 0 and, when ``dim`` is given, ``n_split``
        along ``dim``. With ``dim`` None every shard gets its batch chunk whole
        (the counterpart of JAX's all-gather along the split axis; on the home
        device that is no copy)."""
        nb = x.shape[0] // self.n_batch
        ns = 0 if dim is None else x.shape[dim] // self.n_split
        out = []
        for i in range(self.n_batch):
            xb = x.narrow(0, i * nb, nb)
            out.append([(xb if dim is None else xb.narrow(dim, j * ns, ns)).to(dev).contiguous()
                        for j, dev in enumerate(self.devices[i])])
        return out

    def run(self, fn: Callable, *shards: list[list[torch.Tensor]], out_dims: int | tuple):
        """``fn(j, *blocks)`` for every shard, ``j`` its index along the split
        axis and ``blocks`` its entry of each of ``shards``, under its device's
        guard. The outputs (one tensor, or a tuple when ``out_dims`` is one)
        are concatenated on the home device along ``out_dims`` over the split
        axis and along axis 0 over the batch."""
        single = isinstance(out_dims, int)
        dims = (out_dims,) if single else tuple(out_dims)
        rows = []
        for i, devs in enumerate(self.devices):
            outs = []
            for j, dev in enumerate(devs):
                with device_guard(dev):
                    out = fn(j, *(s[i][j] for s in shards))
                outs.append((out,) if single else tuple(out))
            rows.append([_gather([o[k] for o in outs], d, self.home) for k, d in enumerate(dims)])
        gathered = tuple(_gather([r[k] for r in rows], 0, self.home) for k in range(len(dims)))
        return gathered[0] if single else gathered
