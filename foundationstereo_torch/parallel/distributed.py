"""Process groups and the global batch: the port of the JAX package's
``parallel/distributed.py``.

Data-parallel training runs one process per rank over ``torch.distributed``
(the JAX package runs one controller per host over a global mesh):

    from foundationstereo_torch.parallel import distributed
    distributed.initialize("tcp://localhost:29500", num_processes=2, process_id=rank,
                           backend="nccl")

Nothing on a machine tells a process of its peers, so the address, world
size and rank are passed in, or read from ``MASTER_ADDR``/``MASTER_PORT``,
``WORLD_SIZE`` and ``RANK`` where a launcher set them. The collectives here
are ``all_reduce`` and ``broadcast`` only, which both ``gloo`` and ``nccl``
support on CUDA tensors (``gloo`` also on the CPU).

The global batch is the JAX multi-host one: each rank holds its local batch,
and the global batch is the concatenation of the ranks' local batches in
rank order (``jax.make_array_from_process_local_data``). Nothing is
gathered; the step computes on the local slice and reduces what the one-step
semantics need (``models.layers.global_batch``: batch statistics and dropout
masks; ``train.trainer``: gradients and metrics).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from foundationstereo_torch.parallel.sharding import place_batch


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str = "nccl") -> None:
    """Join the default process group (a no-op if this process already has
    one). ``coordinator_address`` is ``host:port`` or an init URL
    (``tcp://...``, ``file://...``); each argument left None is read from the
    launcher's environment (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``), and one that is in neither raises."""
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize needs the coordinator's address, the number of processes "
                         "and this process's rank (arguments, or MASTER_ADDR/MASTER_PORT, "
                         "WORLD_SIZE and RANK)")
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes, rank=process_id)


def rank() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The default group's size (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier(device) -> None:
    """Wait until every rank reaches this point: an all-reduce of a tensor on
    ``device`` (the rank's card under ``nccl``) that the host reads."""
    if world_size() > 1:
        flag = torch.zeros(1, device=device)
        dist.all_reduce(flag)
        flag.item()


def local_slice(global_batch: dict, mesh=None) -> dict:
    """This rank's part of a global batch that every rank holds whole: the
    rows [i * b, (i + 1) * b) of each batched entry, b = B / n, with n ranks
    and this one the i-th (``rng`` is not batched and stays whole). Under a
    ``RankMesh`` n and i are its ``data`` axis's: the ranks that share a
    data index take the same rows."""
    n, r = (world_size(), rank()) if mesh is None else (mesh.shape["data"], mesh.data_index)
    out = {}
    for k, v in global_batch.items():
        if k == "rng":
            out[k] = v
            continue
        if v.shape[0] % n:
            raise ValueError(f"{k}: a global batch of {v.shape[0]} does not split over {n} ranks")
        b = v.shape[0] // n
        out[k] = v[r * b:(r + 1) * b]
    return out


# The entries a shared batch has (``train.cli.host_batch``'s) and the
# element types they may have, by their code in ``share_batch``'s header.
_BATCH_KEYS = ("left", "right", "disparity", "mask", "label_idx")
_DTYPES = (torch.float32, torch.bool, torch.int64)


def share_batch(batch: dict | None, mesh, device) -> dict:
    """The batch of the first rank of this rank's ``spatial`` group (the
    others pass None) on every rank of the group, on ``device``: one
    broadcast of the entries' element types and shapes (at most 4 axes),
    then one per entry of ``_BATCH_KEYS`` (``rng`` is not shared: the caller
    sets it alike on every rank)."""
    group, src = mesh.spatial_group, mesh.data_index * mesh.shape["spatial"]
    lead = mesh.spatial_index == 0
    header = torch.zeros(6 * len(_BATCH_KEYS), dtype=torch.int64, device=device)
    out = {}
    if lead:
        if set(batch) - {"rng"} != set(_BATCH_KEYS):
            raise ValueError(f"a shared batch has the entries {_BATCH_KEYS}, not {sorted(batch)}")
        out = place_batch({k: batch[k] for k in _BATCH_KEYS}, device)
        header.copy_(torch.tensor([x for k in _BATCH_KEYS for x in (
            [_DTYPES.index(out[k].dtype), out[k].ndim, *out[k].shape] + [0] * (4 - out[k].ndim))]))
    dist.broadcast(header, src=src, group=group)
    spec = header.tolist()
    for i, k in enumerate(_BATCH_KEYS):
        code, ndim, *shape = spec[6 * i:6 * i + 6]
        dtype = _DTYPES[code]
        t = out[k] if lead else torch.empty(shape[:ndim], dtype=dtype, device=device)
        wire = t.to(torch.uint8) if dtype == torch.bool else t
        dist.broadcast(wire, src=src, group=group)
        out[k] = wire.to(torch.bool) if dtype == torch.bool else wire
    return out


def host_local_batch_to_global(batch: dict | None, device, mesh=None) -> dict:
    """This rank's local batch as its part of the global batch, placed on
    ``device`` (``sharding.place_batch``); under a ``RankMesh`` whose
    ``spatial`` axis is > 1 the group's first rank's batch, shared
    (``share_batch``; the others pass None). Every rank must hold the same
    number of samples (the global batch statistics and dropout masks cut the
    global batch into equal slices): checked with one all-reduce."""
    if mesh is not None and mesh.shape["spatial"] > 1:
        out = share_batch(batch, mesh, device)
    else:
        out = place_batch(batch, device)
    n = world_size()
    if n > 1:
        size = next(v.shape[0] for k, v in out.items() if k != "rng")
        sizes = torch.tensor([size, -size], dtype=torch.int64, device=device)
        dist.all_reduce(sizes, op=dist.ReduceOp.MAX)
        hi, lo = int(sizes[0]), -int(sizes[1])
        if hi != lo:
            raise ValueError(f"ranks hold local batches of {lo} to {hi} samples; "
                             "the global batch needs the same number on every rank")
    return out


class _AllReduceSum(torch.autograd.Function):
    """The sum over ``group``'s ranks; its backward sums the ranks' output
    gradients the same way (each rank's input feeds every rank's output)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """A differentiable all-reduce (sum) of ``x`` over ``group``."""
    return _AllReduceSum.apply(x, group)


def all_reduce_mean(tensors: list[torch.Tensor], divisor: int | None = None) -> None:
    """Each tensor replaced, in place, by its sum over the ranks divided by
    ``divisor`` (the number of ranks when None: the mean): one all-reduce of
    one flat fp32 buffer."""
    n = world_size()
    if n == 1 or not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat)
    flat.div_(n if divisor is None else divisor)
    offset = 0
    with torch.no_grad():
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def checksums(tensors: list[torch.Tensor]) -> torch.Tensor:
    """One int64 per tensor: the sum of its elements' bit patterns (as
    integers of the element's width). Equal bits give equal sums."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    sums = [t.detach().contiguous().view(-1).view(ints[t.element_size()]).to(torch.int64).sum()
            for t in tensors]
    return torch.stack(sums) if sums else torch.zeros(0, dtype=torch.int64)


def check_replicas(named: dict[str, torch.Tensor]) -> None:
    """Raise on every rank unless every tensor is bit for bit rank 0's:
    rank 0's checksums are broadcast, and the count of ranks that differ
    all-reduced."""
    n = world_size()
    if n == 1:
        return
    names = list(named)
    mine = checksums([named[k] for k in names])
    ref = mine.clone()
    dist.broadcast(ref, src=0)
    differs = (mine != ref)
    bad = torch.stack([differs.any().to(torch.int64)])
    dist.all_reduce(bad)
    if int(bad[0]):
        first = [names[i] for i in differs.nonzero().flatten().tolist()[:5]]
        raise RuntimeError(f"{int(bad[0])} of {n} ranks hold parameters that differ from rank "
                           f"0's (this rank: {first or 'none'})")
