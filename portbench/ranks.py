"""Cells of N > 1 chips: one process per card, each a rank of a default
process group (``nccl`` on cards, ``gloo`` on the CPU) that meets at a free
local port, and what the ranks agree on. Rank 0 decides when a window
closes and reports; every number the ranks read apart is gathered to it.

With no process group every helper is the one-process case: one rank, its
own flag, its own numbers.
"""

from __future__ import annotations

import datetime
import math
import os
import socket

import torch
import torch.distributed as dist


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(fn, n: int, device_type: str, args: tuple = (), prepare=None):
    """``fn(device, *args)`` on ``n`` ranks, each in a process of its own
    (rank r on card r), once the process has joined the group and limited
    its torch threads to its share of the host's cores; returns what rank
    0's call returned. ``prepare()``, where given, runs in each process
    first. A rank that fails ends the others and raises here; a collective
    that waits ten minutes fails."""
    import torch.multiprocessing as mp

    queue = mp.get_context("spawn").SimpleQueue()
    url = f"tcp://localhost:{free_port()}"
    procs = mp.spawn(_rank_main, args=(n, device_type, url, fn, args, prepare, queue),
                     nprocs=n, join=False)
    out = []
    while not procs.join(timeout=1):
        if not out and not queue.empty():     # read while rank 0 may still write
            out.append(queue.get())
    if not out and not queue.empty():
        out.append(queue.get())
    if not out:
        raise RuntimeError("rank 0 ended without a result")
    return out[0]


def _rank_main(r: int, n: int, device_type: str, url: str, fn, args, prepare, queue) -> None:
    if device_type == "cuda":
        torch.cuda.set_device(r)
        device = torch.device("cuda", r)
    else:
        device = torch.device("cpu")
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // n))
    if prepare is not None:
        prepare()
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo", init_method=url,
                            world_size=n, rank=r, timeout=datetime.timedelta(minutes=10))
    try:
        out = fn(device, *args)
        barrier(device)
        if r == 0:
            queue.put(out)
    finally:
        dist.destroy_process_group()


def barrier(device) -> None:
    """Every rank waits here for the slowest (a one-element all-reduce that
    the host reads)."""
    if world() > 1:
        flag = torch.zeros(1, device=device)
        dist.all_reduce(flag)
        flag.item()


def lead(flag: bool, device) -> bool:
    """Rank 0's ``flag`` on every rank: one broadcast."""
    if world() == 1:
        return flag
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    dist.broadcast(t, src=0)
    return bool(t.item())


def gather(obj) -> list:
    """Every rank's ``obj`` (picklable), in rank order."""
    if world() == 1:
        return [obj]
    out = [None] * world()
    dist.all_gather_object(out, obj)
    return out


def largest(rows: list[dict[str, float]]) -> dict[str, float]:
    """Per name, the largest over the ranks' numbers; a number that is not
    finite on any rank, or missing on one, is NaN (it fails its limit)."""
    names = dict.fromkeys(k for row in rows for k in row)
    out = {}
    for k in names:
        vals = [row.get(k, math.nan) for row in rows]
        out[k] = max(vals) if all(math.isfinite(v) for v in vals) else math.nan
    return out


@torch.no_grad()
def replica_gap(named: dict[str, torch.Tensor], device) -> float:
    """The largest relative L2 gap of any of this rank's tensors from rank
    0's: |x - x0| / |x0| (0 where both are zero), in fp32 over one flat
    buffer that rank 0 broadcasts; 0 with one rank."""
    if world() == 1 or not named:
        return 0.0
    flat = torch.cat([t.detach().reshape(-1).float().to(device) for t in named.values()])
    ref = flat.clone()
    dist.broadcast(ref, src=0)
    sizes = [t.numel() for t in named.values()]
    diff = torch.stack([torch.linalg.vector_norm(d) for d in torch.split(flat - ref, sizes)])
    norm = torch.stack([torch.linalg.vector_norm(d) for d in torch.split(ref, sizes)])
    gaps = torch.where(diff > 0, diff / norm.clamp_min(1e-30), torch.zeros_like(diff))
    return float(gaps.max())
