"""Width partitioning over the ranks of a spatial mesh: the port of the JAX
package's ``shard_spatial`` / ``shard_batch`` (``parallel/sharding.py``).

Under a ``RankMesh`` whose ``spatial`` axis is > 1, JAX's hints put the
cost volume on ``spatial`` along image width, and GSPMD partitions every op
from there on and inserts halo exchanges. Here every rank runs the same
model code on its own columns (SPMD over ``torch.distributed``), and the
few primitives that read along W exchange halos with their neighbours:

* ``Partition`` fixes one forward's columns. Units are 1/32 columns: the
  W/32 units split as evenly as ``floor`` makes them, rank k taking units
  [k U / S, (k + 1) U / S), so every level (full, 1/2 ... 1/32) has whole
  columns per rank. Shards may be uneven; W/32 < S raises.
* ``region(part)`` marks the partitioned region of the forward. Inside it,
  ``conv`` and ``conv_transpose`` (every convolution of ``models/layers.py``),
  ``avg_pool2x`` and ``context_upsample`` (``ops/upsample.py``) and the W
  axis of ``resize2d``/``resize_dhw`` (``ops/resize.py``, through the global
  interpolation matrix) run on the rank's columns with a halo; batch norm
  in training reduces its sums over all the mesh's ranks and dropout draws
  the global mask (``models/layers.py``). A W-coupled op with no partitioned
  form raises there (``refuse``).
* ``halo`` is the exchange: an autograd function whose forward receives k
  columns from each neighbour (zeros at the global edges) and whose
  backward hands the halo's gradient back, to be added to the neighbour's
  edge columns. ``gather`` all-gathers along W; its backward hands each
  rank its own columns' gradient, unscaled (every rank computes the same
  loss on the gathered tensor).
* ``gather_heads`` is the ViT attention's gather, outside the partitioned
  region: each rank of a spatial group attends over its H/S heads
  (``ops/sharded.py:flash_attention_sharded``, the JAX package's
  ``flash_vit_attention_sharded`` under its mesh) and every rank gets all H.
  It sits in the replicated region, where each rank holds a partial
  cotangent (its columns' part; the trainer sums gradients over
  ``spatial``), so its backward sums the cotangent over the group before it
  hands the rank its own heads' part. The ViT is frozen and runs under
  ``no_grad``, so the backward is not on the training path.

The collectives are ``all_reduce`` only (a rank's strips, its columns or
its heads, written into a zero buffer and summed), which ``gloo`` supports
on CUDA tensors as well as on the CPU, and ``nccl`` on cards: ranks that
share a card run over ``gloo``. The partition's buffers are fp32, so bf16
values cross exactly; the heads gather's are in the tensor's own dtype (a
sum of one value and zeros is exact in any dtype), its backward's fp32.
A collective that fails raises on its rank, and the run fails with it.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from foundationstereo_torch.parallel.mesh import RankMesh
from foundationstereo_torch.utils.trace import Recorder, recording, span

# Collectives since the last ``reset_exchanges()``: the partition's halo
# exchanges (forward and backward) and gathers and the bytes each rank put
# into their buffers; the ViT attention's heads gathers (forward and
# backward) and the bytes of theirs.
EXCHANGES = {"halo": 0, "halo_backward": 0, "gather": 0, "bytes": 0,
             "heads": 0, "heads_backward": 0, "heads_bytes": 0}
# The partition of the enclosing ``region`` block (a list: the backward
# runs on the autograd engine's thread).
_REGION: list = [None]


def reset_exchanges() -> None:
    for k in EXCHANGES:
        EXCHANGES[k] = 0


class Partition:
    """One forward's columns on a ``RankMesh`` whose ``spatial`` axis is
    > 1, for an image of ``width`` full-resolution columns."""

    def __init__(self, mesh: RankMesh, width: int):
        n = mesh.shape["spatial"]
        if width % 32:
            raise ValueError(f"W = {width} is not a multiple of 32")
        units = width // 32
        if units < n:
            raise ValueError(f"W/32 = {units} columns of 1/32 cannot split over spatial = {n} "
                             "ranks: each rank needs at least one")
        self.mesh, self.n, self.index, self.units = mesh, n, mesh.spatial_index, units
        self.bounds = [k * units // n for k in range(n + 1)]

    def _per_unit(self, w_global: int) -> int:
        if w_global % self.units:
            raise ValueError(f"{w_global} columns are no level of a {32 * self.units}-wide image")
        return w_global // self.units

    def columns(self, w_global: int, k: int | None = None) -> tuple[int, int]:
        """[c0, c1): rank k's columns (this rank's when k is None) at the
        level of ``w_global`` columns."""
        c = self._per_unit(w_global)
        k = self.index if k is None else k
        return c * self.bounds[k], c * self.bounds[k + 1]

    def widths(self, w_global: int) -> list[int]:
        c = self._per_unit(w_global)
        return [c * (b1 - b0) for b0, b1 in zip(self.bounds, self.bounds[1:])]

    def global_width(self, w_local: int) -> int:
        """The level's full width, from this rank's width at that level."""
        own = self.bounds[self.index + 1] - self.bounds[self.index]
        if w_local % own:
            raise ValueError(f"{w_local} columns are no level of this rank's {own} units")
        return w_local // own * self.units

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's columns of a replicated tensor (W last)."""
        c0, c1 = self.columns(x.shape[-1])
        return x[..., c0:c1]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole width on every rank from each rank's columns (W last)."""
        return _Gather.apply(x, self)

    def halo(self, x: torch.Tensor, left: int, right: int) -> torch.Tensor:
        """x with ``left`` columns of the left neighbour before it and
        ``right`` of the right one after it (zeros past the image's edges);
        a negative count drops that many of x's own columns instead."""
        if left < 0:
            x, left = x[..., -left:], 0
        if right < 0:
            x, right = x[..., :x.shape[-1] + right], 0
        if not (left or right):
            return x
        widths = self.widths(self.global_width(x.shape[-1]))
        if max(left, right) > min(widths):
            raise ValueError(f"a halo of {max(left, right)} columns is wider than a neighbour's "
                             f"shard (widths {widths} at this level)")
        return _Halo.apply(x, left, right, self)

    def _swap(self, to_left: torch.Tensor, to_right: torch.Tensor):
        """Each rank sends ``to_left`` to its left neighbour and ``to_right``
        to its right one: one all-reduce over the spatial group. Returns
        (from_left, from_right), zeros where there is no neighbour."""
        na, nb = to_left.numel(), to_right.numel()
        buf = torch.zeros((self.n, na + nb), dtype=torch.float32, device=to_left.device)
        buf[self.index, :na] = to_left.reshape(-1)
        buf[self.index, na:] = to_right.reshape(-1)
        _all_reduce(buf, self.mesh.spatial_group)
        EXCHANGES["bytes"] += buf.numel() * 4
        k = self.index
        from_left = (buf[k - 1, na:] if k > 0 else buf.new_zeros(nb)).view(to_right.shape)
        from_right = (buf[k + 1, :na] if k + 1 < self.n else buf.new_zeros(na)).view(to_left.shape)
        return from_left.to(to_right.dtype), from_right.to(to_left.dtype)


def _all_reduce(buf: torch.Tensor, group, kind: str = "partition") -> None:
    """Sum ``buf`` over ``group`` in place, in a span ``exchange.<kind>``."""
    with span(f"exchange.{kind}"):
        dist.all_reduce(buf, group=group)


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, left, right, part):
        ctx.left, ctx.right, ctx.part = left, right, part
        w = x.shape[-1]
        EXCHANGES["halo"] += 1
        from_left, from_right = part._swap(x[..., :right], x[..., w - left:])
        return torch.cat([from_left, x, from_right], dim=-1)

    @staticmethod
    def backward(ctx, g):
        left, right, part = ctx.left, ctx.right, ctx.part
        w = g.shape[-1] - left - right
        EXCHANGES["halo_backward"] += 1
        # The halos' gradients go back to the neighbours whose columns they were.
        from_left, from_right = part._swap(g[..., :left], g[..., left + w:])
        gx = g[..., left:left + w].clone()
        gx[..., :right] += from_left
        gx[..., w - left:] += from_right
        return gx, None, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, part):
        w = part.global_width(x.shape[-1])
        c0, c1 = part.columns(w)
        ctx.cols = (c0, c1)
        buf = torch.zeros(x.shape[:-1] + (w,), dtype=torch.float32, device=x.device)
        buf[..., c0:c1] = x
        _all_reduce(buf, part.mesh.spatial_group)
        EXCHANGES["gather"] += 1
        EXCHANGES["bytes"] += buf.numel() * 4
        return buf.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        c0, c1 = ctx.cols
        return g[..., c0:c1].contiguous(), None


class _GatherHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        n, k = mesh.shape["spatial"], mesh.spatial_index
        b, t, h, d = x.shape
        ctx.heads, ctx.group = (k * h, (k + 1) * h), mesh.spatial_group
        buf = x.new_zeros((n * b, t, h, d))             # the ranks' x, one after another
        buf[k * b:(k + 1) * b] = x
        _all_reduce(buf, ctx.group, "heads")
        EXCHANGES["heads"] += 1
        EXCHANGES["heads_bytes"] += buf.numel() * buf.element_size()
        return buf.view(n, b, t, h, d).permute(1, 2, 0, 3, 4).reshape(b, t, n * h, d)

    @staticmethod
    def backward(ctx, g):
        h0, h1 = ctx.heads
        buf = g.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
        _all_reduce(buf, ctx.group, "heads")
        EXCHANGES["heads_backward"] += 1
        EXCHANGES["heads_bytes"] += buf.numel() * 4
        return buf[:, :, h0:h1].to(g.dtype), None


def gather_heads(x: torch.Tensor, mesh: RankMesh) -> torch.Tensor:
    """x (B, N, H/S, Dh), the heads [s H/S, (s + 1) H/S) of spatial rank s
    -> (B, N, H, Dh) on every rank of the spatial group, bit for bit what
    each owner computed. Issued outside the partitioned region, by every
    rank of the group at the same point."""
    return _GatherHeads.apply(x, mesh)


def partition(mesh, width: int) -> Partition | None:
    """The partition of a forward on ``width``-column images under ``mesh``:
    None unless it is a ``RankMesh`` whose ``spatial`` axis is > 1."""
    if isinstance(mesh, RankMesh) and mesh.shape["spatial"] > 1:
        return Partition(mesh, width)
    return None


def active() -> Partition | None:
    """The partition of the enclosing ``region`` block (None outside one)."""
    return _REGION[0]


@contextlib.contextmanager
def region(part: Partition | None):
    """Inside the block, the W-coupled primitives run on ``part``'s columns
    (nothing changes with None)."""
    prev, _REGION[0] = _REGION[0], part
    try:
        yield part
    finally:
        _REGION[0] = prev


def timed():
    """Inside the block every span is recorded, each collective of this
    module as ``exchange.<kind>`` ("partition" or "heads"): the recorder of
    ``utils.trace.recording``, which ``exchange_ms`` reads."""
    return recording()


def exchange_ms(recorder: Recorder, kind: str = "partition") -> float:
    """Milliseconds of the collectives of one ``kind`` ("partition" or
    "heads") a ``timed`` block recorded: on the card's clock, or the host's
    without a card."""
    return recorder.ms(f"exchange.{kind}")


def refuse(what: str) -> None:
    """Raise inside a partitioned region: ``what`` reads along W and has no
    partitioned form."""
    if _REGION[0] is not None:
        raise NotImplementedError(f"{what} reads along the image width and has no partitioned "
                                  "form: it cannot run inside the spatial partition")


# ---------------------------------------------------------------------------
# The W-coupled primitives
# ---------------------------------------------------------------------------


def _aligned(part: Partition, w: int, s: int) -> None:
    """A stride-s op maps this level's shards onto the next level's only
    where every shard border is a multiple of s."""
    wg = part.global_width(w)
    if any(c % s for k in range(part.n) for c in part.columns(wg, k)):
        raise ValueError(f"stride {s} at a level of {wg} columns: shard borders "
                         f"{[part.columns(wg, k) for k in range(part.n)]} are not multiples of {s}")


def conv(fn, x, weight, bias, stride, padding, dilation, groups):
    """``fn`` (``F.conv2d`` or ``F.conv3d``) of x; in a partitioned region
    on the rank's columns: output column j reads the input columns [s j -
    p, s j - p + k), so the shard takes p columns from its left neighbour
    and k - s - p from its right one (zeros past the edges: the conv's zero
    padding), and runs with no padding along W. A conv 1 wide along W
    exchanges nothing."""
    part = _REGION[0]
    if part is None:
        return fn(x, weight, bias, stride, padding, dilation, groups)
    k, s, p = weight.shape[-1], stride[-1], padding[-1]
    if dilation[-1] != 1 or isinstance(padding, str):
        raise NotImplementedError("a dilated or string-padded conv inside the spatial partition")
    _aligned(part, x.shape[-1], s)
    x = part.halo(x, p, k - s - p)
    return fn(x, weight, bias, stride, tuple(padding[:-1]) + (0,), dilation, groups)


def conv_transpose(fn, x, weight, bias, stride, padding):
    """``fn`` (``F.conv_transpose2d`` or ``3d``) of x, whose output is s
    times as wide; in a partitioned region on the rank's columns: input
    column i feeds the outputs [s i - p, s i - p + k), so the shard takes
    (k - 1 - p) // s columns from the left and (p - 1) // s + 1 from the
    right, runs with no padding along W and keeps its own s w columns."""
    part = _REGION[0]
    if part is None:
        return fn(x, weight, bias, stride, padding)
    k, s, p = weight.shape[-1], stride[-1], padding[-1]
    if k - s - 2 * p:
        raise NotImplementedError(f"a transposed conv (k {k}, s {s}, p {p}) whose output is not "
                                  "s times its input inside the spatial partition")
    w = x.shape[-1]
    left, right = (k - 1 - p) // s, (p - 1) // s + 1
    y = fn(part.halo(x, left, right), weight, bias, stride, tuple(padding[:-1]) + (0,))
    q0 = s * left + p
    return y[..., q0:q0 + s * w]


def avg_pool2x(x: torch.Tensor) -> torch.Tensor:
    """``F.avg_pool2d(x, 3, 2, 1, count_include_pad=True)``; in a
    partitioned region as a 3-wide stride-2 conv (one column from the
    left)."""
    part = _REGION[0]
    if part is None:
        return F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=True)
    _aligned(part, x.shape[-1], 2)
    return F.avg_pool2d(part.halo(x, 1, 0), 3, stride=2, padding=(1, 0), count_include_pad=True)


def unfold3(x: torch.Tensor) -> torch.Tensor:
    """``F.unfold(x, 3, padding=1)`` of (B, C, H, W); in a partitioned
    region over one halo column on each side."""
    part = _REGION[0]
    if part is None:
        return F.unfold(x, 3, padding=1)
    return F.unfold(part.halo(x, 1, 1), 3, padding=(1, 0))


@functools.lru_cache(maxsize=64)
def resize_block(matrix, g_in: int, g_out: int, method: str, align_corners: bool,
                 bounds: tuple, index: int):
    """For an interpolation along W from ``g_in`` to ``g_out`` columns whose
    global (out, in) matrix is ``matrix(g_in, g_out, method, align_corners)``:
    the rows rank ``index`` computes (of the partition with unit
    ``bounds``), over its input columns and the halo (left, right) that the
    widest rank needs; returns (block, left, right)."""
    m = matrix(g_in, g_out, method, align_corners)
    units = bounds[-1]

    def cols(g, k):
        c = g // units
        return c * bounds[k], c * bounds[k + 1]

    left = right = 0
    for k in range(len(bounds) - 1):
        (o0, o1), (i0, i1) = cols(g_out, k), cols(g_in, k)
        used = np.nonzero(np.any(m[o0:o1] != 0, axis=0))[0]
        if used.size:
            left, right = max(left, i0 - int(used[0])), max(right, int(used[-1]) + 1 - i1)
    (o0, o1), (i0, i1) = cols(g_out, index), cols(g_in, index)
    block = np.zeros((o1 - o0, i1 - i0 + left + right), np.float32)
    lo, hi = max(i0 - left, 0), min(i1 + right, g_in)
    block[:, lo - (i0 - left):hi - (i0 - left)] = m[o0:o1, lo:hi]
    return block, left, right
