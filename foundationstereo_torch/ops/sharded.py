"""The multi-device path's sharded kernels, run over a ``parallel.mesh.Mesh``.

The port of the JAX package's ``shard_map``-wrapped Pallas kernels:

* ``cost_volume_parts_sharded`` -- ``ops/pallas_kernels.py:
  build_cost_volume_pallas_sharded`` (K5's build): each width shard builds
  its W/spatial columns of the parts with the haloed kernel, reading the
  full-width right features on its device (the counterpart of the JAX
  all-gather) from its global column offset on.
* ``shard_pyramids`` + ``disparity_lookup_sharded`` --
  ``disparity_lookup_pallas_sharded`` (K5's lookup): the lookup is
  width-local, so each shard holds its columns of every pyramid level (the
  correlation levels with their full right axis) and looks up with its
  global x offset, no halo. The pyramids are cut once per pair; per
  refinement iteration only the disparity's columns move.
* ``flash_attention_sharded`` -- ``models/dinov2.py:
  flash_vit_attention_sharded`` (K3s): batch on ``data``, heads on
  ``spatial``, the K3 kernel on each shard's heads, no collective. Under a
  ``RankMesh`` (one process per rank) the same split: a rank's ``data``
  index already holds its own batch rows, and where ``spatial`` > 1
  divides H each rank of a spatial group attends over its H/S heads, which
  ``parallel.spatial.gather_heads`` then gathers over the group; where it
  does not divide (or is 1) the rank attends over all heads with K3 and
  issues no collective (JAX's replicated axis).

Each returns on the caller's device what the single-device kernel returns,
bit for bit: every output element is the same arithmetic in the same order.
On CPU tensors the per-shard wrappers take their plain twins.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from foundationstereo_torch.ops import kernels
from foundationstereo_torch.parallel import spatial
from foundationstereo_torch.parallel.mesh import Mesh, RankMesh
from foundationstereo_torch.parallel.sharding import ShardPlan


def cost_volume_parts_sharded(left: torch.Tensor, right: torch.Tensor, right_proj: torch.Tensor,
                              maxdisp: int, num_groups: int, mesh: Mesh,
                              out_dtype: torch.dtype = torch.float32):
    """left/right (B, C, H, W), right_proj (B, P, H, W) -> gwc (B, G, D, H, W),
    rps (B, P, D, H, W) in ``out_dtype`` on left's device, as
    ``kernels.cost_volume_parts``; width sharded over ``spatial``."""
    plan = ShardPlan(mesh, left.shape[0], left.shape[-1], left.device)
    w_local = left.shape[-1] // plan.n_split

    def local(j, l, r, rp):
        return kernels.cost_volume_parts_haloed(l, r, rp, maxdisp, num_groups, j * w_local,
                                                out_dtype)

    return plan.run(local, plan.split(left, 3), plan.split(right), plan.split(right_proj),
                    out_dims=(4, 4))


@dataclass
class ShardedPyramids:
    """The lookup pyramids cut into width shards: ``geo[l][i][j]`` and
    ``corr[l][i][j]`` are level l of shard (i, j) on its device; a shard
    holds ``w_local`` left columns."""

    plan: ShardPlan
    w_local: int
    geo: list
    corr: list


def shard_pyramids(geo_pyramid: list[torch.Tensor], corr_pyramid: list[torch.Tensor],
                   mesh: Mesh) -> ShardedPyramids:
    """Cut geo levels (B, H, W, C, D_l) and corr levels (B, H, W, W_l) along
    W over ``spatial`` (batch on ``data``), each shard contiguous on its
    device."""
    b, _, w = geo_pyramid[0].shape[:3]
    plan = ShardPlan(mesh, b, w, geo_pyramid[0].device)
    return ShardedPyramids(plan, w // plan.n_split, [plan.split(g, 2) for g in geo_pyramid],
                           [plan.split(c, 2) for c in corr_pyramid])


def disparity_lookup_sharded(pyramids: ShardedPyramids, disp: torch.Tensor, radius: int,
                             out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """disp (B, H, W) -> (B, L*(C+1)*(2r+1), H, W) on disp's device, as
    ``kernels.disparity_lookup`` on the uncut pyramids."""
    plan, n = pyramids.plan, len(pyramids.geo)

    def local(j, d, *levels):
        return kernels.disparity_lookup_shard(list(levels[:n]), list(levels[n:]), d, radius,
                                              j * pyramids.w_local, out_dtype)

    return plan.run(local, plan.split(disp.contiguous(), 2), *pyramids.geo, *pyramids.corr,
                    out_dims=3)


def flash_attention_sharded(qkv: torch.Tensor, scale: float, mesh: Mesh | RankMesh | None,
                            attn_fn: Callable | None = None) -> torch.Tensor:
    """qkv (B, N, 3, H, Dh) -> (B, N, H, Dh) on qkv's device, as
    ``kernels.flash_attention``: batch on ``data`` and heads on ``spatial``
    where they divide. ``attn_fn(qkv, scale, h0, n_heads)`` attends over one
    shard's heads (``kernels.flash_attention_heads``, which reads them in
    place, when not given). Raises without a mesh, as the JAX package does."""
    if mesh is None:
        raise ValueError("vit_attention='flash_sharded' needs a mesh: run the model under "
                         "parallel.mesh_context(mesh)")
    if isinstance(mesh, RankMesh):
        return _attention_over_ranks(qkv, scale, mesh, attn_fn)
    attend = kernels.flash_attention_heads if attn_fn is None else attn_fn
    plan = ShardPlan(mesh, qkv.shape[0], qkv.shape[3], qkv.device)
    h_local = qkv.shape[3] // plan.n_split
    return plan.run(lambda j, q: attend(q, scale, j * h_local, h_local), plan.split(qkv),
                    out_dims=2)


def _attention_over_ranks(qkv, scale, mesh: RankMesh, attn_fn):
    """This rank's part of ``flash_attention_sharded`` under a ``RankMesh``:
    its H/S heads (K3s), gathered over its spatial group, where ``spatial``
    > 1 divides H; otherwise all heads (K3) and no collective."""
    heads, n = qkv.shape[3], mesh.shape["spatial"]
    if n == 1 or heads % n:
        if attn_fn is None:
            return kernels.flash_attention(qkv, scale)
        return attn_fn(qkv, scale, 0, heads)
    attend = kernels.flash_attention_heads if attn_fn is None else attn_fn
    h = heads // n
    return spatial.gather_heads(attend(qkv, scale, mesh.spatial_index * h, h), mesh)
