"""The port's multi-device path against the JAX package's, on the CPU.

JAX runs on the 8 virtual CPU devices ``tests/conftest.py`` gives it, its
sharded Pallas kernels in interpret mode (the TPU flash kernel has no CPU
path, so its sharded wrapper gets the chunked attention, as the JAX
package's own test does). The port runs on meshes of CPU devices, where the
per-shard wrappers take their plain twins. Meshes: data 1 x spatial 2 and
data 2 x spatial 4 (B = 2). Tolerance 1e-5: both compute in fp32 and differ
in summation order only.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from foundationstereo_torch.ops import kernels, sharded
from foundationstereo_torch.parallel import current_mesh, make_mesh, mesh_context
from foundationstereo_torch.parallel.sharding import ShardPlan
from foundationstereo_tpu.models.dinov2 import chunked_attention, flash_vit_attention_sharded
from foundationstereo_tpu.ops import pallas_kernels as jpk
from foundationstereo_tpu.ops.sampler import pool_last_axis
from foundationstereo_tpu.parallel.mesh import make_mesh as jax_make_mesh

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")
MESHES = [pytest.param(2, 1, id="data1xspatial2"), pytest.param(8, 2, id="data2xspatial4")]


def _meshes(n):
    return make_mesh(devices=[CPU] * n), jax_make_mesh(n)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def test_make_mesh_shapes():
    """The JAX package's factoring (tests/test_sharding.py::test_make_mesh_shapes)."""
    for n, want in ((8, {"data": 2, "spatial": 4}), (4, {"data": 1, "spatial": 4}),
                    (2, {"data": 1, "spatial": 2}), (1, {"data": 1, "spatial": 1}),
                    (6, {"data": 3, "spatial": 2})):
        mesh = make_mesh(devices=[CPU] * n)
        assert mesh.shape == want == dict(jax_make_mesh(n).shape)
        assert mesh.size == n and mesh.devices.shape == tuple(want.values())
    mesh = make_mesh(3, devices=[CPU] * 8)
    assert mesh.shape == {"data": 3, "spatial": 1}
    assert make_mesh(devices=[CPU] * 4, axis_names=("spatial",)).shape == {"spatial": 4}
    assert make_mesh(devices=[CPU] * 8, shape=(4, 2)).shape == {"data": 4, "spatial": 2}
    with pytest.raises(ValueError, match="shape"):
        make_mesh(devices=[CPU] * 8, shape=(3, 2))


def test_make_mesh_needs_cuda_unless_given_devices():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_mesh_context_nests_and_restores():
    a, b = make_mesh(devices=[CPU] * 2), make_mesh(devices=[CPU] * 4)
    assert current_mesh() is None
    with mesh_context(a):
        with mesh_context(b):
            assert current_mesh() is b
        assert current_mesh() is a
    assert current_mesh() is None


@pytest.mark.parametrize("n, batch", MESHES)
def test_shard_plan_follows_the_jax_rule(n, batch):
    """Batch on data only where data > 1 divides B, the split axis only where
    spatial divides it; a replicated axis is computed once, on the first
    entry along it."""
    mesh = make_mesh(devices=[CPU] * n)
    nd, ns = mesh.shape["data"], mesh.shape["spatial"]
    plan = ShardPlan(mesh, batch, 4 * ns, CPU)
    assert (plan.n_batch, plan.n_split) == (nd if nd > 1 and batch % nd == 0 else 1, ns)
    assert np.shape(plan.devices) == (plan.n_batch, ns)
    assert (ShardPlan(mesh, 3, 4 * ns + 1, CPU).n_batch,
            ShardPlan(mesh, 3, 4 * ns + 1, CPU).n_split) == (1, 1)
    x = torch.arange(batch * 2 * 4 * ns).reshape(batch, 2, 4 * ns)
    shards = plan.split(x, 2)
    assert all(s.is_contiguous() and s.shape == (batch // plan.n_batch, 2, 4)
               for row in shards for s in row)
    assert torch.equal(plan.run(lambda j, s: s, shards, out_dims=2), x)


@pytest.mark.parametrize("d", [6, 16])          # 16 > 32 / 4: the halo crosses several shards
@pytest.mark.parametrize("n, batch", MESHES)
def test_sharded_build_matches_jax(rng, n, batch, d):
    b, h, w, c, p, g = batch, 3, 32, 16, 4, 4
    l, r = (rng.standard_normal((b, h, w, c)).astype(np.float32) for _ in range(2))
    lp, rp = (rng.standard_normal((b, h, w, p)).astype(np.float32) for _ in range(2))
    mesh, jmesh = _meshes(n)
    want = np.asarray(jpk.build_cost_volume_pallas_sharded(
        jnp.asarray(l), jnp.asarray(r), jnp.asarray(lp), jnp.asarray(rp), d, g, mesh=jmesh,
        interpret=True))                                        # (B, D, H, W, G + 2P)
    gwc, rps = sharded.cost_volume_parts_sharded(_nchw(l), _nchw(r), _nchw(rp), d, g, mesh)
    np.testing.assert_allclose(gwc.permute(0, 2, 3, 4, 1).numpy(), want[..., :g], **TOL)
    np.testing.assert_array_equal(rps.permute(0, 2, 3, 4, 1).numpy(), want[..., g + p:])
    whole = kernels.cost_volume_parts(_nchw(l), _nchw(r), _nchw(rp), d, g)
    assert torch.equal(gwc, whole[0]) and torch.equal(rps, whole[1])


@pytest.mark.parametrize("n, batch", MESHES)
def test_sharded_lookup_matches_jax(rng, n, batch):
    b, h, w, c, d, levels, radius = batch, 4, 64, 6, 16, 3, 3
    geo = jnp.asarray(rng.standard_normal((b, h, w, c, d)).astype(np.float32))
    corr = jnp.asarray(rng.standard_normal((b, h, w, w)).astype(np.float32))
    disp = rng.uniform(-2, d + 2, (b, h, w)).astype(np.float32)
    gp, cp = pool_last_axis(geo, levels - 1), pool_last_axis(corr, levels - 1)
    mesh, jmesh = _meshes(n)
    gk, ck = jpk.to_kernel_layout(gp, cp)
    want = np.asarray(jpk.disparity_lookup_pallas_sharded(
        gk, ck, jnp.asarray(disp), radius, mesh=jmesh, interpret=True))   # (B, H, W, F)
    tg = [torch.from_numpy(np.array(x)) for x in gp]
    tc = [torch.from_numpy(np.array(x)) for x in cp]
    got = sharded.disparity_lookup_sharded(sharded.shard_pyramids(tg, tc, mesh),
                                           torch.from_numpy(disp), radius)
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), want, **TOL)
    assert torch.equal(got, kernels.disparity_lookup(tg, tc, torch.from_numpy(disp), radius))


@pytest.mark.parametrize("n, batch", MESHES)
def test_sharded_attention_matches_jax(rng, monkeypatch, n, batch):
    """Divisible (B, H = 4) and non-divisible (B = 1, H = 3) batch and heads;
    each shard's heads are attended once, on its device."""
    mesh, jmesh = _meshes(n)
    calls = []
    heads = kernels.flash_attention_heads
    monkeypatch.setattr(kernels, "flash_attention_heads",
                        lambda q, s, h0, nh: calls.append((q.shape[0], h0, nh)) or heads(q, s, h0, nh))
    scale = 0.125
    for B, N, H, D in ((batch, 65, 4, 16), (1, 33, 3, 8)):
        qkv = rng.standard_normal((B, N, 3, H, D)).astype(np.float32)
        q, k, v = (jnp.asarray(qkv[:, :, i]) for i in range(3))
        want = np.asarray(flash_vit_attention_sharded(
            q, k, v, scale, jmesh, attn_fn=lambda a, b, c, s: chunked_attention(a, b, c, s, chunk=32)))
        calls.clear()
        got = sharded.flash_attention_sharded(torch.from_numpy(qkv), scale, mesh)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        plan = ShardPlan(mesh, B, H, CPU)
        hl = H // plan.n_split
        assert calls == [(B // plan.n_batch, j * hl, hl)
                         for _ in range(plan.n_batch) for j in range(plan.n_split)]
    assert calls == [(1, 0, 3)]                    # nothing divides: one shard, all heads


def test_haloed_twin_matches_the_tpu_kernel(rng):
    """The haloed twin on one shard against the TPU haloed kernel in interpret
    mode, given the pre-cut window it takes (shard 1 of 4 at D = 16 > W_local
    = 8: its halo reaches past shard 0 into the zeros)."""
    from foundationstereo_tpu.ops.cost_volume import group_normalize

    b, h, w, c, p, g, d, x0, wl = 1, 2, 32, 16, 4, 4, 16, 8, 8
    l, r = (rng.standard_normal((b, h, w, c)).astype(np.float32) for _ in range(2))
    rp = rng.standard_normal((b, h, w, p)).astype(np.float32)
    rwin = np.pad(r, ((0, 0), (0, 0), (d, 0), (0, 0)))[:, :, x0:x0 + d + wl]
    rpwin = np.pad(rp, ((0, 0), (0, 0), (d, 0), (0, 0)))[:, :, x0:x0 + d + wl]
    ln = group_normalize(jnp.asarray(l[:, :, x0:x0 + wl]), g).reshape(b * h, wl, g, c // g)
    rn = group_normalize(jnp.asarray(rwin), g).reshape(b * h, d + wl, g, c // g)
    jg, jr = jpk._cost_volume_rows(ln.transpose(0, 2, 3, 1), rn.transpose(0, 2, 3, 1),
                                   jnp.asarray(rpwin.reshape(b * h, d + wl, p).transpose(0, 2, 1)),
                                   d, g, interpret=True, haloed=True)        # (R, D, C', W)
    gwc, rps = kernels.cost_volume_parts_haloed(_nchw(l[:, :, x0:x0 + wl]), _nchw(r), _nchw(rp),
                                                d, g, x0)
    np.testing.assert_allclose(gwc.permute(0, 3, 2, 1, 4).reshape(b * h, d, g, wl).numpy(),
                               np.asarray(jg), **TOL)
    np.testing.assert_array_equal(rps.permute(0, 3, 2, 1, 4).reshape(b * h, d, p, wl).numpy(),
                                  np.asarray(jr))
