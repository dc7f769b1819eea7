"""The port's plain ops against the JAX package's, on the CPU in fp32.

Same inputs (numpy, seeded) through both; the port is channel-first, the
JAX package channel-last, so each comparison moves the channel axis.
Tolerance: 1e-5 absolute (and relative) -- both sides compute in fp32 and
differ only in summation order.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from foundationstereo_torch.ops import cost_volume as tcv
from foundationstereo_torch.ops import resize as tres
from foundationstereo_torch.ops import sampler as tsam
from foundationstereo_torch.ops import upsample as tup
from foundationstereo_torch.ops.pad import InputPadder as TPadder
from foundationstereo_tpu.ops import cost_volume as jcv
from foundationstereo_tpu.ops import resize as jres
from foundationstereo_tpu.ops import sampler as jsam
from foundationstereo_tpu.ops import upsample as jup
from foundationstereo_tpu.ops.pad import InputPadder as JPadder

TOL = dict(rtol=1e-5, atol=1e-5)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def nhwc(t):
    return np.moveaxis(t.numpy(), 1, -1)


@pytest.mark.parametrize("method,align,scale", [
    ("linear", False, None), ("linear", True, None), ("cubic", False, None),
    ("cubic", True, None),
    ("cubic", False, (24 + 0.1) / 37),      # the ViT pos-embed case (37 -> 24)
])
def test_interp_matrices_match(method, align, scale):
    out = 24 if scale else 29
    got = tres.interp_matrix_np(37, out, method, align, scale)
    want = np.asarray(jres.resize1d_matrix(37, out, method, align, scale))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode,align", [("bilinear", False), ("bilinear", True),
                                        ("bicubic", False)])
def test_resize2d_and_via(rng, mode, align):
    x = rng.standard_normal((2, 13, 21, 3)).astype(np.float32)
    got = tres.resize2d(nchw(x), (17, 40), mode, align)
    want = jres.resize2d(jnp.asarray(x), (17, 40), mode, align)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)
    got = tres.resize2d_via(nchw(x), (56, 84), (9, 20), mode, align)
    want = jres.resize2d_via(jnp.asarray(x), (56, 84), (9, 20), mode, align)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)


def test_resize_dhw(rng):
    x = rng.standard_normal((1, 6, 8, 10, 4)).astype(np.float32)
    got = tres.resize_dhw(torch.from_numpy(np.moveaxis(x, -1, 1).copy()), (24, 32, 40))
    want = jres.resize_dhw(jnp.asarray(x), (24, 32, 40), "trilinear", False)
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape,divis", [((1, 37, 53, 3), 32), ((2, 64, 96, 3), 32),
                                         ((1, 30, 41, 3), 8)])
def test_input_padder(rng, shape, divis):
    x = rng.uniform(0, 255, shape).astype(np.float32)
    tp, jp = TPadder(shape, divis_by=divis), JPadder(shape, divis_by=divis)
    assert tp.pads == jp.pads and tp.padded_shape() == jp.padded_shape()
    padded = tp.pad(torch.from_numpy(x))
    np.testing.assert_array_equal(padded.numpy(), np.asarray(jp.pad(jnp.asarray(x))))
    np.testing.assert_array_equal(tp.unpad(padded).numpy(), x)


@pytest.mark.parametrize("w,maxdisp", [(40, 12), (37, 20), (16, 24)])
def test_volumes(rng, w, maxdisp):
    b, h, c, g = 2, 5, 16, 4
    l = rng.standard_normal((b, h, w, c)).astype(np.float32)
    r = rng.standard_normal((b, h, w, c)).astype(np.float32)
    gn = tcv.group_normalize(nchw(l), g).numpy()                     # (B, G, cg, H, W)
    np.testing.assert_allclose(gn.transpose(0, 3, 4, 1, 2),
                               np.asarray(jcv.group_normalize(jnp.asarray(l), g)), **TOL)
    gwc = tcv.build_gwc_volume(nchw(l), nchw(r), maxdisp, g).numpy()  # (B, G, D, H, W)
    want = np.asarray(jcv.build_gwc_volume(jnp.asarray(l), jnp.asarray(r), maxdisp, g))
    np.testing.assert_allclose(gwc.transpose(0, 2, 3, 4, 1), want, **TOL)
    cat = tcv.build_concat_volume(nchw(l), nchw(r), maxdisp).numpy()
    want = np.asarray(jcv.build_concat_volume(jnp.asarray(l), jnp.asarray(r), maxdisp))
    np.testing.assert_array_equal(cat.transpose(0, 2, 3, 4, 1), want)
    corr = tcv.all_pairs_correlation(nchw(l), nchw(r)).numpy()
    want = np.asarray(jcv.all_pairs_correlation(jnp.asarray(l), jnp.asarray(r)))
    np.testing.assert_allclose(corr, want, **TOL)


def test_pool_last_axis(rng):
    x = rng.standard_normal((2, 3, 4, 5, 27)).astype(np.float32)
    got = tsam.pool_last_axis(torch.from_numpy(x), 3)
    want = jsam.pool_last_axis(jnp.asarray(x), 3)
    assert [t.shape[-1] for t in got] == [27, 13, 6, 3]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def _lookup_inputs(rng, b=1, h=4, w=32, c=6, d=16, levels=3):
    geo = rng.standard_normal((b, h, w, c, d)).astype(np.float32)
    corr = rng.standard_normal((b, h, w, w)).astype(np.float32)
    disp = rng.uniform(-d, 2 * d, (b, h, w)).astype(np.float32)
    disp[0, 0, :8] = np.arange(8)                       # exact integers
    disp[0, 1, :6] = [-100.0, 1e4, -0.5, d - 0.5, d - 1, -1.0]  # extremes, straddles
    gp = jsam.pool_last_axis(jnp.asarray(geo), levels - 1)
    cp = jsam.pool_last_axis(jnp.asarray(corr), levels - 1)
    return gp, cp, disp


@pytest.mark.parametrize("radius", [1, 4])
def test_disparity_lookup(rng, radius):
    gp, cp, disp = _lookup_inputs(rng)
    want = np.asarray(jsam.disparity_lookup(gp, cp, jnp.asarray(disp), radius))  # (B, H, W, F)
    got = tsam.disparity_lookup([torch.from_numpy(np.array(g)) for g in gp],
                                [torch.from_numpy(np.array(c)) for c in cp],
                                torch.from_numpy(disp), radius)               # (B, F, H, W)
    np.testing.assert_allclose(nhwc(got), want, **TOL)


def test_disparity_regression(rng):
    prob = rng.uniform(0, 1, (2, 12, 5, 7)).astype(np.float32)
    got = tup.disparity_regression(torch.from_numpy(prob), 12).numpy()
    np.testing.assert_allclose(got, np.asarray(jup.disparity_regression(jnp.asarray(prob), 12)),
                               **TOL)


def test_context_upsample_matches_both_jax_forms(rng):
    """One port form against the JAX package's interleaved and phased forms."""
    b, h, w = 2, 5, 7
    disp = rng.uniform(0, 40, (b, h, w)).astype(np.float32)
    logits = rng.standard_normal((b, 9, 4 * h, 4 * w)).astype(np.float32)
    wts = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    got = tup.context_upsample(torch.from_numpy(disp), torch.from_numpy(wts)).numpy()
    want = jup.context_upsample(jnp.asarray(disp), jnp.asarray(np.moveaxis(wts, 1, -1)))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    # Phased weights: phase 2a+b of full-res pixel (2Y+a, 2X+b) at half-res (Y, X).
    phased = np.stack([wts[:, :, a::2, bb::2] for a in (0, 1) for bb in (0, 1)], axis=1)
    want = jup.context_upsample_phased(jnp.asarray(disp), jnp.asarray(phased))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_avg_pool2x(rng):
    x = rng.standard_normal((2, 9, 11, 3)).astype(np.float32)
    got = tup.avg_pool2x(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(jup.avg_pool2d(jnp.asarray(x), 3, 2, 1)),
                               **TOL)
