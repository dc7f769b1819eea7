"""The launch geometry of the lookup (K2, K5's lookup) and cost-volume (K1,
K5's build) kernels, and the lookup's sector floor, on the CPU.

The kernels cannot run here; what they launch can. Each kernel's C entry
point reports the grid it launched, and ``chip_smoke.py`` and the card
tests check it against the helpers in ``ops/kernels.py``. These tests
model the mapping the kernels document (block and thread -> output
elements) from those helpers and check that every output element is
stored exactly once: at the main path's shapes (W = 320, a shard's
W_local = 80, D = 104), and at a few ragged widths and disparity counts
(the card tests hold the kernels themselves at every tile edge). The
sector count that ``chip_smoke.py`` turns into the lookup's floor is held
against a brute-force count over every element the windows touch, in the
pyramids' layout and with the geometry channels innermost.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np
import pytest
import torch

from foundationstereo_torch.ops import kernels, sampler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (imports torch only inside its functions)


def lookup_coverage(b, h, w, levels, c, radius):
    """How often the lookup kernel stores each output (B, F, H * W), from
    the grid ``lookup_grid`` gives and the documented mapping: thread t of
    block (item, y, b) stores the 2r + 1 taps of its item at pixels q0 and
    q0 + 1 below H * W, q0 = (y * LOOKUP_THREADS + t) * LOOKUP_PIXELS."""
    items, ys, bs = kernels.lookup_grid(b, h, w, levels, c)
    k = 2 * radius + 1
    count = np.zeros((b, items * k, h * w), np.int32)
    threads = np.arange(ys * kernels.LOOKUP_THREADS)
    for p in range(kernels.LOOKUP_PIXELS):
        q = threads * kernels.LOOKUP_PIXELS + p
        q = q[q < h * w]
        for item in range(items):
            for bb in range(bs):
                np.add.at(count, (bb, slice(item * k, (item + 1) * k), q), 1)
    return count


@pytest.mark.parametrize("w,radius", [(320, 4), (80, 4), (87, 4), (7, 1), (1, 6)])
def test_lookup_grid_stores_every_output_once(w, radius):
    b, h, levels, c = 2, 3, 4, 28
    count = lookup_coverage(b, h, w, levels, c, radius)
    assert count.shape[1] == levels * (c + 1) * (2 * radius + 1)
    assert (count == 1).all()


def test_lookup_grid_at_the_main_shapes():
    """26,680 blocks at 184x320 and 6,728 for an 80-column shard (4 levels,
    28 channels); the grid's y axis stays inside CUDA's 65,535."""
    assert kernels.lookup_grid(1, 184, 320, 4, 28) == (116, 230, 1)
    assert kernels.lookup_grid(1, 184, 80, 4, 28) == (116, 58, 1)
    assert kernels.lookup_grid(1, 736, 1280, 4, 28)[1] <= 65535


def cost_volume_coverage(b, h, w, d, groups, p):
    """How often the cost-volume kernel stores each gwc (B, G, D, H, W) and
    rps (B, P, D, H, W) element, from ``cost_volume_grid`` and the
    documented mapping: block (x, y, z) serves columns [x WT, (x + 1) WT) of
    row z of the B * H (b, h) rows; in a group block, thread t < nwt *
    ceil(D / 8) owns columns 8 (t % nwt) + [0, 8) and disparities
    8 (t // nwt) + [0, 8) of the tile;
    a projection block's threads step over the tile's (d, 8-column run)
    items by the block's thread count."""
    grid, threads = kernels.cost_volume_grid(b, h, w, d, groups, p)
    gx, gy, gz = grid
    assert (gy, gz) == (groups + p, b * h)
    nwt = kernels.cost_volume_tile(w, d)
    ndt = -(-d // kernels.CV_TILE_D)
    wt = kernels.CV_TILE_W * nwt
    gwc = np.zeros((b, groups, d, h, w), np.int32)
    rps = np.zeros((b, p, d, h, w), np.int32)
    for x, z in ((x, z) for x in range(gx) for z in range(gz)):
        bb, hh = divmod(z, h)
        for t in range(min(threads, nwt * ndt)):
            w0 = x * wt + 8 * (t % nwt)
            d0 = 8 * (t // nwt)
            gwc[bb, :, d0:d0 + 8, hh, w0:min(w0 + 8, w)] += 1
        for it in range(d * nwt):
            dd, w0 = it // nwt, x * wt + 8 * (it % nwt)
            rps[bb, :, dd, hh, w0:min(w0 + 8, w)] += 1
    return gwc, rps, threads, nwt, ndt


@pytest.mark.parametrize("w,d", [(320, 104), (80, 104), (87, 104), (41, 7), (9, 13), (1, 1)])
def test_cost_volume_grid_stores_every_output_once(w, d):
    gwc, rps, threads, nwt, ndt = cost_volume_coverage(2, 3, w, d, 8, 12)
    assert (gwc == 1).all() and (rps == 1).all()
    assert threads % 32 == 0 and nwt * ndt <= threads <= kernels.CV_MAX_THREADS


def test_cost_volume_tile_at_the_main_shapes():
    """4 tiles of 80 columns at W = 320 and one at a shard's 80, 130 thread
    tiles in a block of 160 threads, and the normalised rows within a
    block's 227 KB of shared memory (cg = 28: 184 right and 80 left fp32
    columns)."""
    assert kernels.cost_volume_tile(320, 104) == kernels.cost_volume_tile(80, 104) == 10
    assert kernels.cost_volume_grid(1, 184, 320, 104, 8, 12) == ((4, 20, 184), 160)
    assert kernels.cost_volume_grid(1, 184, 80, 104, 8, 12) == ((1, 20, 184), 160)
    assert 28 * (8 * 13 + 2 * 80) * 4 <= 232448


def _brute_force_sectors(geo, corr, disp, r, x_offset, channels_last):
    """Every element of every window, at its address: element e of
    channel ch of pixel p at ((p * C + ch) * L + e) in the pyramids' own
    layout, at ((p * L + e) * C + ch) with the channels innermost."""
    sectors = set()
    b, h, w = disp.shape
    C = geo[0].shape[3]
    for i, (g, c) in enumerate(zip(geo, corr)):
        s = 2.0 ** -i
        for p in range(b * h * w):
            dv = float(disp.view(-1)[p])
            ww = p % w
            for vol, x, chans in ((g, dv * s, C), (c, (ww + x_offset - dv) * s, 1)):
                n, es = vol.shape[-1], vol.element_size()
                i0 = math.floor(min(max(x, -(n + 2 * r + 2)), n + 2 * r + 2))
                for ch in range(chans):
                    for e in range(max(i0 - r, 0), min(i0 + r + 2, n)):
                        at = (p * n + e) * C + ch if channels_last and vol is g else \
                            (p * chans + ch) * n + e
                        sectors.add((vol.data_ptr() + at * es) >> 5)
    return len(sectors)


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,w,c,d,levels,r,x_offset", [
    (1, 2, 9, 3, 26, 4, 4, 0),      # rows of 26/13/6/3 values: windows cross rows and sectors
    (2, 1, 7, 5, 13, 3, 1, 5),      # odd lengths, a shard's x offset
    (1, 3, 5, 2, 104, 2, 6, 0),     # the main path's D, radius 6
])
def test_lookup_sectors_match_a_brute_force_count(dtype, b, h, w, c, d, levels, r, x_offset,
                                                  channels_last):
    g = torch.Generator().manual_seed(0)
    geo = [x.to(dtype).contiguous()
           for x in sampler.pool_last_axis(torch.rand(b, h, w, c, d, generator=g), levels - 1)]
    corr = [x.to(dtype).contiguous()
            for x in sampler.pool_last_axis(torch.rand(b, h, w, w + x_offset, generator=g), levels - 1)]
    disp = torch.rand(b, h, w, generator=g) * (d + 8) - 4
    disp.view(-1)[:3] = torch.tensor([-100.0, 1e4, 2.0])     # far out both ways, an integer
    assert chip_smoke.lookup_sectors(geo, corr, disp, r, x_offset, channels_last) == \
        _brute_force_sectors(geo, corr, disp, r, x_offset, channels_last)
