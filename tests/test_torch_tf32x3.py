"""The three-pass TF32 ("3xTF32") products of the fp32 kernels -- K4's fp32
variant (``csrc/conv3x3.cu``) and K3's / K3s's (``csrc/flash_attention.cu``)
-- modelled on the CPU.

The kernels cannot run here; their arithmetic and their layouts can:

* the split x = hi + lo (``kernels.tf32_split``, ``cvt.rna.tf32.f32`` by bit
  arithmetic on the int32 view);
* the three passes lo * hi + hi * lo + hi * hi as three fp32 products on
  the CPU (each tf32 x tf32 product is exact in fp32), held to the fp32
  limits the card holds the kernels to: the conv's per-element
  2(9C - 1) 2^-24 sum|x w| and mean 1e-5 mean |ref| of
  ``chip_smoke._conv_errors`` at the card tests' conv shapes, and
  attention's max 1e-5 against the fp32 dense twin at N = 1100, 3 heads,
  with the kernel's 64-key tiles; one pass (hi * hi) is recorded beside
  and misses both;
* a model of the tensor cores' round-toward-zero adds, which is why each
  kernel sums into a fresh partial accumulator per chunk or key tile;
* the fp32 grids at the main path's shapes, each output stored once;
* the key order of V's transposed tile, which must match the order in
  which P's accumulator fills the TF32 A fragment.

The fp32 weight pack is inverted bit for bit in ``test_torch_conv3x3.py``.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np
import pytest
import torch

from foundationstereo_torch.ops import kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (imports torch only inside its functions)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def test_tf32_split_rounds_to_nearest_with_ties_away_from_zero():
    tie = 1 + 2.0 ** -11                        # half a tf32 ulp above 1
    x = torch.tensor([tie, -tie, tie + 2.0 ** -20, 1 + 2.0 ** -12, 3.0, 0.0, -2.5e-30],
                     dtype=torch.float32)
    hi, lo = kernels.tf32_split(x)
    assert hi.tolist()[:5] == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1 + 2.0 ** -10, 1.0, 3.0]
    assert hi[5] == 0 and lo[5] == 0
    g = torch.Generator().manual_seed(0)
    x = torch.randn(100_000, generator=g) * torch.exp2(torch.randint(-60, 60, (100_000,), generator=g))
    hi, lo = kernels.tf32_split(x)
    assert not (_bits(hi) & 0x1FFF).any() and not (_bits(lo) & 0x1FFF).any()
    x64, hi64, lo64 = x.double(), hi.double(), lo.double()
    assert bool(((x64 - hi64).abs() <= 2.0 ** -11 * x64.abs()).all())
    assert bool(((x64 - hi64 - lo64).abs() <= 2.0 ** -22 * x64.abs()).all())


def three_pass_conv(x, w, bias, passes=3):
    """The conv with each product x * w taken as lo_x hi_w + hi_x lo_w +
    hi_x hi_w (``passes`` = 3) or hi_x hi_w alone (1): fp32 convs of tf32
    values, whose products are exact in fp32."""
    xh, xl = kernels.tf32_split(x)
    wh, wl = kernels.tf32_split(w)
    out = kernels.conv3x3_plain(xh, wh, bias)
    if passes == 3:
        out = kernels.conv3x3_plain(xl, wh) + kernels.conv3x3_plain(xh, wl) + out
    return out


@pytest.mark.parametrize("c,f,h,w", [
    (136, 127, 7, 45), (200, 70, 9, 33), (128, 256, 4, 32), (16, 8, 3, 5),
    (168, 64, 13, 80), (128, 96, 6, 130), (384, 256, 46, 80), (256, 128, 23, 40),
])
def test_three_pass_conv_meets_the_fp32_limits(c, f, h, w):
    """The card tests' conv shapes (inputs as ``chip_smoke._conv_case``
    draws them): three passes within the per-element and mean limits, one
    pass beyond the mean one."""
    g = torch.Generator().manual_seed(c + f)
    x = torch.randn(2, c, h, w, generator=g)
    wt = torch.randn(f, c, 3, 3, generator=g) / math.sqrt(9 * c)
    bias = 0.1 * torch.randn(f, generator=g)
    ref = kernels.conv3x3_plain(x, wt, bias)
    _, mean3, ok3, mean_ok3 = chip_smoke._conv_errors(x, wt, bias, three_pass_conv(x, wt, bias), ref)
    _, mean1, ok1, mean_ok1 = chip_smoke._conv_errors(x, wt, bias, three_pass_conv(x, wt, bias, 1), ref)
    limit = 1e-5 * float(ref.abs().mean())
    assert ok3 and mean_ok3, (mean3, limit)
    assert not mean_ok1, (mean1, limit)           # one TF32 pass: ~1e-4 of |ref|


def _rz(v: np.ndarray) -> np.ndarray:
    """fp64 -> fp32 rounded toward zero."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _rz_dot(a: np.ndarray, b: np.ndarray, chunk_steps: int) -> np.ndarray:
    """Rows of a . b (length K) as the fp32 conv kernel sums them, on a
    model of the tensor cores: each K step of 8 adds its three passes' 24
    exact products to the partial sum rounded toward zero; every
    ``chunk_steps`` steps (0: never) the partial is added to the total in
    fp32, rounded to nearest."""
    ah, al = (t.numpy().astype(np.float64) for t in kernels.tf32_split(torch.from_numpy(a)))
    bh, bl = (t.numpy().astype(np.float64) for t in kernels.tf32_split(torch.from_numpy(b)))
    total = np.zeros(a.shape[0], np.float32)
    part = np.zeros(a.shape[0], np.float32)
    steps = a.shape[1] // 8
    for s in range(steps):
        k = slice(8 * s, 8 * s + 8)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            part = _rz(part + (x[:, k] * y[:, k]).sum(1))
        if chunk_steps and (s + 1) % chunk_steps == 0:
            total, part = total + part, np.zeros_like(part)
    return total + part


def test_round_toward_zero_adds_need_the_chunk_partials():
    """512 input channels (K = 4608): one accumulator over all K misses the
    conv's mean limit under round-toward-zero adds; a fresh partial per
    16-channel chunk (9 taps x 2 K steps) meets it."""
    rng = np.random.default_rng(0)
    k = 9 * 512
    a = rng.standard_normal((256, k)).astype(np.float32)
    b = (rng.standard_normal((256, k)) / math.sqrt(k)).astype(np.float32)
    exact = (a.astype(np.float64) * b).sum(1)
    limit = 1e-5 * float(np.abs(exact).mean())
    whole = float(np.abs(_rz_dot(a, b, 0) - exact).mean())
    chunked = float(np.abs(_rz_dot(a, b, 18) - exact).mean())
    assert whole > limit > 2 * chunked, (whole, chunked, limit)


def flash_three_pass(qkv: torch.Tensor, scale: float, passes: int = 3) -> torch.Tensor:
    """The fp32 attention kernel's arithmetic on the CPU: 64-key tiles, S
    and each tile's P V in ``passes`` TF32 passes into fresh accumulators,
    the online softmax in the log2 domain, O = O * alpha + (P V)_tile."""
    b, n, _, heads, hd = qkv.shape
    q, k, v = (t.permute(0, 2, 1, 3).reshape(b * heads, n, hd) for t in qkv.unbind(2))

    def mm(x, y):
        xh, xl = kernels.tf32_split(x)
        yh, yl = kernels.tf32_split(y)
        out = xh @ yh
        return xl @ yh + xh @ yl + out if passes == 3 else out

    scale_log2 = scale * math.log2(math.e)
    m = torch.full((b * heads, n, 1), -math.inf)
    lsum = torch.zeros(b * heads, n, 1)
    o = torch.zeros(b * heads, n, hd)
    for k0 in range(0, n, 64):
        s = mm(q, k[:, k0:k0 + 64].transpose(1, 2)) * scale_log2
        mx = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha, p = torch.exp2(m - mx), torch.exp2(s - mx)
        m, lsum = mx, lsum * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + mm(p, v[:, k0:k0 + 64])
    return (o / lsum).reshape(b, heads, n, hd).permute(0, 2, 1, 3)


def test_three_pass_attention_meets_the_fp32_limit():
    """N = 1100 (a ragged last key tile), 3 heads, the card test's inputs:
    three passes within 1e-5 of the fp32 dense twin, one pass beyond."""
    g = torch.Generator().manual_seed(3)
    qkv = torch.randn(2, 1100, 3, 3, 64, generator=g)
    ref = kernels.flash_attention_plain(qkv, 0.125)
    err3 = float((flash_three_pass(qkv, 0.125) - ref).abs().max())
    err1 = float((flash_three_pass(qkv, 0.125, passes=1) - ref).abs().max())
    assert err3 <= 1e-5 < err1, (err3, err1)


# ---------------------------------------------------------------------------
# Grids and layouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("f,h,w,images,bn,blocks", [
    (512, 184, 320, 1, 128, 4 * 92 * 5),     # gru04: 2 rows x 64 px x 128 ch
    (127, 184, 320, 1, 128, 1 * 92 * 5),     # the encoder's ragged F
    (256, 46, 80, 1, 128, 2 * 23 * 2),       # gru16 z/r
    (168, 23, 40, 13, 64, 3 * 6 * 1 * 13),   # the hourglass's (1, 3, 3) conv: 192 < 256 channels
    (64, 184, 320, 1, 64, 1 * 46 * 5),       # mask.0: 4 rows x 64 px x 64 ch
    (512, 92, 160, 1, 128, 4 * 46 * 3),      # gru08
])
def test_fp32_conv_grid_stores_every_output_once(f, h, w, images, bn, blocks):
    """The fp32 tile is fixed by the registers: R = 128 / BN rows per
    consumer warpgroup, BN = 64 where F <= 64 or 64-channel tiles pad F
    less. Block (x, y, z) of the grid stores channels x BN ..
    x BN + BN - 1 of rows (y // tiles_x) 2R + [0, 2R) and columns
    (y % tiles_x) 64 + [0, 64) of image z, those inside F, H and W."""
    rows = kernels.conv3x3_rows(f, h, w, images, 132, torch.float32)
    assert kernels._pack_rows(f, torch.float32) == bn and rows == 128 // bn
    assert kernels.conv3x3_blocks(f, h, w, images, rows, torch.float32) == blocks
    tiles_x = -(-w // 64)
    grid = (-(-f // bn), tiles_x * -(-h // (2 * rows)), images)
    assert math.prod(grid) == blocks
    seen = np.zeros((images, f, h, w), np.int32)
    for bx in range(grid[0]):
        for by in range(grid[1]):
            y0, x0 = (by // tiles_x) * 2 * rows, (by % tiles_x) * 64
            seen[:, bx * bn:(bx + 1) * bn, y0:y0 + 2 * rows, x0:x0 + 64] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("n,pairs,blocks", [
    (5377, 32, 43 * 32),     # K3: 2 views x 16 heads, 42 full 128-row tiles and a 1-row one
    (5377, 8, 43 * 8),       # a K3s shard: 4 heads
    (1100, 6, 9 * 6),
    (128, 2, 2), (129, 2, 4),
])
def test_fp32_attention_grid_stores_every_row_once(n, pairs, blocks):
    """Block L of the fp32 kernel's 1-D grid: query tile L % (T - 1) of pair
    L // (T - 1) for the first pairs x (T - 1) blocks, then each pair's last
    tile (T tiles of 128 rows per pair)."""
    assert kernels.flash_attention_blocks(n, pairs, torch.float32) == blocks
    t = -(-n // kernels.FLASH_QUERY_ROWS_FP32)
    seen = np.zeros((pairs, t * kernels.FLASH_QUERY_ROWS_FP32), np.int32)
    full = pairs * (t - 1)
    for L in range(blocks):
        bh, qt = (L // (t - 1), L % (t - 1)) if L < full else (L - full, t - 1)
        seen[bh, qt * 128:(qt + 1) * 128] += 1
    assert (seen[:, :n] == 1).all()


def _vt_image(v: np.ndarray) -> np.ndarray:
    """V's transposed tile as the producer writes it, byte for byte: key
    quad q, dim d, column e at 1024 q + 16 d + 4 e holds V[8 (q // 2) + 2 e
    + q % 2][d] (64 keys x 64 dims, fp32)."""
    img = np.zeros(64 * 64, np.float32)
    for q in range(16):
        for d in range(64):
            for e in range(4):
                img[(1024 * q + 16 * d + 4 * e) // 4] = v[8 * (q // 2) + 2 * e + q % 2, d]
    return img


def test_v_transposed_key_order_matches_the_p_fragment():
    """P V for one 64-key tile, computed the way the fp32 kernel computes
    it: each thread's P values sit in the accumulator layout (row g + 8i,
    key 8j + 2t + k in s[4j + 2i + k]); they become the TF32 A fragment of K
    step j as a0 = s[4j], a1 = s[4j + 2], a2 = s[4j + 1], a3 = s[4j + 3],
    i.e. A(row g, column t), A(g + 8, t), A(g, t + 4), A(g + 8, t + 4); B is
    read from V^T through the descriptor (K-major, no swizzle: column c of
    step j in core matrix 2j + c // 4 at LBO = 1024, dim n at SBO = 128 per
    8 dims, 16 bytes per dim). The product equals P @ V."""
    rng = np.random.default_rng(4)
    p = rng.random((64, 64)).astype(np.float64)
    v = rng.standard_normal((64, 64)).astype(np.float32)
    img = _vt_image(v).astype(np.float64)
    out = np.zeros((64, 64))
    for warp in range(4):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            # The thread's accumulator registers: s[4j + 2i + k].
            s = np.zeros(32)
            for j in range(8):
                for i in range(2):
                    for k in range(2):
                        s[4 * j + 2 * i + k] = p[16 * warp + g + 8 * i, 8 * j + 2 * t + k]
            for j in range(8):
                frag = {(g, t): s[4 * j], (g + 8, t): s[4 * j + 2],
                        (g, t + 4): s[4 * j + 1], (g + 8, t + 4): s[4 * j + 3]}
                for (r, c), a in frag.items():
                    addr = 1024 * (2 * j + c // 4) + 128 * (np.arange(64) // 8) + 16 * (np.arange(64) % 8) \
                        + 4 * (c % 4)
                    out[16 * warp + r] += a * img[addr // 4]
    np.testing.assert_allclose(out, p @ v.astype(np.float64), rtol=1e-12, atol=1e-12)
