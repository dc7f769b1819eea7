"""The port's CUDA kernels against their plain twins, on a CUDA card.

Marked ``gpu``: without a card every test here skips. This file imports no
JAX, so it runs on the card's machine, which has none:

    python -m pytest tests/test_torch_gpu.py -q -o addopts="" --noconftest

Tolerances: fp32 outputs 1e-5 (summation order; the fp32 attention and
3x3 conv kernels take their products in three TF32 passes, ~2^-21 of each
product, see ``test_torch_tf32x3.py``); bf16 outputs 2^-8, one
bf16 ulp at the largest magnitude (inputs in [-1, 1]); bf16 attention
against the fp32 twin: max error 2 bf16 ulps of max |ref|, mean error 1 bf16
ulp of mean |ref| (output rounding and bf16 probabilities in P @ V). The 3x3
conv (outputs of order 1, sums of up to 9*200 exact products in fp32):
fp32 1e-4, bf16 1 bf16 ulp of the larger magnitude + 1e-4. The sharded
kernels (K5 build and lookup, K3s) take their single-device twins'
tolerances per shard, and their stitched outputs must equal the
single-device kernels' bit for bit (the same arithmetic per element).
Tests that need two cards skip below that.
"""

from __future__ import annotations

import ctypes
import math

import pytest
import torch

from foundationstereo_torch.config import ModelConfig
from foundationstereo_torch.models.dinov2 import Attention
from foundationstereo_torch.models.foundation_stereo import FoundationStereo
from foundationstereo_torch.models.layers import dropout_generator
from foundationstereo_torch.ops import cost_volume, kernels, sampler, sharded
from foundationstereo_torch.parallel import make_mesh, mesh_context

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _uniform(gen, *shape, device):
    return torch.rand(*shape, device=device, generator=gen) * 2 - 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cost_volume_kernel(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    l, r = (_uniform(g, 2, 64, 7, 90, device=cuda).to(dtype) for _ in range(2))
    rp = _uniform(g, 2, 12, 7, 90, device=cuda).to(dtype)
    kernels.reset_launches()
    gk, rk = kernels.cost_volume_parts(l, r, rp, 40, 8, out_dtype=dtype)
    gp, rpp = cost_volume.cost_volume_parts(l, r, rp, 40, 8, out_dtype=dtype)
    atol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
    torch.testing.assert_close(gk.float(), gp.float(), rtol=0, atol=atol)
    assert torch.equal(rk, rpp)
    assert kernels.LAUNCHES["cost_volume_parts"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lookup_kernel(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    b, h, w, c, d = 2, 5, 40, 7, 24
    geo = sampler.pool_last_axis(_uniform(g, b, h, w, c, d, device=cuda), 3)
    corr = sampler.pool_last_axis(_uniform(g, b, h, w, w, device=cuda), 3)
    geo = [x.to(dtype).contiguous() for x in geo]
    corr = [x.to(dtype).contiguous() for x in corr]
    disp = torch.rand(b, h, w, device=cuda, generator=g) * 3 * d - d
    disp[0, 0, :8] = torch.arange(8, device=cuda, dtype=torch.float32)
    disp[0, 1, :6] = torch.tensor([-100.0, 1e4, -0.5, d - 0.5, d - 1, -1.0], device=cuda)
    out = kernels.disparity_lookup(geo, corr, disp, 4, out_dtype=dtype)
    ref = sampler.disparity_lookup(geo, corr, disp, 4, out_dtype=dtype)
    atol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=atol)


def _assert_within_one_ulp(out, ref, extra):
    """Per element: 1 bf16 ulp of the larger magnitude + ``extra`` (bf16
    outputs), or 2^-22 of it + ``extra`` (fp32 outputs)."""
    o, r = out.float(), ref.float()
    big = torch.maximum(o.abs(), r.abs())
    if out.dtype == torch.bfloat16:
        tol = torch.exp2(torch.floor(torch.log2(big.clamp_min(2.0 ** -126))) - 7)
    else:
        tol = big * 2.0 ** -22
    assert bool(((o - r).abs() <= tol + extra).all()), float((o - r).abs().max())


_IN_OUT = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
           (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)]


@pytest.mark.parametrize("din,dout", _IN_OUT)
@pytest.mark.parametrize("radius", [1, 4, 6, 9])
def test_lookup_kernel_levels_radii_and_types(cuda, din, dout, radius):
    """Level lengths 104/52/26/13 and odd ones (25/12/6/3, correlation rows
    of 41/20/10/5), an odd and an even number of pixels per image (the
    scalar and the paired stores), integer, fractional and far-out
    disparities; radius 4's own instantiation and the generic one (1 chunk
    of taps, 2, and 3 at r = 9); the grid launched is the helper's."""
    g = torch.Generator(device=cuda).manual_seed(20 + radius)
    for d, (h, w) in ((104, (4, 40)), (25, (3, 41))):
        geo = [x.to(din).contiguous()
               for x in sampler.pool_last_axis(_uniform(g, 2, h, w, 5, d, device=cuda), 3)]
        corr = [x.to(din).contiguous()
                for x in sampler.pool_last_axis(_uniform(g, 2, h, w, w, device=cuda), 3)]
        disp = torch.rand(2, h, w, device=cuda, generator=g) * 3 * d - d
        disp[0, 0, :8] = torch.arange(8, device=cuda, dtype=torch.float32)
        disp[0, 1, :6] = torch.tensor([-100.0, 1e4, -0.5, d - 0.5, d - 1, -1.0], device=cuda)
        out = kernels.disparity_lookup(geo, corr, disp, radius, out_dtype=dout)
        assert kernels.LOOKUP_LAUNCHED == dict(grid=kernels.lookup_grid(2, h, w, 4, 5),
                                               tile=(128, 2, radius))
        ref = sampler.disparity_lookup(geo, corr, disp, radius, out_dtype=dout)
        _assert_within_one_ulp(out, ref, 1e-6)


def test_lookup_shards_of_odd_width_stitch_bit_for_bit(cuda):
    """4 shards of 11 columns (33 pixels per image: scalar stores) against
    the unsharded kernel (132 pixels: paired stores), radius 6."""
    g = torch.Generator(device=cuda).manual_seed(23)
    geo = [x.bfloat16().contiguous()
           for x in sampler.pool_last_axis(_uniform(g, 1, 3, 44, 7, 52, device=cuda), 3)]
    corr = [x.bfloat16().contiguous()
            for x in sampler.pool_last_axis(_uniform(g, 1, 3, 44, 44, device=cuda), 3)]
    disp = torch.rand(1, 3, 44, device=cuda, generator=g) * 80 - 10
    got = sharded.disparity_lookup_sharded(
        sharded.shard_pyramids(geo, corr, _one_card_mesh(cuda)), disp, 6, torch.bfloat16)
    assert torch.equal(got, kernels.disparity_lookup(geo, corr, disp, 6, torch.bfloat16))


@pytest.mark.parametrize("din,dout", _IN_OUT)
def test_cost_volume_kernel_at_every_tile_edge(cuda, din, dout):
    """Widths 1, 7, 9, 41, 87 (ragged 8-column runs and tiles: scalar
    stores), 80 and 320 (whole tiles: 16-byte stores) by 1, 7, 13 and 104
    disparities, with 28 channels per group (the main path's template) and
    8 (the generic one); the grid launched is the helper's."""
    g = torch.Generator(device=cuda).manual_seed(24)
    for c, groups in ((56, 2), (64, 8)):
        for w in (1, 7, 9, 41, 87, 80, 320):
            l, r = (_uniform(g, 1, c, 2, w, device=cuda).to(din) for _ in range(2))
            rp = _uniform(g, 1, 3, 2, w, device=cuda).to(din)
            for d in (1, 7, 13, 104):
                gk, rk = kernels.cost_volume_parts(l, r, rp, d, groups, out_dtype=dout)
                grid, threads = kernels.cost_volume_grid(1, 2, w, d, groups, 3)
                assert kernels.COST_VOLUME_LAUNCHED == dict(
                    grid=grid, tile=(threads, 8 * kernels.cost_volume_tile(w, d), 8 * -(-d // 8)))
                gp, rpp = cost_volume.cost_volume_parts(l, r, rp, d, groups, out_dtype=dout)
                _assert_within_one_ulp(gk, gp, 2e-6)
                assert torch.equal(rk, rpp)


@pytest.mark.parametrize("w", [160, 84])
def test_haloed_shards_through_column_0_stitch_bit_for_bit(cuda, w):
    """4 shards at D = 104: every shard's halo (103 columns) passes column
    0, into the zeros; shards of 40 columns (whole 8-column runs) and of 21
    (ragged), each against its twin and stitched against K1 bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(25)
    l, r = (_uniform(g, 1, 56, 3, w, device=cuda).bfloat16() for _ in range(2))
    rp = _uniform(g, 1, 12, 3, w, device=cuda).bfloat16()
    wl = w // 4
    for j in range(4):
        lj = l[..., j * wl:(j + 1) * wl].contiguous()
        gk, rk = kernels.cost_volume_parts_haloed(lj, r, rp, 104, 2, j * wl, out_dtype=torch.bfloat16)
        gp, rpp = cost_volume.cost_volume_parts_haloed(lj, r, rp, 104, 2, j * wl,
                                                       out_dtype=torch.bfloat16)
        _assert_within_one_ulp(gk, gp, 2e-6)
        assert torch.equal(rk, rpp)
    got = sharded.cost_volume_parts_sharded(l, r, rp, 104, 2, _one_card_mesh(cuda),
                                            out_dtype=torch.bfloat16)
    want = kernels.cost_volume_parts(l, r, rp, 104, 2, out_dtype=torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def test_flash_attention_kernel_ragged(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    qkv = torch.randn(2, 1100, 3, 3, 64, device=cuda, generator=g).bfloat16()
    out = kernels.flash_attention(qkv, 0.125)
    ref = kernels.flash_attention_plain(qkv.float(), 0.125)
    err = (out.float() - ref).abs()
    assert float(err.max()) <= 2 * _bf16_ulp(float(ref.abs().max()))
    assert float(err.mean()) <= _bf16_ulp(float(ref.abs().mean()))


def _assert_attention_close(out, ref):
    err = (out.float() - ref).abs()
    assert float(err.max()) <= 2 * _bf16_ulp(float(ref.abs().max())), float(err.max())
    assert float(err.mean()) <= _bf16_ulp(float(ref.abs().mean())), float(err.mean())


@pytest.mark.parametrize("b", [1, 2])
def test_flash_attention_kernel_at_every_tile_edge(cuda, b):
    """bf16 at N on each side of the 64-row TMA box, the 128-key tile and the
    192-row query tile: rows and keys past N arrive as zeros and are masked
    or not stored; at 129 and 193 rows the tail block's idle warpgroups exit
    at once. The grid launched is the helper's."""
    g = torch.Generator(device=cuda).manual_seed(17)
    for n in (1, 63, 64, 65, 127, 128, 129, 191, 193, 1100):
        qkv = torch.randn(b, n, 3, 3, 64, device=cuda, generator=g).bfloat16()
        out = kernels.flash_attention(qkv, 0.125)
        assert kernels.FLASH_ATTENTION_LAUNCHED == dict(
            grid=(kernels.flash_attention_blocks(n, b * 3), 1, 1), tile=(192, 128, 512))
        _assert_attention_close(out, kernels.flash_attention_plain(qkv.float(), 0.125))


def test_flash_attention_launches_the_helpers_grid(cuda):
    """At the main path's tokens, K3 (2 views x 16 heads) and one K3s shard
    (4 heads) launch the grid flash_attention_blocks gives."""
    qkv = torch.randn(2, 5377, 3, 16, 64, device=cuda).bfloat16()
    for h0, heads in ((0, 16), (4, 4)):
        out = kernels.flash_attention_heads(qkv, 0.125, h0, heads)
        assert kernels.FLASH_ATTENTION_LAUNCHED["grid"] == (kernels.flash_attention_blocks(5377, 2 * heads), 1, 1)
        assert kernels.FLASH_ATTENTION_LAUNCHED["tile"][0] == kernels.FLASH_QUERY_ROWS
        assert out.shape == (2, 5377, heads, 64) and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("n", [1100, 193])
def test_head_offsets_stitch_bit_for_bit(cuda, n):
    """Head shards at h0 in {0, 2, 6} equal the single launch bit for bit: a
    (b, h) pair's arithmetic does not depend on the head range or the grid."""
    g = torch.Generator(device=cuda).manual_seed(18)
    qkv = torch.randn(2, n, 3, 8, 64, device=cuda, generator=g).bfloat16()
    whole = kernels.flash_attention(qkv, 0.125)
    for h0 in (0, 2, 6):
        part = kernels.flash_attention_heads(qkv, 0.125, h0, 2)
        assert torch.equal(part, whole[:, :, h0:h0 + 2])
        ref = kernels.flash_attention_plain(qkv[:, :, :, h0:h0 + 2].float(), 0.125)
        _assert_attention_close(part, ref)


def test_flash_attention_kernel_fp32(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn(2, 1100, 3, 3, 64, device=cuda, generator=g)
    kernels.reset_launches()
    out = kernels.flash_attention(qkv, 0.125)
    assert out.dtype == torch.float32 and kernels.LAUNCHES["flash_attention"] == 1
    torch.testing.assert_close(out, kernels.flash_attention_plain(qkv, 0.125), rtol=0, atol=1e-5)


@pytest.mark.parametrize("b", [1, 2])
def test_flash_attention_kernel_fp32_at_every_tile_edge(cuda, b):
    """fp32 at N on each side of the 64-key tile and the 128-row query tile
    (2 consumer warpgroups of 64): keys past N are written as zeros and
    masked, rows past N not stored; at 65 and 129 rows the tail block's
    second warpgroup exits at once. The grid launched is the helper's."""
    g = torch.Generator(device=cuda).manual_seed(19)
    for n in (1, 63, 64, 65, 127, 128, 129, 1100):
        qkv = torch.randn(b, n, 3, 3, 64, device=cuda, generator=g)
        out = kernels.flash_attention(qkv, 0.125)
        assert kernels.FLASH_ATTENTION_LAUNCHED == dict(
            grid=(kernels.flash_attention_blocks(n, b * 3, torch.float32), 1, 1), tile=(128, 64, 384))
        torch.testing.assert_close(out, kernels.flash_attention_plain(qkv, 0.125), rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", [1100, 129])
def test_fp32_head_offsets_stitch_bit_for_bit(cuda, n):
    """fp32 head shards equal the single launch bit for bit, and a negative
    scale (the fp32 kernel takes any) matches the twin."""
    g = torch.Generator(device=cuda).manual_seed(20)
    qkv = torch.randn(2, n, 3, 8, 64, device=cuda, generator=g)
    whole = kernels.flash_attention(qkv, 0.125)
    for h0 in (0, 2, 6):
        assert torch.equal(kernels.flash_attention_heads(qkv, 0.125, h0, 2), whole[:, :, h0:h0 + 2])
    torch.testing.assert_close(kernels.flash_attention(qkv, -0.125),
                               kernels.flash_attention_plain(qkv, -0.125), rtol=0, atol=1e-5)


def test_vit_attention_fp32_config_runs_the_kernel(cuda):
    """Without mixed precision the ViT's attention over N > 1024 tokens runs
    the fp32 kernel on the card, not the dense twin."""
    torch.manual_seed(4)
    with torch.device(cuda):
        attn = Attention(192, 3, use_kernel=True)
        x = torch.randn(1, 1100, 192)
    plain = Attention(192, 3, use_kernel=False).to(cuda)
    plain.load_state_dict(attn.state_dict())
    kernels.reset_launches()
    with torch.no_grad():
        got, want = attn(x), plain(x)
    assert kernels.LAUNCHES["flash_attention"] == 1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    qkv = torch.zeros(1, 70, 3, 2, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kernels.flash_attention(qkv, 0.125)                      # fp16
    with pytest.raises(ValueError, match="want"):
        kernels.flash_attention(torch.zeros(1, 70, 3, 2, 32, device=cuda).bfloat16(), 0.1)
    with pytest.raises(ValueError, match="positive scale"):       # folded into the exponent
        kernels.flash_attention(qkv.bfloat16(), 0.0)
    x = torch.zeros(1, 64, 4, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.cost_volume_parts(x.transpose(2, 3).contiguous().transpose(2, 3), x,
                                  torch.zeros(1, 12, 4, 16, device=cuda), 8, 8)


def test_kernels_refuse_inputs_that_need_a_backward(cuda):
    """No kernel has a backward: a tensor that requires grad, with grad
    enabled, raises instead of giving an output with no ``grad_fn``. A
    forward that takes gradients, in train or eval mode, routes round every
    kernel but the frozen ViT's attention."""
    x = torch.zeros(1, 64, 4, 16, device=cuda, requires_grad=True)
    rp = torch.zeros(1, 12, 4, 16, device=cuda)
    geo = [torch.zeros(1, 4, 16, 3, 8, device=cuda, requires_grad=True)]
    corr = [torch.zeros(1, 4, 16, 16, device=cuda)]
    disp = torch.zeros(1, 4, 16, device=cuda)
    conv_x = torch.zeros(1, 128, 4, 16, device=cuda)
    w = torch.zeros(64, 128, 3, 3, device=cuda, requires_grad=True)
    qkv = torch.zeros(1, 70, 3, 2, 64, device=cuda, requires_grad=True)
    calls = [lambda: kernels.cost_volume_parts(x, x, rp, 8, 8),
             lambda: kernels.disparity_lookup(geo, corr, disp, 1),
             lambda: kernels.conv3x3(conv_x, w),
             lambda: kernels.flash_attention(qkv, 0.125),
             lambda: kernels.flash_attention_heads(qkv, 0.125, 0, 1)]
    for call in calls:
        with pytest.raises(ValueError, match="no backward"):
            call()
        with torch.no_grad():
            call()
    model = FoundationStereo(ModelConfig(vit_size="vits", max_disp=64, pallas_conv3x3=True),
                             device=cuda, seed=0)
    left = torch.rand(1, 64, 96, 3, device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    kernels.reset_launches()
    with torch.no_grad():
        model(left, left.flip(2), iters=1, test_mode=False)
    assert kernels.LAUNCHES["cost_volume_parts"] == 1 and kernels.LAUNCHES["conv3x3"] > 0
    for train in (False, True):     # at 64x96 the ViT's few tokens take dense attention
        model.train(train)
        kernels.reset_launches()
        with dropout_generator(torch.Generator(cuda).manual_seed(1)):
            init_disp, preds = model(left, left.flip(2), iters=1, test_mode=False, train=train)
        assert len(preds) == 1 and preds[0].requires_grad
        assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES


def _conv_inputs(cuda, seed, c, f, spatial, dtype):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(2, c, *spatial, device=cuda, generator=g).to(dtype)
    w = torch.randn(f, c, 3, 3, device=cuda, generator=g) / math.sqrt(9 * c)
    return x, w, 0.1 * torch.randn(f, device=cuda, generator=g)


def _assert_conv_close(out, ref):
    o, r = out.float(), ref.float()
    tol = 1e-4
    if out.dtype == torch.bfloat16:
        a = torch.maximum(o.abs(), r.abs()).clamp_min(2.0 ** -126)
        tol = torch.exp2(torch.floor(torch.log2(a)) - 7) + 1e-4
    assert bool(((o - r).abs() <= tol).all()), float((o - r).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,f,h,w", [
    (136, 127, 7, 45), (200, 70, 9, 33), (128, 256, 4, 32), (16, 8, 3, 5),
    (168, 64, 13, 80),     # C % 64 != 0, F <= 64 (64-channel weight tiles), H % 4 != 0
    (128, 96, 6, 130),     # W % 64 == 2: a third column tile of two pixels
    (384, 256, 46, 80),    # the 1/16-level z/r conv
    (256, 128, 23, 40),    # the hourglass level's width, ragged H
])
def test_conv3x3_kernel(cuda, dtype, c, f, h, w):
    x, wt, bias = _conv_inputs(cuda, 5, c, f, (h, w), dtype)
    kernels.reset_launches()
    out = kernels.conv3x3(x, wt, bias)
    assert out.dtype == dtype and out.shape == (2, f, h, w)
    assert kernels.LAUNCHES["conv3x3"] == 1
    _assert_conv_close(out, kernels.conv3x3_plain(x, wt, bias))
    _assert_conv_close(kernels.conv3x3(x, wt), kernels.conv3x3_plain(x, wt))


@pytest.mark.parametrize("f", [127, 64])
@pytest.mark.parametrize("rows", [1, 2])
@pytest.mark.parametrize("w", [45, 48])
def test_conv3x3_kernel_every_tile(cuda, monkeypatch, f, rows, w):
    """Each bf16 tile (128 or 64 output channels by 2 or 4 rows; the wrapper
    picks the rows from the shape and the card's SM count) at ragged C, F
    and H, with 2-byte (W = 45) and 16-byte (W = 48) input loads, on the 5D
    volume read in place."""
    monkeypatch.setattr(kernels, "conv3x3_rows", lambda *args: rows)
    x, wt, bias = _conv_inputs(cuda, 16, 200, f, (3, 7, w), torch.bfloat16)
    vol = x[:, :, ::2]
    out = kernels.conv3x3(vol, wt, bias)
    bn = 64 if f <= 64 else 128
    assert kernels.CONV3X3_LAUNCHED == dict(
        grid=(-(-f // bn), -(-7 // (2 * rows)) * -(-w // 64), 2 * vol.shape[2]),
        tile=(2 * rows, 64, bn))
    want = torch.stack([kernels.conv3x3_plain(vol[:, :, d], wt, bias)
                        for d in range(vol.shape[2])], dim=2)
    _assert_conv_close(out, want)


@pytest.mark.parametrize("bn", [128, 64])
@pytest.mark.parametrize("w", [45, 48])
def test_conv3x3_fp32_kernel_every_tile(cuda, monkeypatch, bn, w):
    """Each fp32 tile (128 output channels by 2 rows, 64 by 4: the rows are
    128 / BN) at ragged C, F and H, with 4-byte (W = 45) and 16-byte (W =
    48) input loads, on the 5D volume read in place."""
    monkeypatch.setattr(kernels, "_pack_rows", lambda *args: bn)
    x, wt, bias = _conv_inputs(cuda, 21, 200, 127, (3, 7, w), torch.float32)
    vol = x[:, :, ::2]
    out = kernels.conv3x3(vol, wt, bias)
    rows = 128 // bn
    assert kernels.CONV3X3_LAUNCHED == dict(
        grid=(-(-127 // bn), -(-7 // (2 * rows)) * -(-w // 64), 2 * vol.shape[2]),
        tile=(2 * rows, 64, bn))
    want = torch.stack([kernels.conv3x3_plain(vol[:, :, d], wt, bias)
                        for d in range(vol.shape[2])], dim=2)
    _assert_conv_close(out, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_kernel_reads_the_5d_volume_in_place(cuda, dtype):
    """(B, C, D, H, W): D folded into the batch through the strides, and a
    view that is not contiguous (every other depth slice)."""
    x, wt, bias = _conv_inputs(cuda, 6, 168, 168, (6, 7, 20), dtype)
    for vol in (x, x[:, :, ::2]):
        out = kernels.conv3x3(vol, wt, bias)
        assert out.shape == (2, 168, vol.shape[2], 7, 20)
        want = torch.stack([kernels.conv3x3_plain(vol[:, :, d], wt, bias)
                            for d in range(vol.shape[2])], dim=2)
        _assert_conv_close(out, want)


def test_conv3x3_errors_raise_and_do_not_fall_back(cuda):
    x, wt, _ = _conv_inputs(cuda, 7, 128, 64, (4, 8), torch.bfloat16)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="packed"):
        kernels.conv3x3(x, wt, None, kernels.pack_conv3x3_weight(wt, torch.float32))
    with pytest.raises(ValueError, match="contiguous"):
        kernels.conv3x3(x.transpose(2, 3), wt.transpose(2, 3).contiguous())
    # A launch the C side refuses (C padded to 144, a multiple of 16 but not
    # of the 64-channel chunk): its CUDA error raises, and nothing is counted.
    packed = torch.zeros(1, 3, 9, 64, 48, device=cuda, dtype=torch.bfloat16)
    out = torch.empty(2, 64, 4, 8, device=cuda, dtype=torch.bfloat16)
    err = kernels._lib("conv3x3")(x.data_ptr(), packed.data_ptr(), 0, out.data_ptr(), 2, 1,
                                  x.stride(0), 0, x.stride(1), out.stride(0), 0, out.stride(1),
                                  128, 4, 8, 64, 144, 64, 64, 2, 1, (ctypes.c_int * 6)(),
                                  torch.cuda.current_stream().cuda_stream)
    with pytest.raises(RuntimeError, match="CUDA error"):
        kernels._check("conv3x3", err)
    assert kernels.LAUNCHES["conv3x3"] == 0


@pytest.mark.parametrize("mixed_precision", [False, True])
def test_model_with_conv3x3_counts_its_launches(cuda, monkeypatch, mixed_precision):
    """vits with pallas_conv3x3: 36 routed convs outside the loop and 16 per
    iteration (the counts the CPU tests hold against the JAX package), all
    launched on the card; the disparity agrees with the cuDNN model's."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = ModelConfig(vit_size="vits", max_disp=64, mixed_precision=mixed_precision)
    ref = FoundationStereo(cfg, device=cuda, seed=0)
    model = FoundationStereo(cfg.replace(pallas_conv3x3=True), device=cuda, seed=0)
    g = torch.Generator(device=cuda).manual_seed(8)
    left, right = (torch.rand(1, 64, 96, 3, device=cuda, generator=g) * 255 for _ in range(2))
    kernels.reset_launches()
    with torch.no_grad():
        got = model(left, right, iters=2, test_mode=True)
    assert kernels.LAUNCHES["conv3x3"] == 36 + 2 * 16
    with torch.no_grad():
        want = ref(left, right, iters=2, test_mode=True)
    diff = (got - want).abs()
    if mixed_precision:      # the whole-path tolerance of chip_smoke.py
        assert float(diff.mean()) <= 0.05 and float(torch.quantile(diff.flatten(), 0.99)) <= 0.5
    else:                    # the CPU parity bound (TF32 off: fp32 throughout)
        assert float(diff.max()) <= 1e-2


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    return torch.device("cuda:0"), torch.device("cuda:1")


def _one_card_mesh(cuda, n=4):
    return make_mesh(devices=[cuda] * n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_haloed_cost_volume_kernel(cuda, dtype):
    """4 shards of 24 columns at D = 40: shard 0's halo is all zeros, shard
    1's reaches past shard 0 into them."""
    g = torch.Generator(device=cuda).manual_seed(9)
    l, r = (_uniform(g, 2, 64, 7, 96, device=cuda).to(dtype) for _ in range(2))
    rp = _uniform(g, 2, 12, 7, 96, device=cuda).to(dtype)
    atol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
    kernels.reset_launches()
    for j in range(4):
        lj = l[..., 24 * j:24 * (j + 1)].contiguous()
        gk, rk = kernels.cost_volume_parts_haloed(lj, r, rp, 40, 8, 24 * j, out_dtype=dtype)
        gp, rpp = cost_volume.cost_volume_parts_haloed(lj, r, rp, 40, 8, 24 * j, out_dtype=dtype)
        torch.testing.assert_close(gk.float(), gp.float(), rtol=0, atol=atol)
        assert torch.equal(rk, rpp)
    assert kernels.LAUNCHES["cost_volume_parts_haloed"] == 4
    got = sharded.cost_volume_parts_sharded(l, r, rp, 40, 8, _one_card_mesh(cuda), out_dtype=dtype)
    want = kernels.cost_volume_parts(l, r, rp, 40, 8, out_dtype=dtype)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_offset_lookup_kernel(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(10)
    b, h, w, c, d = 2, 5, 40, 7, 24
    geo = [x.to(dtype).contiguous()
           for x in sampler.pool_last_axis(_uniform(g, b, h, w, c, d, device=cuda), 3)]
    corr = [x.to(dtype).contiguous()
            for x in sampler.pool_last_axis(_uniform(g, b, h, w, w, device=cuda), 3)]
    disp = torch.rand(b, h, w, device=cuda, generator=g) * 3 * d - d
    atol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
    for x0 in (10, 30):
        cut = [t[:, :, x0:x0 + 10].contiguous() for t in geo]
        cutc = [t[:, :, x0:x0 + 10].contiguous() for t in corr]
        dj = disp[..., x0:x0 + 10].contiguous()
        out = kernels.disparity_lookup_shard(cut, cutc, dj, 4, x0, out_dtype=dtype)
        ref = sampler.disparity_lookup(cut, cutc, dj, 4, out_dtype=dtype, x_offset=x0)
        torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=atol)
    kernels.reset_launches()
    got = sharded.disparity_lookup_sharded(
        sharded.shard_pyramids(geo, corr, _one_card_mesh(cuda)), disp, 4, dtype)
    assert kernels.LAUNCHES["disparity_lookup_shard"] == 4
    assert torch.equal(got, kernels.disparity_lookup(geo, corr, disp, 4, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_sliced_attention_kernel(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(11)
    qkv = torch.randn(2, 1100, 3, 8, 64, device=cuda, generator=g).to(dtype)
    for h0 in (0, 2, 6):
        out = kernels.flash_attention_heads(qkv, 0.125, h0, 2)
        ref = kernels.flash_attention_plain(qkv[:, :, :, h0:h0 + 2].float(), 0.125)
        if dtype == torch.float32:
            torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
        else:
            err = (out.float() - ref).abs()
            assert float(err.max()) <= 2 * _bf16_ulp(float(ref.abs().max()))
            assert float(err.mean()) <= _bf16_ulp(float(ref.abs().mean()))
    kernels.reset_launches()
    got = sharded.flash_attention_sharded(qkv, 0.125, _one_card_mesh(cuda))
    assert kernels.LAUNCHES["flash_attention_heads"] == 4
    assert torch.equal(got, kernels.flash_attention(qkv, 0.125))


def _attention_rank(rank: int, url: str, out) -> None:
    """A rank of a data 1 x spatial 2 ``RankMesh`` on card 0 over ``gloo``:
    ``flash_attention_sharded`` (its 4 heads of 8, then the heads gather)
    against K3 on all heads, in fp32 and in bf16, with its launches."""
    from foundationstereo_torch.parallel import distributed, spatial

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    distributed.initialize(url, 2, rank, backend="gloo")
    try:
        mesh = make_mesh()
        res = {}
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device=dev).manual_seed(16)
            qkv = torch.randn(2, 1100, 3, 8, 64, device=dev, generator=g).to(dtype)
            kernels.reset_launches()
            spatial.reset_exchanges()
            got = sharded.flash_attention_sharded(qkv, 0.125, mesh)
            launches, exchanges = dict(kernels.LAUNCHES), dict(spatial.EXCHANGES)
            res[str(dtype)] = dict(equal=bool(torch.equal(got, kernels.flash_attention(qkv, 0.125))),
                                   launches=launches, exchanges=exchanges)
        torch.save(res, out / f"rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def test_sharded_attention_over_two_ranks_sharing_one_card(cuda, tmp_path):
    """Under a ``RankMesh`` of spatial 2 each rank attends over its heads
    (one K3s launch, no K3) and the heads gather gives it K3's output bit
    for bit, in fp32 and in bf16."""
    import torch.multiprocessing as mp

    url = (tmp_path / "rendezvous").absolute().as_uri()
    mp.spawn(_attention_rank, args=(url, tmp_path), nprocs=2, join=True)
    for rank in range(2):
        res = torch.load(tmp_path / f"rank{rank}.pt")
        for dtype, r in res.items():
            assert r["equal"], (rank, dtype)
            assert r["launches"]["flash_attention_heads"] == 1, (rank, dtype, r["launches"])
            assert r["launches"]["flash_attention"] == 0, (rank, dtype, r["launches"])
            assert r["exchanges"]["heads"] == 1, (rank, dtype, r["exchanges"])


def test_sharded_kernels_on_distinct_cards(two_cards):
    """Shards on two cards, gathered on the first: the same bits as one card."""
    c0, c1 = two_cards
    mesh = make_mesh(devices=[c0, c1, c0, c1])
    g = torch.Generator(device=c0).manual_seed(12)
    l, r = (_uniform(g, 1, 64, 5, 96, device=c0).bfloat16() for _ in range(2))
    rp = _uniform(g, 1, 12, 5, 96, device=c0).bfloat16()
    got = sharded.cost_volume_parts_sharded(l, r, rp, 40, 8, mesh, out_dtype=torch.bfloat16)
    want = kernels.cost_volume_parts(l, r, rp, 40, 8, out_dtype=torch.bfloat16)
    assert got[0].device == c0 and all(torch.equal(a, b) for a, b in zip(got, want))
    qkv = torch.randn(2, 1100, 3, 4, 64, device=c0, generator=g).bfloat16()
    assert torch.equal(sharded.flash_attention_sharded(qkv, 0.125, mesh),
                       kernels.flash_attention(qkv, 0.125))


def test_model_on_the_second_card_while_the_first_is_current(two_cards):
    """The wrappers launch on their tensors' device and stream, not the
    current device's."""
    c0, c1 = two_cards
    cfg = ModelConfig(vit_size="vits", max_disp=64, mixed_precision=True)
    g = torch.Generator().manual_seed(13)
    left, right = (torch.rand(1, 64, 96, 3, generator=g) * 255 for _ in range(2))
    outs = []
    for dev in (c0, c1):
        model = FoundationStereo(cfg, device=dev, seed=0)
        kernels.reset_launches()
        with torch.cuda.device(c0), torch.no_grad():
            outs.append(model(left.to(dev), right.to(dev), iters=2, test_mode=True).cpu())
        torch.cuda.synchronize(dev)
        assert kernels.LAUNCHES["cost_volume_parts"] == 1
        assert kernels.LAUNCHES["disparity_lookup"] == 2
    assert bool(torch.isfinite(outs[1]).all())
    diff = (outs[0] - outs[1]).abs()
    assert float(diff.mean()) <= 0.05 and float(torch.quantile(diff.flatten(), 0.99)) <= 0.5


def test_conv3x3_on_the_second_card(two_cards):
    """K4 sets its shared-memory attribute on each device it launches on."""
    c0, c1 = two_cards
    for dev in (c0, c1):
        x, wt, bias = _conv_inputs(dev, 14, 128, 128, (6, 20), torch.bfloat16)
        out = kernels.conv3x3(x, wt, bias)
        torch.cuda.synchronize(dev)
        assert out.device == dev
        _assert_conv_close(out, kernels.conv3x3_plain(x, wt, bias))


def test_model_under_a_one_card_mesh(cuda):
    """The sharded forward on one card (4 shards) equals the unsharded one
    and launches the sharded kernels only; the mesh turns K4 off."""
    cfg = ModelConfig(vit_size="vits", max_disp=64, mixed_precision=True, pallas_conv3x3=True)
    model = FoundationStereo(cfg, device=cuda, seed=0)
    g = torch.Generator(device=cuda).manual_seed(15)
    left, right = (torch.rand(1, 64, 128, 3, device=cuda, generator=g) * 255 for _ in range(2))
    kernels.reset_launches()
    with mesh_context(_one_card_mesh(cuda)), torch.no_grad():
        got = model(left, right, iters=2, test_mode=True)
    assert kernels.LAUNCHES == {"cost_volume_parts": 0, "cost_volume_parts_haloed": 4,
                                "disparity_lookup": 0, "disparity_lookup_shard": 8,
                                "flash_attention": 0, "flash_attention_heads": 0, "conv3x3": 0}
    model_ref = FoundationStereo(cfg.replace(pallas_conv3x3=False), device=cuda, seed=0)
    with torch.no_grad():
        want = model_ref(left, right, iters=2, test_mode=True)
    assert torch.equal(got, want)
