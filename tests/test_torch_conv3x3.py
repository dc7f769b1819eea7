"""The 3x3 conv kernel's plain twin (K4) and its routing, against the JAX
package on the CPU.

* Kernel: ``kernels.conv3x3_plain`` (and the wrapper, which takes it on CPU
  tensors) against ``conv3x3_pallas(..., interpret=True)`` and
  ``lax.conv_general_dilated`` at the JAX package's test shapes plus a
  ragged F = 127. fp32: 1e-5 (summation order). bf16 (both sides multiply
  bf16 values exactly and accumulate in fp32, then round once): 1 bf16 ulp
  of the larger magnitude + 1e-5 for the fp32 sums taken in another order.
* Routing: with ``pallas_conv3x3`` the port sends exactly the convs through
  K4 that the JAX package sends through ``conv3x3_pallas`` under
  ``pallas_conv3x3_scope``: equal counts outside the refinement loop and
  per iteration, at vits and at vitl.

The whole forward with K4 routing against the JAX forward is in
``test_torch_inference.py``, where it shares the JAX compile of the
hierarchical test.
"""

from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from foundationstereo_torch.models import foundation_stereo as tfs
from foundationstereo_torch.models.layers import Conv2d, Conv3d
from foundationstereo_torch.ops import kernels
from foundationstereo_tpu.config import ModelConfig as JaxModelConfig
from foundationstereo_tpu.models import layers as jlayers
from foundationstereo_tpu.models.foundation_stereo import FoundationStereo as JaxFoundationStereo
from foundationstereo_tpu.models.update import BasicSelectiveMultiUpdateBlock as JaxUpdateBlock
from foundationstereo_tpu.ops.conv3x3 import conv3x3_pallas
from test_torch_modules import CFG

SHAPES = [(1, 6, 10, 8, 16), (2, 5, 7, 384, 128), (1, 4, 9, 128, 64), (1, 5, 11, 136, 127)]


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_twin_matches_pallas_and_lax(shape, dtype):
    b, h, w, c, f = shape
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    k = (rng.standard_normal((3, 3, c, f)) * 0.05).astype(np.float32)
    bias = (0.1 * rng.standard_normal(f)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    xj, kj = jnp.asarray(x, jdt), jnp.asarray(k, jdt)
    pallas = np.asarray(conv3x3_pallas(xj, kj, interpret=True).astype(jnp.float32))
    lax32 = np.asarray(jax.lax.conv_general_dilated(
        xj.astype(jnp.float32), kj.astype(jnp.float32), (1, 1), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    lax = np.asarray(jnp.asarray(lax32).astype(jdt).astype(jnp.float32))

    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).to(tdt)
    wt = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))     # (F, C, 3, 3)
    got = kernels.conv3x3_plain(xt, wt)
    assert got.dtype == tdt and got.shape == (b, f, h, w)
    assert torch.equal(kernels.conv3x3(xt, wt), got)                        # wrapper on CPU
    got = got.float().numpy().transpose(0, 2, 3, 1)
    for want in (pallas, lax):
        err = np.abs(got - want)
        if dtype == "float32":
            assert float(err.max()) <= 1e-5
        else:
            assert bool((err <= _bf16_ulp(np.maximum(np.abs(got), np.abs(want))) + 1e-5).all())

    # Bias: added in fp32 before the one rounding.
    got_b = kernels.conv3x3_plain(xt, wt, torch.from_numpy(bias)).float().numpy()
    want_b = lax32.transpose(0, 3, 1, 2) + bias[:, None, None]
    tol = 1e-5 if dtype == "float32" else _bf16_ulp(np.maximum(np.abs(got_b), np.abs(want_b))) + 1e-5
    assert bool((np.abs(got_b - want_b) <= tol).all())


def test_plain_twin_folds_depth_into_the_batch():
    """A (B, C, D, H, W) volume: D is a batch axis, as the kernel reads it."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 130, 3, 5, 6, generator=g)
    wt = torch.randn(70, 130, 3, 3, generator=g) * 0.05
    got = kernels.conv3x3(x, wt)
    want = torch.stack([kernels.conv3x3_plain(x[:, :, d], wt) for d in range(3)], dim=2)
    assert got.shape == (2, 70, 3, 5, 6)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def _unpack_bf16(packed: torch.Tensor) -> np.ndarray:
    """A plain inverse of the bf16 packed layout, from its definition: entry
    (f, c, tap) of the (Fp, Cp, 9) weight sits in tile [f // T, c // 64,
    tap], row n = f % T, at 16-byte group position ((c % 64) // 8) ^ (n % 8),
    element c % 8. Returns the bits (int16)."""
    nf, nc, taps, t, k = packed.shape
    assert (taps, k) == (9, 64) and t in (64, 128)
    bits = packed.view(torch.int16).numpy()
    f = np.arange(nf * t)[:, None, None]
    c = np.arange(nc * 64)[None, :, None]
    tap = np.arange(9)[None, None, :]
    n = f % t
    q = ((c % 64) // 8) ^ (n % 8)
    return bits[f // t, c // 64, tap, n, q * 8 + c % 8]


@pytest.mark.parametrize("f", [64, 127, 256])
@pytest.mark.parametrize("c", [128, 168, 320, 512])
def test_packed_bf16_weight_inverts_bit_for_bit(c, f):
    """The wgmma kernel's weight tiles: T = 64 output channels where F <= 64,
    else 128; C padded to a multiple of 64 and F to one of T, with zeros."""
    g = torch.Generator().manual_seed(c + f)
    w = torch.randn(f, c, 3, 3, generator=g)
    packed = kernels.pack_conv3x3_weight(w, torch.bfloat16)
    t = 64 if f <= 64 else 128
    fp, cp = -(-f // t) * t, -(-c // 64) * 64
    assert packed.shape == (fp // t, cp // 64, 9, t, 64) and packed.dtype == torch.bfloat16
    assert packed.is_contiguous()
    back = _unpack_bf16(packed)                                     # (Fp, Cp, 9), every element once
    want = w.to(torch.bfloat16).reshape(f, c, 9).view(torch.int16).numpy()
    assert np.array_equal(back[:f, :c], want)
    assert not back[f:].any() and not back[:, c:].any()


def _unpack_fp32(packed: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """A plain inverse of the fp32 packed layout, from its definition: the hi
    (h = 0) and lo (h = 1) parts of entry (f, c, tap) of the (Fp, Cp, 9)
    weight sit in tile [f // T, c // 16, tap, h] at group q = (c % 16) // 4,
    row n = f % T, element c % 4. Returns the bits (int32) of hi and lo."""
    nf, nc, taps, two, groups, t, k = packed.shape
    assert (taps, two, groups, k) == (9, 2, 4, 4) and t in (64, 128)
    bits = packed.view(torch.int32).numpy()
    f = np.arange(nf * t)[:, None, None]
    c = np.arange(nc * 16)[None, :, None]
    tap = np.arange(9)[None, None, :]
    return tuple(bits[f // t, c // 16, tap, h, (c % 16) // 4, f % t, c % 4] for h in (0, 1))


@pytest.mark.parametrize("f", [64, 127, 168, 256])
@pytest.mark.parametrize("c", [16, 168, 512])
def test_packed_fp32_weight_inverts_bit_for_bit(c, f):
    """The three-pass TF32 kernel's weight tiles: T = 64 where F <= 64 or
    64-channel tiles pad F less (168), else 128; C padded to a multiple of
    16 and F to one of T, with zeros; hi and lo are ``kernels.tf32_split``
    of the fp32 weight."""
    g = torch.Generator().manual_seed(c + f)
    w = torch.randn(f, c, 3, 3, generator=g)
    packed = kernels.pack_conv3x3_weight(w, torch.float32)
    t = 64 if f in (64, 168) else 128
    fp, cp = -(-f // t) * t, -(-c // 16) * 16
    assert packed.shape == (fp // t, cp // 16, 9, 2, 4, t, 4) and packed.dtype == torch.float32
    assert packed.is_contiguous()
    hi, lo = _unpack_fp32(packed)                                   # (Fp, Cp, 9) each
    want_hi, want_lo = (p.reshape(f, c, 9).view(torch.int32).numpy() for p in kernels.tf32_split(w))
    assert np.array_equal(hi[:f, :c], want_hi) and np.array_equal(lo[:f, :c], want_lo)
    for part in (hi, lo):
        assert not part[f:].any() and not part[:, c:].any()


@pytest.mark.parametrize("f,h,w,images,rows", [
    (512, 184, 320, 1, 2),      # gru04: 920 blocks of 4 rows, 7 waves (14 of 2 rows)
    (512, 92, 160, 1, 2),       # gru08: 3 waves of 4 rows beat 5 of 2
    (256, 46, 80, 1, 1),        # gru16 z/r: 48 blocks of 4 rows leave the card 2/3 idle
    (168, 23, 40, 13, 1),       # the hourglass (1, 3, 3) conv: 3 waves of 2 rows beat 2 of 4
    (64, 184, 320, 1, 2),       # mask.0 (64-channel tiles)
])
def test_conv3x3_rows_fills_the_card(f, h, w, images, rows):
    assert kernels.conv3x3_rows(f, h, w, images, 132) == rows


@pytest.mark.parametrize("k,stride,pad,mode", [
    ((1, 3, 3), 1, (0, 1, 1), "fold"),
    ((3, 3, 3), 1, 1, "taps"),
    ((3, 3, 3), (2, 1, 1), (1, 1, 1), "taps"),
    ((3, 3, 3), 2, 1, None),                    # spatial stride 2: not eligible
    ((1, 3, 3), 1, (0, 1, 1), None),            # C = 64 < 128: not eligible (below)
])
def test_conv3d_forms_route_and_match(k, stride, pad, mode, monkeypatch):
    cin = 64 if mode is None and k[0] == 1 else 128
    m = Conv3d(cin, 64, k, stride, pad)
    m.enable_k4()
    assert m.k4 == mode
    calls = []
    conv = kernels.conv3x3
    monkeypatch.setattr(kernels, "conv3x3", lambda *a: calls.append(1) or conv(*a))
    x = torch.randn(2, cin, 5, 6, 7, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        torch.testing.assert_close(m(x), m._conv_forward(x, m.weight, m.bias), rtol=0, atol=1e-5)
    # one K4 call for the folded (1, 3, 3) conv, one per depth tap for the others
    assert len(calls) == {"fold": 1, "taps": k[0], None: 0}[mode]
    m.k4_on = False                         # as the model's forward sets it where it takes grads
    with torch.no_grad():
        m(x)
    assert len(calls) == {"fold": 1, "taps": k[0], None: 0}[mode], "K4 ran with k4_on off"


@pytest.mark.parametrize("shape,eligible", [
    ((128, 64, 3, 1, 1, 1), True), ((127, 64, 3, 1, 1, 1), False),
    ((128, 63, 3, 1, 1, 1), False), ((128, 64, 3, 2, 1, 1), False),
    ((128, 64, 3, 1, 0, 1), False), ((128, 128, 3, 1, 1, 2), False),
    ((128, 64, 1, 1, 0, 1), False), ((320, 127, 3, 1, 1, 1), True),
])
def test_conv2d_eligibility_is_the_jax_rule(shape, eligible):
    c, f, k, s, p, g = shape
    m = Conv2d(c, f, k, s, p, groups=g)
    m.enable_k4()
    assert m.k4 is eligible
    with jlayers.pallas_conv3x3_scope(True):
        assert jlayers._pallas3x3_eligible((k, k), (s, s), (p, p), (1, 1), g, c, f) is eligible


# ---------------------------------------------------------------------------
# Routing parity: routed-call counts in both packages
# ---------------------------------------------------------------------------


def _jax_counts(monkeypatch, vit):
    """(outside the refinement loop, per iteration) conv3x3_pallas calls,
    counted while ``init`` traces the forward under ``jax.eval_shape`` (no
    compute; ``init`` runs the same forward as ``apply``). The loop's scan
    body traces more than once, so the per-iteration count comes from the
    update block traced alone and the outside count from the calls made
    outside it."""
    import foundationstereo_tpu.ops.conv3x3 as jconv

    calls = []

    def counting(x, kernel, out_dtype=None, interpret=False, row_block=None):
        frame, inside = sys._getframe(1), False
        while frame is not None and not inside:
            inside = isinstance(frame.f_locals.get("self"), JaxUpdateBlock)
            frame = frame.f_back
        calls.append(inside)
        return jnp.zeros(x.shape[:3] + (kernel.shape[-1],), out_dtype or x.dtype)

    monkeypatch.setattr(jconv, "conv3x3_pallas", counting)
    cfg = JaxModelConfig(max_disp=64, vit_size=vit, mixed_precision=False, use_pallas=False)
    img = jax.ShapeDtypeStruct((1, 64, 96, 3), jnp.float32)
    model = JaxFoundationStereo(cfg)
    key = jax.random.PRNGKey(0)
    with jlayers.pallas_conv3x3_scope(True, interpret=True):
        jax.eval_shape(lambda a, b: model.init(key, a, b, iters=1, test_mode=True), img, img)
        outside = calls.count(False)

        h4, w4, hd = 16, 24, 128
        net = [jax.ShapeDtypeStruct((1, h4 // s, w4 // s, hd), jnp.float32) for s in (1, 2, 4)]
        att = [jax.ShapeDtypeStruct((1, h4 // s, w4 // s, 1), jnp.float32) for s in (1, 2, 4)]
        corr = jax.ShapeDtypeStruct((1, h4, w4, 4 * 29 * 9), jnp.float32)
        disp = jax.ShapeDtypeStruct((1, h4, w4, 1), jnp.float32)
        calls.clear()
        jax.eval_shape(lambda *a: JaxUpdateBlock(hd, 3).init(key, *a), net, net, corr, disp, att)
        per_iter = len(calls)
    return outside, per_iter


def _port_counts(monkeypatch, vit):
    """(outside, per iteration) routed K4 calls of the port, from forwards
    on the CPU at 1 and 2 iterations (weights left at the modules' own
    initialisers: the counts do not depend on them)."""
    n = [0]
    wrapped = kernels.conv3x3

    def counting(*args, **kwargs):
        n[0] += 1
        return wrapped(*args, **kwargs)

    monkeypatch.setattr(kernels, "conv3x3", counting)
    monkeypatch.setattr(tfs.FoundationStereo, "init_weights", lambda self, gen: None)
    model = tfs.FoundationStereo(CFG.replace(vit_size=vit, pallas_conv3x3=True), device="cpu")
    img = torch.zeros(1, 64, 96, 3)
    counts = []
    for iters in (1, 2):
        n[0] = 0
        with torch.no_grad():
            model(img, img, iters=iters, test_mode=True)
        counts.append(n[0])
    per_iter = counts[1] - counts[0]
    return counts[0] - per_iter, per_iter


# The counts the card's launch check uses (chip_smoke.py K4_OUTSIDE/K4_PER_ITER).
EXPECTED = {"vits": (36, 16), "vitl": (53, 16)}


@pytest.mark.parametrize("vit", ["vits", "vitl"])
def test_routed_convs_match_jax(monkeypatch, vit):
    jax_counts = _jax_counts(monkeypatch, vit)
    port_counts = _port_counts(monkeypatch, vit)
    assert port_counts == jax_counts == EXPECTED[vit]


def test_routing_needs_use_pallas_and_the_flag(monkeypatch):
    monkeypatch.setattr(tfs.FoundationStereo, "init_weights", lambda self, gen: None)

    def routed(cfg):
        model = tfs.FoundationStereo(cfg, device="cpu")
        return sum(bool(getattr(m, "k4", False)) for m in model.modules())

    assert routed(CFG) == 0                                        # flag off (the default)
    assert routed(CFG.replace(pallas_conv3x3=True, use_pallas=False)) == 0
    assert routed(CFG.replace(pallas_conv3x3=True)) > 0
