"""The three CUDA kernels' plain twins against the JAX package, on the CPU
(the kernels themselves are held against these twins on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``).

The JAX side runs as its own tests run it here: Pallas kernels in interpret
mode, next to the XLA forms. Tolerances: 1e-5 where both sides compute in
fp32 (summation order only); where the outputs are stored in bf16, 1 bf16
ulp at the largest magnitude (inputs kept in [-1, 1], so 2^-8).
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from foundationstereo_torch.models import dinov2 as tdino
from foundationstereo_torch.models.cost_filter import Classifier
from foundationstereo_torch.ops import cost_volume as tcv
from foundationstereo_torch.ops import kernels
from foundationstereo_torch.ops import sampler as tsam
from foundationstereo_tpu.models.dinov2 import chunked_attention
from foundationstereo_tpu.ops import cost_volume as jcv
from foundationstereo_tpu.ops import pallas_kernels as jpk
from foundationstereo_tpu.ops import sampler as jsam

TOL32 = dict(rtol=1e-5, atol=1e-5)
TOL16 = dict(rtol=0, atol=2.0 ** -8)


def _cv_inputs(rng, b=1, h=3, w=24, c=16, p=4):
    l, r = (rng.uniform(-1, 1, (b, h, w, c)).astype(np.float32) for _ in range(2))
    rp = rng.uniform(-1, 1, (b, h, w, p)).astype(np.float32)
    return l, r, rp


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_cost_volume_twin_matches_pallas_and_xla(rng, out_dtype):
    d, g = 10, 4
    l, r, rp = _cv_inputs(rng)
    gwc, rps = tcv.cost_volume_parts(_nchw(l), _nchw(r), _nchw(rp), d, g,
                                     out_dtype=getattr(torch, out_dtype))
    jg, jr = jpk.build_cost_volume_pallas(
        jnp.asarray(l), jnp.asarray(r), jnp.asarray(rp), jnp.asarray(rp), d, g,
        interpret=True, return_parts=True, out_dtype=getattr(jnp, out_dtype))
    tol = TOL32 if out_dtype == "float32" else TOL16
    # port (B, C', D, H, W) vs kernel layout (B, D, H, C', W)
    np.testing.assert_allclose(gwc.float().permute(0, 2, 3, 1, 4).numpy(),
                               np.asarray(jg, np.float32), **tol)
    np.testing.assert_array_equal(rps.float().permute(0, 2, 3, 1, 4).numpy(),
                                  np.asarray(jr, np.float32))
    if out_dtype == "float32":   # and the XLA forms (B, D, H, W, C')
        xg = jcv.build_gwc_volume(jnp.asarray(l), jnp.asarray(r), d, g)
        np.testing.assert_allclose(gwc.permute(0, 2, 3, 4, 1).numpy(), np.asarray(xg), **TOL32)
        xc = jcv.build_concat_volume(jnp.asarray(rp), jnp.asarray(rp), d)
        np.testing.assert_array_equal(rps.permute(0, 2, 3, 4, 1).numpy(),
                                      np.asarray(xc)[..., rp.shape[-1]:])


def _lookup_inputs(rng, b=1, h=4, w=32, c=6, d=16, levels=3):
    geo = rng.uniform(-1, 1, (b, h, w, c, d)).astype(np.float32)
    corr = rng.uniform(-1, 1, (b, h, w, w)).astype(np.float32)
    disp = rng.uniform(-d, 2 * d, (b, h, w)).astype(np.float32)
    disp[0, 0, :8] = np.arange(8)                                   # exact integers
    disp[0, 1, :6] = [-100.0, 1e4, -0.5, d - 0.5, d - 1, -1.0]      # extremes, straddles
    return (jsam.pool_last_axis(jnp.asarray(geo), levels - 1),
            jsam.pool_last_axis(jnp.asarray(corr), levels - 1), disp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lookup_twin_matches_pallas_and_xla(rng, dtype):
    radius = 4
    gp, cp, disp = _lookup_inputs(rng)
    jdt = getattr(jnp, dtype)
    gk, ck = jpk.to_kernel_layout(gp, cp, dtype=jdt)
    want = np.asarray(jpk.disparity_lookup_pallas_pre(
        gk, ck, jnp.asarray(disp), radius, interpret=True, out_dtype=jdt), np.float32)
    tdt = getattr(torch, dtype)
    geo = [torch.from_numpy(np.array(g)).to(tdt) for g in gp]
    corr = [torch.from_numpy(np.array(c)).to(tdt) for c in cp]
    got = tsam.disparity_lookup(geo, corr, torch.from_numpy(disp), radius, out_dtype=tdt)
    got = np.moveaxis(got.float().numpy(), 1, -1)                     # (B, H, W, F)
    np.testing.assert_allclose(got, want, **(TOL32 if dtype == "float32" else TOL16))
    if dtype == "float32":
        xla = np.asarray(jsam.disparity_lookup(gp, cp, jnp.asarray(disp), radius))
        np.testing.assert_allclose(got, xla, **TOL32)


def test_attention_twin_matches_chunked_and_dense(rng):
    b, n, h, hd = 1, 1100, 2, 64                   # ragged N > 1024
    qkv = rng.standard_normal((b, n, 3, h, hd)).astype(np.float32)
    scale = 1.0 / math.sqrt(hd)
    got = kernels.flash_attention_plain(torch.from_numpy(qkv), scale).numpy()
    q, k, v = (jnp.asarray(qkv[:, :, i]) for i in range(3))
    np.testing.assert_allclose(got, np.asarray(chunked_attention(q, k, v, scale)), **TOL32)
    logits = np.einsum("bnhd,bmhd->bhnm", qkv[:, :, 0], qkv[:, :, 1]) * scale
    w = np.exp(logits - logits.max(-1, keepdims=True))
    dense = np.einsum("bhnm,bmhd->bnhd", w / w.sum(-1, keepdims=True), qkv[:, :, 2])
    np.testing.assert_allclose(got, dense, **TOL32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_attention_matches_jax(rng, dtype):
    """vit_attention="chunked": the online softmax over key chunks, against
    the JAX package's chunked_attention at a ragged N (1100 = 2 x 512 + 76)."""
    b, n, h, hd = 1, 1100, 2, 64
    qkv = rng.standard_normal((b, n, 3, h, hd)).astype(np.float32)
    scale = 1.0 / math.sqrt(hd)
    tq = torch.from_numpy(qkv).to(getattr(torch, dtype))
    got = tdino.chunked_attention(tq, scale)
    assert got.dtype == tq.dtype
    q, k, v = (jnp.asarray(tq[:, :, i].float().numpy()).astype(getattr(jnp, dtype))
               for i in range(3))
    want = np.asarray(chunked_attention(q, k, v, scale).astype(getattr(jnp, dtype)), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want,
                               **(TOL32 if dtype == "float32" else TOL16))


@pytest.mark.parametrize("attention, use_kernel, want", [
    # the kernel's wrapper, which on a CPU tensor takes its twin
    ("auto", True, ["flash_attention", "flash_attention_plain"]),
    ("flash", False, ["flash_attention_plain"]),
    ("chunked", True, ["chunked_attention"]),
    ("dense", True, [])])
def test_vit_attention_routes(monkeypatch, attention, use_kernel, want):
    """Over 1024 tokens the ViT attention calls what ``vit_attention`` names."""
    calls = []
    for mod, name in ((kernels, "flash_attention"), (kernels, "flash_attention_plain"),
                      (tdino, "chunked_attention")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    torch.manual_seed(0)
    attn = tdino.Attention(128, 2, attention, use_kernel)
    with torch.no_grad():
        out = attn(torch.randn(1, 1025, 128))
    assert out.shape == (1, 1025, 128)
    assert calls == want


def test_cpu_wrappers_take_the_twins_and_count_nothing(rng):
    kernels.reset_launches()
    l, r, rp = _cv_inputs(rng)
    a = kernels.cost_volume_parts(_nchw(l), _nchw(r), _nchw(rp), 6, 4)
    b = tcv.cost_volume_parts(_nchw(l), _nchw(r), _nchw(rp), 6, 4)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    gp, cp, disp = _lookup_inputs(rng)
    geo = [torch.from_numpy(np.array(g)) for g in gp]
    corr = [torch.from_numpy(np.array(c)) for c in cp]
    assert torch.equal(kernels.disparity_lookup(geo, corr, torch.from_numpy(disp), 2),
                       tsam.disparity_lookup(geo, corr, torch.from_numpy(disp), 2))
    qkv = torch.from_numpy(rng.standard_normal((1, 40, 3, 2, 64)).astype(np.float32))
    assert torch.equal(kernels.flash_attention(qkv, 0.125),
                       kernels.flash_attention_plain(qkv, 0.125))
    assert not any(kernels.LAUNCHES.values())


@pytest.mark.parametrize("pairs, blocks", [
    (32, 928),     # K3: 2 views x 16 heads, 28 full query tiles and a 1-row one each
    (8, 232),      # a K3s shard: 4 heads
    (6, 174),      # a vitb K3s shard: 3 of 12 heads
])
def test_flash_attention_blocks_at_the_main_shapes(pairs, blocks):
    """The bf16 attention kernel's grid at the main path's 5377 tokens."""
    assert kernels.FLASH_QUERY_ROWS == 192
    assert kernels.flash_attention_blocks(5377, pairs) == blocks


def test_kernel_sources_and_build_paths():
    for src in kernels.SOURCES.values():
        text = (kernels.CSRC / src).read_text()
        assert ("Replaces the TPU kernel" in text or "Replaces no TPU kernel" in text)
        assert "extern \"C\"" in text
    paths = {kernels._lib_path(src) for src in kernels.SOURCES.values()}
    assert len(paths) == len(kernels.SOURCES) == 5
    assert all(p.parent == kernels.BUILD_DIR for p in paths)


def _k6_inputs(rng, dt, b=2, c=5, dhw=(6, 9, 11)):
    x = torch.from_numpy(rng.uniform(-1, 1, (b, c) + dhw).astype(np.float32))
    w = torch.from_numpy((rng.uniform(-1, 1, (1, c, 7, 7, 7)) / math.sqrt(c * 343)).astype(np.float32))
    bias = torch.from_numpy(rng.uniform(-0.1, 0.1, (1,)).astype(np.float32))
    return x, w.to(dt), bias.to(dt)


@pytest.mark.parametrize("padding", [(3, 3, 3), (3, 3, 0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv3d_1out_twin_is_the_conv_on_rounded_operands(rng, dtype, padding):
    """K6's operator on the CPU: ``F.conv3d`` in fp32 on the operands rounded
    to the weight's dtype, rounded once (the input may come in fp32 and is
    rounded as it is read), the classifier's ``[:, 0]``; within 1 bf16 ulp of
    the bf16 ``F.conv3d`` the classifier ran before, and of the JAX
    package's XLA conv on the same rounded operands (1e-5 in fp32)."""
    dt = getattr(torch, dtype)
    x, w, bias = _k6_inputs(rng, dt)
    kernels.reset_launches()
    got = kernels.conv3d_1out(x, w, bias, list(padding))
    want = F.conv3d(x.to(dt).float(), w.float(), bias.float(), padding=padding)[:, 0].to(dt)
    assert got.dtype == dt and got.shape == want.shape and torch.equal(got, want)
    assert not any(kernels.LAUNCHES.values())
    old = F.conv3d(x.to(dt), w, bias, padding=padding)[:, 0]
    tol = TOL32 if dtype == "float32" else dict(rtol=2.0 ** -8, atol=1e-6)
    torch.testing.assert_close(got.float(), old.float(), **tol)
    xj = jnp.asarray(x.to(dt).float().numpy())
    wj = jnp.asarray(w.float().numpy())
    ref = jax.lax.conv_general_dilated(xj, wj, (1, 1, 1), [(p, p) for p in padding],
                                       precision=jax.lax.Precision.HIGHEST)[:, 0]
    ref = torch.from_numpy(np.array(ref + float(bias.float()[0]))).to(dt).float()
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(), **tol)


def test_classifier_routes_its_last_conv_and_keeps_f_conv3d_under_grad(rng, monkeypatch):
    """A ``Classifier`` with ``k6_on`` calls K6 once and gives the logits of
    one without; the gradient route (``k6_on`` off, as the model's forward
    sets it wherever gradients flow) calls no K6, and its gradient to
    ``classifier.2.weight`` is ``F.conv3d``'s; K6 refuses a weight that
    needs a backward."""
    calls = []
    op = kernels.conv3d_1out
    monkeypatch.setattr(kernels, "conv3d_1out", lambda *a: calls.append(a[3]) or op(*a))
    clf = Classifier(28, torch.bfloat16).eval()
    for p in clf.parameters():
        p.data.uniform_(-0.1, 0.1, generator=torch.Generator().manual_seed(3))
    x = torch.from_numpy(rng.uniform(-1, 1, (1, 28, 6, 8, 10)).astype(np.float32))
    with torch.no_grad():
        plain = clf(x)
        clf.k6_on = True
        kernel = clf(x)
        clf.k6_on = False
    assert calls == [[3, 3, 3]] and kernel.shape == (1, 6, 8, 10) and kernel.dtype == plain.dtype
    torch.testing.assert_close(kernel.float(), plain.float(), rtol=2.0 ** -8, atol=1e-6)
    calls.clear()
    g = torch.from_numpy(rng.standard_normal((1, 6, 8, 10)).astype(np.float32))
    (clf(x).float() * g).sum().backward()
    got = clf[2].weight.grad.clone()
    clf.zero_grad()
    conv = clf[2]
    y = F.conv3d(clf[1](clf[0](x)).to(torch.bfloat16), conv.weight.to(torch.bfloat16),
                 conv.bias.to(torch.bfloat16), padding=3)[:, 0]
    (y.float() * g).sum().backward()
    assert calls == [] and torch.equal(got, conv.weight.grad)
    clf.k6_on = True
    with pytest.raises(ValueError, match="no backward"):
        clf(x)


def test_conv3d_1out_grid_at_the_main_shapes():
    """K6's grid at the classifier's (B, 104, 184, 320) outputs: 5 column
    tiles of 64, 12 row tiles of 16 (the last of 8 rows), 13 depth tiles of
    8 per image; a spatial-2 rank's 160 columns take 3 column tiles."""
    assert kernels.CONV3D_1OUT_TILE == (8, 16, 64)
    assert kernels.conv3d_1out_grid(1, 104, 184, 320) == (5, 12, 13)
    assert kernels.conv3d_1out_grid(4, 104, 184, 320) == (5, 12, 52)
    assert kernels.conv3d_1out_grid(1, 104, 184, 160) == (3, 12, 13)
