"""Module parity for the feature stack: the transposed-conv weight layout,
``Feature`` (EdgeNeXt + ViT + DPT), ``ContextNetDino``, ``Stem2`` and the
ViT/DPT over more than 1024 tokens (the flash-attention path), against the
JAX package with bridged weights, on the CPU in fp32.

Tolerance as in test_torch_modules.py: max abs <= 1e-4 x max(1, max |JAX|).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from foundationstereo_torch.convert.from_jax import _to_torch_layout, load_jax_variables
from foundationstereo_torch.models import dpt as tdpt
from foundationstereo_torch.models import extractor as tex
from foundationstereo_torch.models import layers as tl
from foundationstereo_tpu.models import dpt as jdpt
from foundationstereo_tpu.models import extractor as jex
from foundationstereo_tpu.models import layers as jl
from test_torch_modules import CFG, JCFG, assert_close, random_variables, t


@pytest.mark.parametrize("ndim,k,s,p", [(2, 4, 2, 1), (2, 4, 4, 0), (2, 2, 2, 0), (2, 3, 2, 1),
                                        (3, 4, 2, 1)])
def test_deconv_weight_inverse_against_conv_transpose(rng, ndim, k, s, p):
    """The bridge's inverse of the importer's deconv transform, checked by
    running a real nn.ConvTranspose{2,3}d against the JAX ConvTranspose
    (which flips its kernel at call time) -- not by shapes alone."""
    shape = (2,) + (5,) * ndim + (3,)
    x = rng.standard_normal(shape).astype(np.float32)
    jm = jl.ConvTranspose(4, k, s, p)
    v = random_variables(jm, jnp.asarray(x))
    want = jm.apply(v, jnp.asarray(x))
    cls = tl.ConvTranspose2d if ndim == 2 else tl.ConvTranspose3d
    tm = cls(3, 4, k, s, p)
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(_to_torch_layout("deconv", np.array(v["params"]["kernel"]))))
        tm.bias.copy_(torch.from_numpy(np.array(v["params"]["bias"])))
        got = tm(t(x))
    assert_close(got, want)


def test_feature_stem2_and_context(rng):
    b, h, w = 2, 64, 96
    x = rng.standard_normal((b, h, w, 3)).astype(np.float32)
    jm = jex.Feature(JCFG)
    v = random_variables(jm, jnp.asarray(x))
    jouts, jvit = jm.apply(v, jnp.asarray(x))
    tm = tex.Feature(CFG).eval()
    load_jax_variables(tm, v, CFG, "feature", "feature")
    with torch.no_grad():
        touts, tvit = tm(t(x))
    assert_close(tvit, jvit)
    for a, bb in zip(touts, jouts):
        assert_close(a, bb)

    js = jex.Stem2()
    vs = random_variables(js, jnp.asarray(x), seed=1)
    ts = tex.Stem2().eval()
    load_jax_variables(ts, vs, CFG, "stem_2", "stem_2")
    with torch.no_grad():
        assert_close(ts(t(x)), js.apply(vs, jnp.asarray(x)))

    vit_feat = np.asarray(jvit)
    jc = jex.ContextNetDino(JCFG)
    vc = random_variables(jc, jnp.asarray(x), jnp.asarray(vit_feat), seed=2)
    jout = jc.apply(vc, jnp.asarray(x), jnp.asarray(vit_feat))
    tc = tex.ContextNetDino(CFG).eval()
    load_jax_variables(tc, vc, CFG, "cnet", "cnet")
    with torch.no_grad():
        tout = tc(t(x), t(vit_feat))
    for tpair, jpair in zip(tout, jout):
        for a, bb in zip(tpair, jpair):
            assert_close(a, bb)


def test_vit_dpt_over_1024_tokens(rng):
    """448x448 -> 32x32 patches + cls = 1025 tokens: the port takes the
    flash-attention path (its twin on the CPU), the JAX side its dense form."""
    x = rng.standard_normal((1, 448, 448, 3)).astype(np.float32)
    jm = jdpt.DepthAnythingFeature("vits", attention="dense", out_hw=(32, 48))
    v = random_variables(jm, jnp.asarray(x))
    want = jm.apply(v, jnp.asarray(x))["out"]
    tm = tdpt.DepthAnythingFeature("vits").eval()
    load_jax_variables(tm, v, CFG, "feature/dino", "feature.dino")
    with torch.no_grad():
        got = tm(t(x), out_hw=(32, 48))
    assert_close(got, want)
