"""Module parity: the port's cost-filter and update modules against the JAX
package's, with the same weights carried across by the bridge
(``foundationstereo_torch/convert/from_jax.py``), on the CPU in fp32.

JAX variables are drawn at random from the shapes ``init`` would make (no
init compile). Tolerance: max abs difference <= 1e-4 x max(1, max |JAX|)
-- both sides compute in fp32 and differ only in summation order, which
deep conv stacks accumulate to ~1e-6 relative.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from foundationstereo_torch.config import ModelConfig
from foundationstereo_torch.convert.from_jax import flatten_variables as flatten
from foundationstereo_torch.convert.from_jax import load_jax_variables
from foundationstereo_torch.models import cost_filter as tcf
from foundationstereo_torch.models import update as tup
from foundationstereo_torch.models.extractor import feature_dims
from foundationstereo_tpu.config import ModelConfig as JaxModelConfig
from foundationstereo_tpu.models import cost_filter as jcf
from foundationstereo_tpu.models import update as jup

CFG = ModelConfig(max_disp=64, vit_size="vits", mixed_precision=False, bf16_pyramids=False)
JCFG = JaxModelConfig(max_disp=64, vit_size="vits", mixed_precision=False, use_pallas=False)


def random_variables(module, *args, seed=0, **kwargs):
    """Random flax variables with the shapes ``module.init`` would make:
    kernels ~ N(0, 1/fan_in), biases and means ~ 0.1 N, variances in
    [0.5, 1.5], scales / layer scales / temperatures ~ 1 + 0.1 N."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name in ("pos_embed", "cls_token"):
            x = 0.02 * rng.standard_normal(s.shape)
        elif name == "kernel":
            x = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "var":
            x = rng.uniform(0.5, 1.5, s.shape)
        elif name in ("bias", "mean"):
            x = 0.1 * rng.standard_normal(s.shape)
        else:
            x = 1.0 + 0.1 * rng.standard_normal(s.shape)
        return jnp.asarray(x.astype(np.float32))

    return jax.tree_util.tree_map_with_path(fill, shapes)


def assert_close(got: torch.Tensor, want, channel_last_to_first: bool = True):
    want = np.asarray(want, np.float32)
    if channel_last_to_first:
        want = np.moveaxis(want, -1, 1)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= 1e-4 * max(1.0, float(np.abs(want).max())), err


def t(x):
    """Channel-last numpy -> channel-first torch."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def test_corr_stem_parts_and_dense(rng):
    b, d, h, w, g, p = 1, 8, 6, 10, 8, 12
    gwc = rng.standard_normal((b, d, h, g, w)).astype(np.float32)       # kernel layout
    rps = rng.standard_normal((b, d, h, p, w)).astype(np.float32)
    lp = rng.standard_normal((b, h, w, p)).astype(np.float32)
    jm = jcf.CorrStem(28)
    v = random_variables(jm, (jnp.asarray(gwc), jnp.asarray(rps), jnp.asarray(lp)))
    want = jm.apply(v, (jnp.asarray(gwc), jnp.asarray(rps), jnp.asarray(lp)))  # (B, D, H, W, F)
    tm = tcf.CorrStem(g + 2 * p, 28).eval()
    load_jax_variables(tm, v, CFG, "corr_stem", "corr_stem")
    gwc_t = torch.from_numpy(gwc).permute(0, 3, 1, 2, 4)                # (B, G, D, H, W)
    rps_t = torch.from_numpy(rps).permute(0, 3, 1, 2, 4)
    with torch.no_grad():
        parts = tm((gwc_t, rps_t, t(lp)))
        dense = tm(torch.cat([gwc_t, t(lp)[:, :, None].expand(-1, -1, d, -1, -1), rps_t], 1))
    assert_close(parts, want)
    assert_close(dense, want)


def test_hourglass_and_classifier(rng):
    b, d, h, w, c = 1, CFG.max_disp // 4, 16, 24, 28
    dims = feature_dims(CFG)
    x = rng.standard_normal((b, d, h, w, c)).astype(np.float32)
    feats = [rng.standard_normal((b, h >> i, w >> i, dims[i])).astype(np.float32)
             for i in range(4)]
    jm = jcf.Hourglass(c, CFG.max_disp)
    jfeats = [jnp.asarray(f) for f in feats]
    v = random_variables(jm, jnp.asarray(x), jfeats)
    want = jm.apply(v, jnp.asarray(x), jfeats)
    tm = tcf.Hourglass(c, CFG.max_disp, dims).eval()
    load_jax_variables(tm, v, CFG, "cost_agg", "cost_agg")
    with torch.no_grad():
        got = tm(t(x), [t(f) for f in feats])
    assert_close(got, want)

    jc = jcf.Classifier(c)
    vc = random_variables(jc, jnp.asarray(x), seed=1)
    tc = tcf.Classifier(c).eval()
    load_jax_variables(tc, vc, CFG, "classifier", "classifier")
    with torch.no_grad():
        got = tc(t(x))                                                  # (B, D, H, W)
    assert_close(got, jc.apply(vc, jnp.asarray(x)), channel_last_to_first=False)


def test_update_block(rng):
    b, h, w = 1, 8, 12
    n_corr = CFG.corr_levels * (CFG.volume_dim + 1) * (2 * CFG.corr_radius + 1)
    net = [rng.standard_normal((b, h >> i, w >> i, 128)).astype(np.float32) for i in range(3)]
    inp = [rng.standard_normal((b, h >> i, w >> i, 128)).astype(np.float32) for i in range(3)]
    att = [rng.uniform(0, 1, (b, h >> i, w >> i, 1)).astype(np.float32) for i in range(3)]
    corr = rng.standard_normal((b, h, w, n_corr)).astype(np.float32)
    disp = rng.uniform(0, 16, (b, h, w, 1)).astype(np.float32)
    jm = jup.BasicSelectiveMultiUpdateBlock(128, 3)
    jargs = ([jnp.asarray(x) for x in net], [jnp.asarray(x) for x in inp], jnp.asarray(corr),
             jnp.asarray(disp), [jnp.asarray(x) for x in att])
    v = random_variables(jm, *jargs)
    jnet, jmask, jdelta = jm.apply(v, *jargs)
    tm = tup.BasicSelectiveMultiUpdateBlock(128, 3, n_corr).eval()
    load_jax_variables(tm, v, CFG, "refine/update_block", "update_block")
    with torch.no_grad():
        tnet, tmask, tdelta = tm([t(x) for x in net], [t(x) for x in inp], t(corr), t(disp),
                                 [t(x) for x in att])
    for a, bb in zip(tnet, jnet):
        assert_close(a, bb)
    assert_close(tmask, jmask)
    assert_close(tdelta, jdelta)


@pytest.mark.parametrize("kind", ["batch", "instance", "group", "layer"])
def test_norms(rng, kind):
    """The four norms with their eps (batch 1e-5, instance 1e-5, group C/8
    groups 1e-5, layer over channels 1e-6) against the JAX package's."""
    from foundationstereo_torch.models import layers as tl
    from foundationstereo_tpu.models import layers as jl

    x = rng.standard_normal((2, 5, 6, 16)).astype(np.float32)
    jm = {"batch": jl.BatchNorm(), "instance": jl.InstanceNorm(),
          "group": jl.GroupNorm(num_groups=2), "layer": jl.LayerNorm2d()}[kind]
    tm = tl.LayerNorm2d(16) if kind == "layer" else tl.make_norm(kind, 16)
    if kind == "instance":
        v = {}
    else:
        v = random_variables(jm, jnp.asarray(x))
        leaves = {k.split("/")[-1]: np.array(a) for k, a in flatten(v).items()}
        with torch.no_grad():
            tm.weight.copy_(torch.from_numpy(leaves["scale"]))
            tm.bias.copy_(torch.from_numpy(leaves["bias"]))
            if kind == "batch":
                tm.running_mean.copy_(torch.from_numpy(leaves["mean"]))
                tm.running_var.copy_(torch.from_numpy(leaves["var"]))
    with torch.no_grad():
        assert_close(tm(t(x)), jm.apply(v, jnp.asarray(x)))


def test_bridge_rejects_a_partial_tree(rng):
    jm = jcf.Classifier(28)
    x = jnp.asarray(rng.standard_normal((1, 4, 4, 4, 28)).astype(np.float32))
    v = random_variables(jm, x)
    v = {"params": {k: p for k, p in v["params"].items() if k != "out"},
         "batch_stats": v["batch_stats"]}
    with pytest.raises(ValueError, match="bridge mismatch"):
        load_jax_variables(tcf.Classifier(28), v, CFG, "classifier", "classifier")
