"""The port's whole forward and its rules, against the JAX package on the CPU.

* Bridge: JAX variables -> the port's state_dict with nothing unmapped either
  way, and back through the JAX package's own importer to the identical tree.
* Whole forward: the port (through the kernel wrappers, which take their
  twins on the CPU, and through the plain ops) against
  ``FoundationStereo.apply(test_mode=True, iters=2)`` at vits, max_disp 64,
  64x96, fp32: max abs <= 1e-2 px, the bound the stitched parity test uses;
  in bf16 with bf16 pyramids against the JAX mixed-precision forward: mean
  <= 0.05 px, p99 <= 0.5 px;
  and the port under a data 1 x spatial 2 mesh of CPU devices (the sharded
  build and lookup, W/4 = 24, D = 16 > W_local = 12) against the same.
* The ViT attention's "auto" is resolved at every call from the active mesh;
  "flash_sharded" without a mesh raises.
* Rules: the port imports no JAX, its entry points need CUDA unless asked
  for the CPU, and CPU tensors launch no kernel.
"""

from __future__ import annotations

import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from foundationstereo_torch.convert.from_jax import (
    flatten_variables,
    jax_to_state_dict,
    load_jax_variables,
)
from foundationstereo_torch.inference.demo import run_pair
from foundationstereo_torch.models import dinov2 as tdino
from foundationstereo_torch.models.foundation_stereo import FoundationStereo
from foundationstereo_torch.ops import kernels, sharded
from foundationstereo_torch.parallel import make_mesh, mesh_context
from foundationstereo_tpu.convert.torch_import import import_reference_checkpoint
from foundationstereo_tpu.models.foundation_stereo import FoundationStereo as JaxFoundationStereo
from test_torch_modules import CFG, JCFG, random_variables

H, W, ITERS = 64, 96, 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_model():
    rng = np.random.default_rng(0)
    left, right = (rng.uniform(0, 255, (1, H, W, 3)).astype(np.float32) for _ in range(2))
    jm = JaxFoundationStereo(JCFG)
    v = random_variables(jm, left, right, iters=1, test_mode=True)
    fwd = jax.jit(lambda vv, a, b: jm.apply(vv, a, b, iters=ITERS, test_mode=True))
    return v, fwd, left, right, np.asarray(fwd(v, left, right))


def test_bridge_round_trip(jax_model):
    v = jax_model[0]
    sd, unmapped = jax_to_state_dict(flatten_variables(v), CFG)
    assert not unmapped
    model = FoundationStereo(CFG, device="cpu")
    assert set(sd) == set(model.state_dict())
    load_jax_variables(model, v)
    back = {k: t.numpy() for k, t in model.state_dict().items()}
    v2, report = import_reference_checkpoint(back, v, JCFG)
    assert not report["missing_torch"] and not report["shape_mismatch"]
    assert not report["unmapped_flax"] and not report["unused_torch"]
    flat, flat2 = flatten_variables(v), flatten_variables(v2)
    assert set(flat) == set(flat2)
    for k in flat:
        np.testing.assert_array_equal(flat2[k], flat[k], err_msg=k)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_whole_forward_matches_jax(jax_model, use_pallas):
    v, _, left, right, want = jax_model
    model = FoundationStereo(CFG.replace(use_pallas=use_pallas), device="cpu")
    load_jax_variables(model, v)
    kernels.reset_launches()
    with torch.no_grad():
        got = model(torch.from_numpy(left), torch.from_numpy(right), iters=ITERS,
                    test_mode=True).numpy()
    assert got.shape == want.shape == (1, H, W)
    assert float(np.abs(got - want).max()) <= 1e-2
    assert not any(kernels.LAUNCHES.values())


def _count_calls(monkeypatch, module, names):
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(module, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(module, name, wrapped)
    return calls


def test_whole_forward_on_a_mesh_matches_jax(jax_model, monkeypatch):
    """Under a data 1 x spatial 2 mesh of CPU devices: the sharded build (one
    call per shard) and lookup (one per shard and iteration) instead of K1 and
    K2, no 3x3 conv kernel though ``pallas_conv3x3`` is set (as in the JAX
    package under a mesh), and the JAX forward's disparity."""
    v, _, left, right, want = jax_model
    model = FoundationStereo(CFG.replace(pallas_conv3x3=True), device="cpu")
    load_jax_variables(model, v)
    calls = _count_calls(monkeypatch, kernels, [
        "cost_volume_parts", "cost_volume_parts_haloed", "disparity_lookup",
        "disparity_lookup_shard", "conv3x3"])
    mesh = make_mesh(devices=[torch.device("cpu")] * 2)
    with mesh_context(mesh), torch.no_grad():
        got = model(torch.from_numpy(left), torch.from_numpy(right), iters=ITERS,
                    test_mode=True).numpy()
    assert calls == {"cost_volume_parts": 0, "cost_volume_parts_haloed": 2, "disparity_lookup": 0,
                     "disparity_lookup_shard": 2 * ITERS, "conv3x3": 0}
    assert got.shape == want.shape == (1, H, W)
    assert float(np.abs(got - want).max()) <= 1e-2


def test_vit_attention_auto_resolves_per_call(monkeypatch):
    """One module: "flash" outside a mesh, "flash_sharded" (the kernel on each
    head shard) under a mesh of two, "flash" again after it."""
    calls = _count_calls(monkeypatch, kernels, ["flash_attention", "flash_attention_heads"])
    torch.manual_seed(0)
    attn = tdino.Attention(128, 2, "auto")
    x = torch.randn(1, 1025, 128)
    with torch.no_grad():
        want = attn(x)
        with mesh_context(make_mesh(devices=[torch.device("cpu")] * 2)):
            got = attn(x)
        attn(x)
    assert calls == {"flash_attention": 2, "flash_attention_heads": 2}
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert tdino.resolve_vit_attention("chunked") == "chunked"
    with pytest.raises(ValueError, match="not in"):
        tdino.resolve_vit_attention("flash_shard")


def test_flash_sharded_needs_a_mesh():
    """The JAX config value is accepted; without a mesh the call raises, as
    the JAX package's shard_map does."""
    attn = tdino.Attention(128, 2, "flash_sharded")
    with pytest.raises(ValueError, match="needs a mesh"), torch.no_grad():
        attn(torch.randn(1, 1025, 128))
    with pytest.raises(ValueError, match="needs a mesh"):
        sharded.flash_attention_sharded(torch.zeros(1, 4, 3, 2, 64), 0.125, None)


def test_run_pair_pads_and_unpads(jax_model):
    """run_pair on a 60x90 pair: replicate-pad to 64x96, forward, unpad --
    the JAX package's demo path for one pair."""
    v, fwd, *_ = jax_model
    from foundationstereo_tpu.ops.pad import InputPadder

    rng = np.random.default_rng(1)
    left, right = (rng.uniform(0, 255, (1, 60, 90, 3)).astype(np.float32) for _ in range(2))
    padder = InputPadder(left.shape, divis_by=32)
    lp, rp = padder.pad(left, right)
    want = np.asarray(padder.unpad(fwd(v, lp, rp)[..., None]))[..., 0]
    model = FoundationStereo(CFG, device="cpu")
    load_jax_variables(model, v)
    got = run_pair(model, left[0], right[0], iters=ITERS).numpy()
    assert got.shape == (1, 60, 90)
    assert float(np.abs(got - want).max()) <= 1e-2


def test_mixed_precision_forward_runs_on_cpu(jax_model):
    """bf16 compute with bf16 pyramids (the card's configuration) on the CPU
    against the JAX package's mixed-precision forward with the same weights:
    finite fp32 disparities of the right shape within the card's kernel-path
    limits, mean |d| <= 0.05 px and p99 <= 0.5 px (measured on the CPU: max
    0.043, mean 0.011, p99 0.034)."""
    v, _, left, right, _ = jax_model
    jm = JaxFoundationStereo(JCFG.replace(mixed_precision=True))
    want = np.asarray(jax.jit(lambda vv, a, b: jm.apply(vv, a, b, iters=ITERS, test_mode=True))(
        v, left, right))
    model = FoundationStereo(CFG.replace(mixed_precision=True, bf16_pyramids=True), device="cpu")
    load_jax_variables(model, v)
    with torch.no_grad():
        disp = model(torch.from_numpy(left), torch.from_numpy(right), iters=ITERS, test_mode=True)
    assert disp.shape == want.shape == (1, H, W) and disp.dtype == torch.float32
    assert bool(torch.isfinite(disp).all())
    err = np.abs(disp.numpy() - want)
    assert float(err.mean()) <= 0.05 and float(np.percentile(err, 99)) <= 0.5, (
        float(err.mean()), float(np.percentile(err, 99)))


def test_forward_signature_is_the_jax_call():
    """Names, order and defaults of the JAX package's ``__call__``."""
    def params(fn):
        return [(p.name, p.kind, p.default) for p in inspect.signature(fn).parameters.values()]

    assert params(FoundationStereo.forward) == params(JaxFoundationStereo.__call__)


def test_forward_takes_the_jax_call_positionally():
    """``model(l, r, iters, True, False)`` is the keyword call; ``train`` that
    disagrees with the module's mode (``train()`` / ``eval()``) raises."""
    model = FoundationStereo(CFG, device="cpu")
    rng = np.random.default_rng(3)
    left, right = (torch.from_numpy(rng.uniform(0, 255, (1, H, W, 3)).astype(np.float32))
                   for _ in range(2))
    with torch.no_grad():
        got = model(left, right, 1, True, False)
        want = model(left, right, iters=1, test_mode=True, low_memory=False)
        assert torch.equal(got, want)
        for kwargs in ({"train": True}, {"test_mode": True, "train": True}):
            with pytest.raises(ValueError, match="eval mode"):
                model(left, right, iters=1, **kwargs)
        model.train()
        with pytest.raises(ValueError, match="train mode"):
            model(left, right, iters=1, test_mode=True)


def test_entry_points_need_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FoundationStereo(CFG)


def test_port_imports_no_jax():
    """Every module of the port (``parallel/distributed.py`` among them), chip_smoke.py
    (which its dp phase's spawned ranks import again), tools/k4_timing.py,
    tools/k3_timing.py, tools/k1_k2_timing.py and tools/op_overhead.py, in a
    fresh interpreter where importing jax or the JAX package raises."""
    code = r"""
import importlib, importlib.util, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "foundationstereo_tpu"):
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, Block())
import foundationstereo_torch, chip_smoke
names = [m.name for m in pkgutil.walk_packages(foundationstereo_torch.__path__,
                                               "foundationstereo_torch.")]
for n in names:
    importlib.import_module(n)
for tool in ("k4_timing", "k3_timing", "k1_k2_timing", "op_overhead"):
    spec = importlib.util.spec_from_file_location(tool, f"tools/{tool}.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "foundationstereo_tpu")]
assert not bad, bad
assert "foundationstereo_torch.parallel.distributed" in names
assert "foundationstereo_torch.parallel.spatial" in names
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.strip()) >= 20


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_k4_timing_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "tools/k4_timing.py"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


def test_k3_timing_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "tools/k3_timing.py"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


def test_k1_k2_timing_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "tools/k1_k2_timing.py"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


def test_op_overhead_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "tools/op_overhead.py"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
