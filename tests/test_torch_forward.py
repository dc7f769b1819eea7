"""The port's whole forward and its rules, against the JAX package on the CPU.

* Bridge: JAX variables -> the port's state_dict with nothing unmapped either
  way, and back through the JAX package's own importer to the identical tree.
* Whole forward: the port (through the kernel wrappers, which take their
  twins on the CPU, and through the plain ops) against
  ``FoundationStereo.apply(test_mode=True, iters=2)`` at vits, max_disp 64,
  64x96, fp32: max abs <= 1e-2 px, the bound the stitched parity test uses.
* Rules: the port imports no JAX, its entry points need CUDA unless asked
  for the CPU, and CPU tensors launch no kernel.
"""

from __future__ import annotations

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
from foundationstereo_torch.models.foundation_stereo import FoundationStereo
from foundationstereo_torch.ops import kernels
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
        got = model(torch.from_numpy(left), torch.from_numpy(right), iters=ITERS).numpy()
    assert got.shape == want.shape == (1, H, W)
    assert float(np.abs(got - want).max()) <= 1e-2
    assert kernels.LAUNCHES == {name: 0 for name in kernels.SOURCES}


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


def test_mixed_precision_forward_runs_on_cpu():
    """bf16 compute with bf16 pyramids (the card's configuration) on the CPU:
    finite disparities of the right shape."""
    model = FoundationStereo(CFG.replace(mixed_precision=True, bf16_pyramids=True), device="cpu")
    rng = np.random.default_rng(2)
    left, right = (torch.from_numpy(rng.uniform(0, 255, (1, H, W, 3)).astype(np.float32))
                   for _ in range(2))
    with torch.no_grad():
        disp = model(left, right, iters=1)
    assert disp.shape == (1, H, W) and disp.dtype == torch.float32
    assert bool(torch.isfinite(disp).all())


def test_entry_points_need_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FoundationStereo(CFG)


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, in a fresh interpreter
    where importing jax or the JAX package raises."""
    code = r"""
import importlib, pkgutil, sys

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
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "foundationstereo_tpu")]
assert not bad, bad
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
