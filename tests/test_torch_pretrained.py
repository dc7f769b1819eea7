"""The port's checkpoint loader (``foundationstereo_torch/pretrained.py``)
against the JAX package's, on the CPU (~70 s serially, on one torch thread).

* A reference-layout ``.pth`` (``{"model": state_dict}``) written from a
  seeded port model, with every vestigial key the reference carries
  (``tests/test_parity_full_forward.py:VESTIGIAL``) and a sibling
  ``cfg.yaml``, loads through ``foundationstereo_tpu.pretrained`` (the JAX
  importer, ``convert/torch_import.py``) and through the port's loader; the
  two forwards (vits, max_disp 64, 64x96, fp32, 1 iteration) agree to
  1e-2 px, the bound of ``tests/test_torch_forward.py``. The JAX loader's
  starting variables (its jitted ``model.init``, which every imported
  weight replaces, and whose XLA compile would take most of this file's
  time) are NaN arrays of the shapes ``model.init`` gives, so a leaf the
  importer left behind would show in the forward.
* The directory route round-trips bit for bit: ``save_pretrained``, the
  latest step and an earlier one, the EMA file, the overrides.
* An unknown key, a missing key, a shape mismatch, a missing path and a
  missing EMA file each raise; the default device raises without a card.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import yaml

import jax

from foundationstereo_torch.config import ModelConfig
from foundationstereo_torch.models.foundation_stereo import FoundationStereo
from foundationstereo_torch.pretrained import VESTIGIAL, from_pretrained, save_pretrained
from foundationstereo_tpu import pretrained as jax_pretrained

CFG = ModelConfig(max_disp=64, vit_size="vits", mixed_precision=False, bf16_pyramids=False)
H, W = 64, 96


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread for this file: its tensors are small, and the
    suite runs several files at once, where a thread pool per process
    oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# One made-up key per vestigial pattern, as a reference checkpoint holds them.
VESTIGIAL_KEYS = {
    "stem_4.0.weight": (32, 3, 3, 3),
    "context_zqr_convs.0.weight": (384, 128, 3, 3),
    "feature.dino.depth_anything.pretrained.mask_token": (1, 384),
    "feature.dino.depth_anything.depth_head.scratch.refinenet4.resConfUnit1.conv1.weight":
        (64, 64, 3, 3),
    "feature.dino.depth_anything.depth_head.scratch.output_conv2.0.weight": (32, 32, 3, 3),
    "cnet.down.0.weight": (128, 128, 1, 1),
    "cnet.norm.weight": (128,),
    "cnet.layer1.0.norm3.weight": (64,),
}


def _state_dict(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _reference_checkpoint(model) -> dict:
    """The model's state dict with the reference's extra keys: every
    vestigial module's, and batch norm's counters."""
    gen = torch.Generator().manual_seed(1)
    sd = _state_dict(model)
    sd.update({k: torch.randn(s, generator=gen) for k, s in VESTIGIAL_KEYS.items()})
    sd.update({k.replace("running_mean", "num_batches_tracked"): torch.tensor(7)
               for k in list(sd) if k.endswith("running_mean")})
    assert all(any(v in k for k in sd) for v in VESTIGIAL)
    return sd


@pytest.fixture(scope="module")
def model():
    return FoundationStereo(CFG, device="cpu", seed=0)


def _nan_variables(jmodel, cfg, seed=0):
    z = np.zeros((1, H, W, 3), np.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(seed), z, z, iters=1,
                                                test_mode=True))
    return jax.tree.map(lambda s: np.full(s.shape, np.nan, s.dtype), shapes)


def test_pth_loads_as_the_jax_importer_loads_it(model, tmp_path, monkeypatch):
    d = tmp_path / "ref"
    d.mkdir()
    torch.save({"model": _reference_checkpoint(model), "global_step": 1}, d / "model_best.pth")
    (d / "cfg.yaml").write_text(yaml.safe_dump(
        {"vit_size": "vits", "max_disp": 64, "mixed_precision": False, "bf16_pyramids": False,
         "valid_iters": 1}))

    port, cfg = from_pretrained(d / "model_best.pth", device="cpu")
    assert cfg == CFG.replace(valid_iters=1)
    for k, v in model.state_dict().items():
        assert torch.equal(port.state_dict()[k], v), k

    monkeypatch.setattr(jax_pretrained, "_init_variables", _nan_variables)
    jmodel, variables, jcfg = jax_pretrained.from_pretrained(d / "model_best.pth")
    assert (jcfg.vit_size, jcfg.max_disp, jcfg.mixed_precision) == ("vits", 64, False)
    rng = np.random.default_rng(0)
    left = rng.uniform(0, 255, (1, H, W, 3)).astype(np.float32)
    right = rng.uniform(0, 255, (1, H, W, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, a, b: jmodel.apply(v, a, b, iters=1, test_mode=True))(
        variables, left, right))
    assert np.isfinite(want).all()
    with torch.no_grad():
        got = port(torch.from_numpy(left), torch.from_numpy(right), iters=1,
                   test_mode=True).numpy()
    assert got.shape == want.shape == (1, H, W)
    assert float(np.abs(got - want).max()) <= 1e-2


@pytest.fixture
def no_init(monkeypatch):
    """Loads replace every weight: skip the initialisers of the models
    ``from_pretrained`` builds (the saved model was initialised)."""
    monkeypatch.setattr(FoundationStereo, "init_weights", lambda self, gen: None)


def test_directory_round_trip(model, tmp_path, no_init):
    """save_pretrained at steps 3 and 5 and an EMA file at step 3: the latest
    step, step 3, its EMA weights and the overrides come back bit for bit."""
    sd3 = _state_dict(model)
    save_pretrained(tmp_path, model, CFG, step=3)
    ema = {k: v * 0.5 if v.is_floating_point() else v for k, v in sd3.items()}
    torch.save({"model": ema, "global_step": 3}, tmp_path / "3_ema.pt")
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    sd5 = _state_dict(model)
    save_pretrained(tmp_path, model, CFG, step=5)
    with torch.no_grad():
        for p in model.parameters():
            p.sub_(1.0)

    for kwargs, want, cfg_want in (
            ({}, sd5, CFG), ({"step": "3", "ema": True}, ema, CFG),
            ({"step": 3, "valid_iters": 5}, sd3, CFG.replace(valid_iters=5))):
        got, cfg = from_pretrained(tmp_path, device="cpu", **kwargs)
        assert cfg == cfg_want
        assert not got.training
        assert got.state_dict().keys() == want.keys()
        assert all(torch.equal(got.state_dict()[k], v) for k, v in want.items()), kwargs
    with pytest.raises(ValueError, match="EMA"):
        from_pretrained(tmp_path, device="cpu", ema=True)


def test_bad_checkpoints_raise(model, tmp_path, no_init):
    sd = _state_dict(model)
    cases = {
        "unknown": {**sd, "feature.extra.weight": torch.zeros(3)},
        "missing": {k: v for k, v in sd.items() if k != "cnet.conv1.weight"},
        "shape": {**sd, "cnet.conv1.bias": torch.zeros(3)},
    }
    for name, bad in cases.items():
        torch.save({"model": bad}, tmp_path / f"{name}.pth")
        with pytest.raises(ValueError, match="does not fit"):
            from_pretrained(tmp_path / f"{name}.pth", device="cpu", vit_size="vits",
                            max_disp=64, mixed_precision=False)
    with pytest.raises(FileNotFoundError, match="neither"):
        from_pretrained(tmp_path / "nope", device="cpu")
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        from_pretrained(tmp_path, device="cpu")


def test_from_pretrained_fails_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_pretrained(tmp_path)
