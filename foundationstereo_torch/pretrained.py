"""Model loading from local files: the ``from_pretrained`` ergonomic.

The port of the JAX package's ``pretrained.py``. The reference model is a
``PyTorchModelHubMixin``, so users write ``FoundationStereo.from_pretrained``
and get a ready model. A torch module holds its weights, so here::

    model, cfg = from_pretrained("path/to/ckpt_dir_or_file.pth")
    disp = run_pair(model, left, right, iters=32)

Accepted sources (told apart by the path):

* a **checkpoint directory** of the port's trainer (``train/checkpoints.py``:
  ``{step}.pt``, ``{step}_ema.pt``, ``latest.pt``) or of
  :func:`save_pretrained`, with its ``config.json``: ``step`` picks the
  step ("latest" by default), ``ema=True`` the EMA weights;
* a **reference checkpoint file** ``.pth``/``.pt`` in the reference's
  ``{"model": state_dict, ...}`` layout. The port's parameter names are the
  reference's, so the keys load by name; the keys of modules the forward
  never runs (``VESTIGIAL``) are dropped. The model config is read from a
  sibling ``cfg.yaml`` (the reference stores it beside the weights) or
  ``config.json``.

``overrides`` (``ModelConfig`` fields) are laid over the stored config, as
the reference lays its CLI arguments over ``cfg.yaml``. Any other key the
model lacks, a key it has that the file lacks, or a shape that differs
raises ``ValueError``, as the JAX importer's unresolved parameters do.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import torch

from foundationstereo_torch.config import ModelConfig
from foundationstereo_torch.models.foundation_stereo import FoundationStereo, resolve_device
from foundationstereo_torch.train.checkpoints import CheckpointManager

__all__ = ["from_pretrained", "save_pretrained"]

# Keys of a reference checkpoint that the port's model does not hold: modules
# the reference builds and its forward never runs (stem_4, context_zqr_convs,
# the DPT's refinenet4.resConfUnit1 and monocular output head, the context
# net's unused downsample and norms), the ViT's SSL-only mask token and batch
# norm's counters. Matched as substrings, as
# tests/test_parity_full_forward.py matches them.
VESTIGIAL = (
    "stem_4.",
    "context_zqr_convs.",
    "num_batches_tracked",
    "feature.dino.depth_anything.pretrained.mask_token",
    "depth_head.scratch.refinenet4.resConfUnit1",
    "depth_head.scratch.output_conv2",
    "cnet.down", "cnet.norm.", ".norm3.",
)


def _load_config(directory: Path, overrides: dict) -> ModelConfig:
    cfg_dict: dict = {}
    yaml_path, json_path = directory / "cfg.yaml", directory / "config.json"
    if yaml_path.exists():
        import yaml

        raw = yaml.safe_load(yaml_path.read_text()) or {}
        cfg_dict = raw.get("model", raw)
    elif json_path.exists():
        raw = json.loads(json_path.read_text())
        cfg_dict = raw.get("model", raw)
    return ModelConfig.from_dict({**cfg_dict, **overrides})


def _load_weights(model: torch.nn.Module, state_dict: dict) -> None:
    """Load a reference-named ``state_dict`` into ``model``, dropping the
    ``VESTIGIAL`` keys the model lacks; raises ``ValueError`` on any other
    unknown key, a missing key or a shape mismatch."""
    own = model.state_dict()
    sd = {k: v for k, v in state_dict.items()
          if k in own or not any(pat in k for pat in VESTIGIAL)}
    unknown = sorted(set(sd) - set(own))
    missing = sorted(set(own) - set(sd))
    bad = [k for k in sd if k in own and tuple(sd[k].shape) != tuple(own[k].shape)]
    if unknown or missing or bad:
        raise ValueError(f"checkpoint does not fit the model: {len(unknown)} unknown keys "
                         f"{unknown[:5]}, {len(missing)} missing keys {missing[:5]}, "
                         f"{len(bad)} shape mismatches {bad[:5]}")
    model.load_state_dict(sd)


def from_pretrained(path: str | Path, *, ema: bool = False, step: int | str = "latest",
                    device="cuda", seed: int = 0, **overrides) -> tuple[FoundationStereo, ModelConfig]:
    """A ready model, in eval mode on ``device``, from ``path``; returns
    ``(model, cfg)``. ``seed`` seeds the initialisers the weights replace."""
    device = resolve_device(device)
    path = Path(path)
    if path.is_file() and path.suffix in (".pth", ".pt"):
        cfg = _load_config(path.parent, overrides)
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        state_dict = ckpt.get("model", ckpt)
    elif path.is_dir():
        cfg = _load_config(path, overrides)
        state_dict, _ = CheckpointManager(path).restore_inference(step, use_ema=ema)
    else:
        raise FileNotFoundError(f"{path} is neither a checkpoint directory nor a .pth/.pt file")
    model = FoundationStereo(cfg, device=device, seed=seed)
    _load_weights(model, state_dict)
    return model, cfg


def save_pretrained(path: str | Path, model: torch.nn.Module, cfg: ModelConfig, *,
                    step: int = 0) -> None:
    """Write ``model``'s weights and ``cfg`` into the directory ``path`` in the
    trainer's file family (``{step}.pt``, ``latest.pt``, ``config.json``), so
    that ``from_pretrained(path)`` gives the same model."""
    mgr = CheckpointManager(path)
    mgr.save_model(step, model, config={"model": dataclasses.asdict(cfg)})
