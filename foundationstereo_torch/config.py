"""Model configuration of the PyTorch/CUDA port.

The port's own copy of the JAX package's ``ModelConfig`` and ``VIT_CONFIGS``
with the same field names, so the same JSON configs load into both.

The training path's memory knobs act through ``torch.utils.checkpoint``
(``models/layers.py:checkpointed``): ``remat_filter`` recomputes CorrStem,
FeatureAtt, Hourglass and Classifier in the backward, ``remat_refine`` each
refinement step, ``scan_upsample`` each step's upsampling head.

Fields that select TPU-only code paths are accepted and have no effect here:
``scan_upsample_chunk`` (the port applies the upsampling head once per
iteration), ``fused_lookup`` and ``gather_lookup`` (the port has one lookup kernel that
covers all levels in one launch with a direct gather, whatever these say),
``pallas_cost_volume`` and ``fused_cost_proj`` (the port always builds the
cost volume as parts when ``use_pallas`` is set).

``use_pallas`` selects the hand-written CUDA kernels: on CUDA tensors the
cost-volume build, the disparity lookup and the ViT flash attention run as
kernels (where gradients are taken, only the frozen ViT's attention: the
others have no backward); with ``use_pallas=False`` the model runs the
plain PyTorch forms everywhere (the counterpart of the JAX package's XLA
forms).
``pallas_conv3x3`` (default off, as in the JAX package) adds the 3x3 conv
kernel when ``use_pallas`` is set: every 3x3/s1/p1 conv with C >= 128 and
F >= 64 runs through it, in bf16 or fp32 (the JAX package's rule and forms,
``models/layers.py:k4_eligible``); the other convs stay with PyTorch.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Hyper-parameters of the stereo model (field names as the JAX package's)."""

    max_disp: int = 192
    corr_radius: int = 4
    corr_levels: int = 4
    n_gru_layers: int = 3
    n_downsample: int = 2
    hidden_dims: tuple[int, ...] = (128, 128, 128)
    vit_size: str = "vitl"
    mixed_precision: bool = True
    low_memory: bool = False
    test_mode: bool = False

    cv_group: int = 8
    volume_dim: int = 28
    train_iters: int = 22
    valid_iters: int = 32
    use_pallas: bool = True
    pallas_cost_volume: bool = True   # inert
    fused_lookup: bool = False        # inert
    gather_lookup: bool = False       # inert
    pallas_conv3x3: bool = False      # with use_pallas: eligible 3x3 convs through K4
    # bf16 geometry/correlation pyramids on the kernel path (use_pallas; fp32
    # accumulation inside the lookup kernel), as the JAX package's kernel
    # path does; the plain path keeps fp32 pyramids.
    bf16_pyramids: bool = True
    fused_cost_proj: bool = True      # inert
    # ViT attention over N > 1024 patch tokens: "flash" takes the flash kernel
    # (bf16 or fp32) when use_pallas is set, its plain twin otherwise;
    # "flash_sharded" the same per head shard of the active mesh (under a rank
    # mesh: the rank's heads, gathered over its spatial group); "auto" is
    # "flash_sharded" under a mesh of more than one entry, else "flash";
    # "chunked" the online softmax over key chunks; "dense" the dense form.
    vit_attention: str = "auto"
    # Training: checkpoint (recompute in the backward) the cost-filter stack
    # (CorrStem, FeatureAtt, Hourglass, Classifier), each refinement step,
    # and each step's upsampling head.
    remat_filter: bool = True
    remat_refine: bool = True
    scan_upsample: bool = True
    scan_upsample_chunk: int = 1      # inert

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ModelConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in known}
        if "hidden_dims" in kwargs:
            kwargs["hidden_dims"] = tuple(kwargs["hidden_dims"])
        return cls(**kwargs)

    @classmethod
    def from_json(cls, path: str) -> "ModelConfig":
        with open(path) as f:
            cfg = json.load(f)
        return cls.from_dict(cfg.get("model", cfg))

    def replace(self, **kwargs) -> "ModelConfig":
        return dataclasses.replace(self, **kwargs)

    @property
    def vit_features(self) -> int:
        """DPT decoder channel width per ViT size."""
        return {"vits": 64, "vitb": 128, "vitl": 256}[self.vit_size]

    @property
    def vit_feat_dim(self) -> int:
        """Channels of the monocular feature injected at 1/4 resolution."""
        return self.vit_features // 2


VIT_CONFIGS = {
    "vits": dict(embed_dim=384, depth=12, num_heads=6,
                 intermediate_layers=(2, 5, 8, 11),
                 dpt_features=64, dpt_out_channels=(48, 96, 192, 384)),
    "vitb": dict(embed_dim=768, depth=12, num_heads=12,
                 intermediate_layers=(2, 5, 8, 11),
                 dpt_features=128, dpt_out_channels=(96, 192, 384, 768)),
    "vitl": dict(embed_dim=1024, depth=24, num_heads=16,
                 intermediate_layers=(4, 11, 17, 23),
                 dpt_features=256, dpt_out_channels=(256, 512, 1024, 1024)),
}
