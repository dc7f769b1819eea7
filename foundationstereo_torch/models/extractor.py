"""Feature extraction: the side-tuning trunk and the context network.

The port of the JAX package's ``models/extractor.py``:

* :class:`Feature` -- EdgeNeXt-S pyramid fused top-down with ``Conv2xIN``
  transposed convs; the frozen DepthAnything feature is concatenated at 1/4
  resolution. Returns [x4, x8, x16, x32] and the ViT feature. The
  DepthAnything model is frozen: its parameters do not require grad and it
  runs under ``torch.no_grad`` (the JAX package's ``stop_gradient``).
* :class:`ContextNetDino` -- residual trunk that fuses the ViT feature at
  1/4 and emits (hidden, context) pairs at 1/4, 1/8 and 1/16.
* :class:`Stem2` -- the half-resolution stem of the convex upsampler.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from foundationstereo_torch.config import ModelConfig
from foundationstereo_torch.models.dpt import DepthAnythingFeature
from foundationstereo_torch.models.edgenext import DIMS as EDGENEXT_CHANS
from foundationstereo_torch.models.edgenext import make_edgenext
from foundationstereo_torch.models.layers import (
    BasicConv,
    BasicConvIN,
    BatchNorm,
    Conv2d,
    Conv2xIN,
    InstanceNorm,
    ResidualBlock,
)
from foundationstereo_torch.ops.resize import resize2d
from foundationstereo_torch.utils.misc import get_resize_keep_aspect_ratio


def feature_dims(cfg: ModelConfig) -> list[int]:
    """Channels of [x4, x8, x16, x32]."""
    c = EDGENEXT_CHANS
    return [c[0] * 2 + cfg.vit_feat_dim, c[1] * 2, c[2] * 2, c[3]]


class Feature(nn.Module):
    """Unary feature extractor; input (B, 3, H, W) normalised RGB."""

    def __init__(self, cfg: ModelConfig, cdt=torch.float32):
        super().__init__()
        c = EDGENEXT_CHANS
        self.stem, self.stages = make_edgenext(cdt)
        self.deconv32_16 = Conv2xIN(c[3], c[2], cdt=cdt)
        self.deconv16_8 = Conv2xIN(c[2] * 2, c[1], cdt=cdt)
        self.deconv8_4 = Conv2xIN(c[1] * 2, c[0], cdt=cdt)
        c4 = c[0] * 2 + cfg.vit_feat_dim
        self.conv4 = nn.Sequential(
            BasicConv(c4, c4, 3, 1, 1, norm="instance", cdt=cdt),
            ResidualBlock(c4, c4, norm="instance", cdt=cdt),
            ResidualBlock(c4, c4, norm="instance", cdt=cdt))
        self.dino = DepthAnythingFeature(cfg.vit_size, cfg.vit_attention, cfg.use_pallas, cdt)
        self.dino.requires_grad_(False)

    def forward(self, x):
        H, W = x.shape[-2:]
        H_r, W_r = get_resize_keep_aspect_ratio(H, W, divider=112, max_H=1344, max_W=1344)
        with torch.no_grad():
            x_vit = resize2d(x, (H_r, W_r), "bicubic", align_corners=False)
            vit_feat = self.dino(x_vit, out_hw=(H // 4, W // 4))

        x = self.stem(x)
        feats = []
        for stage in self.stages:
            x = stage(x)
            feats.append(x)
        x4, x8, x16, x32 = feats
        x16 = self.deconv32_16(x32, x16)
        x8 = self.deconv16_8(x16, x8)
        x4 = self.deconv8_4(x8, x4)
        x4 = self.conv4(torch.cat([x4, vit_feat.to(x4.dtype)], dim=1))
        return [x4, x8, x16, x32], vit_feat


class ContextNetDino(nn.Module):
    """Context network; returns [(h04, c04), (h08, c08), (h16, c16)]."""

    def __init__(self, cfg: ModelConfig, norm="batch", cdt=torch.float32):
        super().__init__()
        down = cfg.n_downsample
        hd = tuple(cfg.hidden_dims)

        def layer(cin, dim, stride):
            return nn.Sequential(ResidualBlock(cin, dim, norm, stride, cdt),
                                 ResidualBlock(dim, dim, norm, 1, cdt))

        def head(d):
            return nn.Sequential(ResidualBlock(128, 128, norm, 1, cdt),
                                 Conv2d(128, d, 3, 1, 1, cdt=cdt))

        self.conv1 = Conv2d(3, 64, 7, 1 + (down > 2), 3, cdt=cdt)
        self.norm1 = BatchNorm(64)
        self.layer1 = layer(64, 64, 1)
        self.layer2 = layer(64, 96, 1 + (down > 1))
        self.layer3 = layer(96, 128, 1 + (down > 0))
        self.conv2 = BasicConv(128 + cfg.vit_feat_dim, 128, 3, 1, 1, cdt=cdt)
        self.outputs04 = nn.ModuleList(head(hd[2]) for _ in range(2))
        self.outputs08 = nn.ModuleList(head(hd[1]) for _ in range(2))
        self.layer4 = layer(128, 128, 2)
        self.layer5 = layer(128, 128, 2)
        self.outputs16 = nn.ModuleList(Conv2d(128, hd[0], 3, 1, 1, cdt=cdt) for _ in range(2))

    def forward(self, x, vit_feat):
        x = F.relu(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        x = self.conv2(torch.cat([x, vit_feat.to(x.dtype)], dim=1))
        out04 = tuple(f(x) for f in self.outputs04)
        y = self.layer4(x)
        out08 = tuple(f(y) for f in self.outputs08)
        z = self.layer5(y)
        out16 = tuple(f(z) for f in self.outputs16)
        return [out04, out08, out16]


class Stem2(nn.Sequential):
    """Half-resolution image stem used by the convex upsampler."""

    def __init__(self, cdt=torch.float32):
        super().__init__(BasicConvIN(3, 32, 3, 2, 1, cdt=cdt),
                         Conv2d(32, 32, 3, 1, 1, bias=False, cdt=cdt),
                         InstanceNorm(), nn.ReLU())
