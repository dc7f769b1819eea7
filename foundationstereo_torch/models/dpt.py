"""DPT decoder head and the DepthAnything feature wrapper (channel-first).

The port of the JAX package's ``models/dpt.py``. Only the intermediate
``out`` feature that FoundationStereo consumes is built; with ``out_hw`` it
is delivered at that size through one composed interpolation matrix per
axis (the up-to-ViT-resolution intermediate never exists).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from foundationstereo_torch.config import VIT_CONFIGS
from foundationstereo_torch.models.dinov2 import make_vit
from foundationstereo_torch.models.layers import Conv2d, ConvTranspose2d
from foundationstereo_torch.ops.resize import resize2d, resize2d_via


class ResidualConvUnit(nn.Module):
    def __init__(self, features, cdt):
        super().__init__()
        self.conv1 = Conv2d(features, features, 3, 1, 1, cdt=cdt)
        self.conv2 = Conv2d(features, features, 3, 1, 1, cdt=cdt)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    """Add the skip (through resConfUnit1), resConfUnit2, bilinear resize,
    1x1 out conv."""

    def __init__(self, features, has_skip=True, cdt=torch.float32):
        super().__init__()
        if has_skip:
            self.resConfUnit1 = ResidualConvUnit(features, cdt)
        self.resConfUnit2 = ResidualConvUnit(features, cdt)
        self.out_conv = Conv2d(features, features, 1, cdt=cdt)

    def forward(self, x, skip=None, size=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        if size is None:
            size = (x.shape[-2] * 2, x.shape[-1] * 2)
        return self.out_conv(resize2d(x, tuple(size), "bilinear", align_corners=True))


class Scratch(nn.Module):
    def __init__(self, features, out_channels, cdt):
        super().__init__()
        for i in range(4):
            setattr(self, f"layer{i + 1}_rn",
                    Conv2d(out_channels[i], features, 3, 1, 1, bias=False, cdt=cdt))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", FeatureFusionBlock(features, i != 4, cdt))
        self.output_conv1 = Conv2d(features, features // 2, 3, 1, 1, cdt=cdt)


class DPTHead(nn.Module):
    def __init__(self, in_channels, features, out_channels, patch_size=14, cdt=torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.projects = nn.ModuleList(Conv2d(in_channels, oc, 1, cdt=cdt) for oc in out_channels)
        self.resize_layers = nn.ModuleList([
            ConvTranspose2d(out_channels[0], out_channels[0], 4, 4, cdt=cdt),
            ConvTranspose2d(out_channels[1], out_channels[1], 2, 2, cdt=cdt),
            nn.Identity(),
            Conv2d(out_channels[3], out_channels[3], 3, 2, 1, cdt=cdt)])
        self.scratch = Scratch(features, out_channels, cdt)

    def forward(self, patch_tokens, patch_h, patch_w, out_hw=None):
        feats = []
        for i, tokens in enumerate(patch_tokens):
            x = tokens.transpose(1, 2).reshape(tokens.shape[0], -1, patch_h, patch_w)
            feats.append(self.resize_layers[i](self.projects[i](x)))
        s = self.scratch
        rn = [getattr(s, f"layer{i + 1}_rn")(feats[i]) for i in range(4)]
        path4 = s.refinenet4(rn[3], size=rn[2].shape[-2:])
        path3 = s.refinenet3(path4, rn[2], size=rn[1].shape[-2:])
        path2 = s.refinenet2(path3, rn[1], size=rn[0].shape[-2:])
        path1 = s.refinenet1(path2, rn[0])
        out = s.output_conv1(path1)
        full_hw = (patch_h * self.patch_size, patch_w * self.patch_size)
        if out_hw is not None:
            return resize2d_via(out, full_hw, tuple(out_hw), "bilinear", align_corners=True)
        return resize2d(out, full_hw, "bilinear", align_corners=True)


class DepthAnything(nn.Module):
    def __init__(self, vit_size, attention, use_kernel, cdt):
        super().__init__()
        c = VIT_CONFIGS[vit_size]
        self.intermediate_layers = c["intermediate_layers"]
        self.pretrained = make_vit(vit_size, attention, use_kernel, cdt)
        self.depth_head = DPTHead(c["embed_dim"], c["dpt_features"], c["dpt_out_channels"],
                                  cdt=cdt)


class DepthAnythingFeature(nn.Module):
    """Frozen DINOv2 + DPT head -> the monocular prior feature. Input
    (B, 3, H, W) normalised RGB with H, W divisible by 14."""

    def __init__(self, vit_size="vitl", attention="auto", use_kernel=True, cdt=torch.float32):
        super().__init__()
        self.depth_anything = DepthAnything(vit_size, attention, use_kernel, cdt)

    def forward(self, x, out_hw=None):
        da = self.depth_anything
        outputs = da.pretrained(x, da.intermediate_layers)
        h, w = x.shape[-2] // 14, x.shape[-1] // 14
        return da.depth_head([t for t, _cls in outputs], h, w, out_hw=out_hw)
