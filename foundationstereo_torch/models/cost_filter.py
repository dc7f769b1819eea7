"""Cost filtering: the 3D hourglass with axial-planar convs and the disparity
transformer, the correlation stem and the initial-disparity classifier.

The port of the JAX package's ``models/cost_filter.py``, on (B, C, D, H, W)
volumes.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from foundationstereo_torch.models.layers import (
    BasicConv,
    BatchNorm,
    Conv3d,
    Conv3dNormActReduced,
    CostVolumeDisparityAttention,
    FeatureAtt,
    ResnetBasicBlock,
)
from foundationstereo_torch.ops.resize import resize_dhw


class Hourglass(nn.Module):
    """(B, C, D, H, W) -> same shape; ``features`` = [x4, x8, x16, x32]."""

    def __init__(self, c, max_disp, feat_dims, cdt=torch.float32):
        super().__init__()

        def down(cin, ch):
            return nn.Sequential(BasicConv(cin, ch, 3, 2, 1, is_3d=True, cdt=cdt),
                                 Conv3dNormActReduced(ch, ch, cdt=cdt))

        def agg(cin, ch):
            return nn.Sequential(BasicConv(cin, ch, 1, 1, 0, is_3d=True, cdt=cdt),
                                 Conv3dNormActReduced(ch, ch, cdt=cdt),
                                 Conv3dNormActReduced(ch, ch, cdt=cdt))

        def up(cin, ch):
            return BasicConv(cin, ch, (4, 4, 4), 2, 1, deconv=True, is_3d=True, cdt=cdt)

        self.conv1 = down(c, 2 * c)
        self.conv2 = down(2 * c, 4 * c)
        self.conv3 = down(4 * c, 6 * c)
        self.conv3_up = up(6 * c, 4 * c)
        self.conv2_up = up(4 * c, 2 * c)
        self.conv1_up = up(2 * c, c)
        self.agg_0 = agg(8 * c, 4 * c)
        self.agg_1 = agg(4 * c, 2 * c)
        self.feature_att_8 = FeatureAtt(2 * c, feat_dims[1], cdt)
        self.feature_att_16 = FeatureAtt(4 * c, feat_dims[2], cdt)
        self.feature_att_32 = FeatureAtt(6 * c, feat_dims[3], cdt)
        self.feature_att_up_16 = FeatureAtt(4 * c, feat_dims[2], cdt)
        self.feature_att_up_8 = FeatureAtt(2 * c, feat_dims[1], cdt)
        self.conv_patch = nn.Sequential(Conv3d(c, c, 4, 4, 0, groups=c, cdt=cdt), BatchNorm(c))
        self.atts = nn.ModuleDict({"4": CostVolumeDisparityAttention(
            c, nhead=4, dim_feedforward=c, num_transformer=4, max_len=max_disp // 16, cdt=cdt)})
        self.conv_out = nn.Sequential(Conv3dNormActReduced(c, c, cdt=cdt),
                                      Conv3dNormActReduced(c, c, cdt=cdt))

    def forward(self, x, features):
        conv1 = self.feature_att_8(self.conv1(x), features[1])
        conv2 = self.feature_att_16(self.conv2(conv1), features[2])
        conv3 = self.feature_att_32(self.conv3(conv2), features[3])

        conv2 = self.agg_0(torch.cat([self.conv3_up(conv3), conv2], dim=1))
        conv2 = self.feature_att_up_16(conv2, features[2])
        conv1 = self.agg_1(torch.cat([self.conv2_up(conv2), conv1], dim=1))
        conv1 = self.feature_att_up_8(conv1, features[1])
        conv = self.conv1_up(conv1)

        # Disparity transformer branch at 1/4 of the volume's resolution.
        p = self.atts["4"](self.conv_patch(x))
        p = resize_dhw(p, tuple(s * 4 for s in p.shape[-3:]), "trilinear", align_corners=False)
        return self.conv_out(conv + p)


class CorrStem(nn.Sequential):
    """Project the 32-channel (gwc + concat) volume to ``volume_dim`` channels.

    Input is either the dense (B, G + 2P, D, H, W) volume, or the parts
    ``(gwc, rps, left_proj)`` from the cost-volume kernel -- gwc (B, G, D, H, W),
    rps (B, P, D, H, W), left_proj (B, P, H, W). The parts form applies the
    same 1x1x1 projection as three channel-slice contractions (concat order
    [gwc, left, right]) plus the d-invariant left term, so the 32-channel
    volume is never built.
    """

    def __init__(self, in_dim, volume_dim=28, cdt=torch.float32):
        super().__init__(Conv3d(in_dim, volume_dim, 1, cdt=cdt),
                         BasicConv(volume_dim, volume_dim, 3, 1, 1, is_3d=True, cdt=cdt),
                         ResnetBasicBlock(volume_dim, is_3d=True, cdt=cdt),
                         ResnetBasicBlock(volume_dim, is_3d=True, cdt=cdt))

    def forward(self, x):
        proj = self[0]
        if isinstance(x, (tuple, list)):
            gwc, rps, lp = x
            dt = proj.cdt
            g, p = gwc.shape[1], rps.shape[1]
            k = proj.weight[:, :, 0, 0, 0].to(dt)                     # (F, G + 2P)
            kg, kl, kr = k[:, :g], k[:, g:g + p], k[:, g + p:]
            x = (torch.einsum("bgdhw,fg->bfdhw", gwc.to(dt), kg)
                 + torch.einsum("bpdhw,fp->bfdhw", rps.to(dt), kr))
            lterm = torch.einsum("bphw,fp->bfhw", lp.to(dt), kl) + proj.bias.to(dt)[:, None, None]
            x = x + lterm[:, :, None]
        else:
            x = proj(x)
        for m in list(self)[1:]:
            x = m(x)
        return x


class Classifier(nn.Sequential):
    """Initial-disparity head: (B, C, D, H, W) -> (B, D, H, W) logits."""

    def __init__(self, volume_dim=28, cdt=torch.float32):
        c = volume_dim // 2
        super().__init__(BasicConv(volume_dim, c, 3, 1, 1, is_3d=True, cdt=cdt),
                         ResnetBasicBlock(c, is_3d=True, cdt=cdt),
                         Conv3d(c, 1, 7, 1, 3, cdt=cdt))

    def forward(self, x):
        return super().forward(x)[:, 0]
