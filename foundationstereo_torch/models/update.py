"""Iterative refinement: selective ConvGRUs, motion encoder, disparity head.

The port of the JAX package's ``models/update.py`` (channel-first).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from foundationstereo_torch.models.layers import Conv2d, EdgeNextConvEncoder
from foundationstereo_torch.ops.resize import resize2d
from foundationstereo_torch.ops.upsample import avg_pool2x


def interp(x, dest):
    return resize2d(x, tuple(dest.shape[-2:]), "bilinear", align_corners=True)


class DispHead(nn.Module):
    """conv + 2 EdgeNeXt k7 encoders + conv -> delta disparity."""

    def __init__(self, dim=128, cdt=torch.float32):
        super().__init__()
        self.conv = nn.Sequential(
            Conv2d(dim, dim, 3, 1, 1, cdt=cdt), nn.ReLU(),
            EdgeNextConvEncoder(dim, cdt=cdt),
            EdgeNextConvEncoder(dim, cdt=cdt),
            Conv2d(dim, 1, 3, 1, 1, cdt=cdt))

    def forward(self, x):
        return self.conv(x)


class RaftConvGRU(nn.Module):
    """Conv GRU; z and r read ``hx`` (the fused [x, h] features)."""

    def __init__(self, hidden_dim, input_dim, k=3, cdt=torch.float32):
        super().__init__()
        p = k // 2
        self.convz = Conv2d(hidden_dim + input_dim, hidden_dim, k, 1, p, cdt=cdt)
        self.convr = Conv2d(hidden_dim + input_dim, hidden_dim, k, 1, p, cdt=cdt)
        self.convq = Conv2d(hidden_dim + input_dim, hidden_dim, k, 1, p, cdt=cdt)

    def forward(self, h, x, hx):
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q


class SelectiveConvGRU(nn.Module):
    """Small- and large-kernel GRUs blended by a spatial attention map."""

    def __init__(self, hidden_dim, input_dim, cdt=torch.float32):
        super().__init__()
        self.conv0 = nn.Sequential(Conv2d(input_dim, input_dim, 3, 1, 1, cdt=cdt), nn.ReLU())
        self.conv1 = nn.Sequential(
            Conv2d(input_dim + hidden_dim, input_dim + hidden_dim, 3, 1, 1, cdt=cdt), nn.ReLU())
        self.small_gru = RaftConvGRU(hidden_dim, input_dim, 1, cdt)
        self.large_gru = RaftConvGRU(hidden_dim, input_dim, 3, cdt)

    def forward(self, att, h, *xs):
        x = self.conv0(torch.cat(xs, dim=1))
        hx = self.conv1(torch.cat([x, h], dim=1))
        return self.small_gru(h, x, hx) * att + self.large_gru(h, x, hx) * (1 - att)


class BasicMotionEncoder(nn.Module):
    """(disparity, lookup features (B, F, H, W)) -> 128-channel motion features."""

    def __init__(self, corr_channels, cdt=torch.float32):
        super().__init__()
        self.convc1 = Conv2d(corr_channels, 256, 1, cdt=cdt)
        self.convc2 = Conv2d(256, 256, 3, 1, 1, cdt=cdt)
        self.convd1 = Conv2d(1, 64, 7, 1, 3, cdt=cdt)
        self.convd2 = Conv2d(64, 64, 3, 1, 1, cdt=cdt)
        self.conv = Conv2d(256 + 64, 127, 3, 1, 1, cdt=cdt)

    def forward(self, disp, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        d = F.relu(self.convd2(F.relu(self.convd1(disp))))
        out = F.relu(self.conv(torch.cat([cor, d], dim=1)))
        return torch.cat([out, disp], dim=1)


class BasicSelectiveMultiUpdateBlock(nn.Module):
    """Coarse-to-fine GRU update; net/inp/att are ordered [1/4, 1/8, 1/16].
    Returns (new net list, mask features, delta disparity)."""

    def __init__(self, hidden_dim, n_gru_layers, corr_channels, cdt=torch.float32):
        super().__init__()
        self.n_gru_layers = n_gru_layers
        self.encoder = BasicMotionEncoder(corr_channels, cdt)
        if n_gru_layers == 3:
            self.gru16 = SelectiveConvGRU(hidden_dim, hidden_dim * 2, cdt)
        if n_gru_layers >= 2:
            inputs = hidden_dim * (3 if n_gru_layers == 3 else 2)
            self.gru08 = SelectiveConvGRU(hidden_dim, inputs, cdt)
        if n_gru_layers > 1:
            self.gru04 = SelectiveConvGRU(hidden_dim, hidden_dim + 256, cdt)
        self.disp_head = DispHead(hidden_dim, cdt)
        self.mask = nn.Sequential(Conv2d(hidden_dim, 64, 3, 1, 1, cdt=cdt), nn.ReLU(),
                                  Conv2d(64, 32, 3, 1, 1, cdt=cdt), nn.ReLU())

    def forward(self, net, inp, corr, disp, att):
        net = list(net)
        if self.n_gru_layers == 3:
            net[2] = self.gru16(att[2], net[2], inp[2], avg_pool2x(net[1]))
        if self.n_gru_layers > 2:
            net[1] = self.gru08(att[1], net[1], inp[1], avg_pool2x(net[0]), interp(net[2], net[1]))
        elif self.n_gru_layers == 2:
            net[1] = self.gru08(att[1], net[1], inp[1], avg_pool2x(net[0]))
        motion = torch.cat([inp[0], self.encoder(disp, corr)], dim=1)
        if self.n_gru_layers > 1:
            net[0] = self.gru04(att[0], net[0], motion, interp(net[1], net[0]))
        delta = self.disp_head(net[0])
        mask_feat = 0.25 * self.mask(net[0])
        return net, mask_feat, delta
