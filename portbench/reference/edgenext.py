"""EdgeNeXt-S, the trainable unary trunk of the reference (timm's
``edgenext_small`` parameter names)."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.nn import Conv2d, LayerNorm, LayerNorm2d, Linear
from portbench.reference.ops import cast

DIMS = (48, 96, 160, 304)
DEPTHS = (3, 3, 9, 3)
KERNEL_SIZES = (3, 5, 7, 9)
D2_SCALES = (2, 2, 3, 4)
GLOBAL_BLOCKS = (0, 1, 1, 1)
USE_POS_EMB = (False, True, False, False)
HEADS = 8
EXPAN_RATIO = 4
LAYER_SCALE_INIT = 1e-6


class Mlp(nn.Module):
    def __init__(self, dim, hidden, cdt):
        super().__init__()
        self.fc1 = Linear(dim, hidden, cdt=cdt)
        self.fc2 = Linear(hidden, dim, cdt=cdt)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class ConvBlock(nn.Module):
    """Depthwise conv + LayerNorm + pointwise MLP + layer scale, residual."""

    def __init__(self, dim, k, cdt):
        super().__init__()
        self.conv_dw = Conv2d(dim, dim, k, 1, k // 2, groups=dim, cdt=cdt)
        self.norm = LayerNorm(dim)
        self.mlp = Mlp(dim, EXPAN_RATIO * dim, cdt)
        self.gamma = nn.Parameter(torch.full((dim,), LAYER_SCALE_INIT))

    def forward(self, x):
        y = self.mlp(self.norm(self.conv_dw(x).movedim(1, -1)))
        return x + (self.gamma * y).movedim(-1, 1)


def fourier_pos_embedding(h: int, w: int, hidden: int = 32) -> np.ndarray:
    """2D sine/cosine features (h, w, 2*hidden) for the SDTA position encoding."""
    temperature, scale, eps = 10000.0, 2 * math.pi, 1e-6
    y = np.arange(1, h + 1, dtype=np.float64)[:, None].repeat(w, 1)
    x = np.arange(1, w + 1, dtype=np.float64)[None, :].repeat(h, 0)
    y = y / (y[-1:, :] + eps) * scale
    x = x / (x[:, -1:] + eps) * scale
    dim_t = temperature ** (2 * (np.arange(hidden) // 2) / hidden)
    pos_x = x[..., None] / dim_t
    pos_y = y[..., None] / dim_t
    pos_x = np.stack([np.sin(pos_x[..., 0::2]), np.cos(pos_x[..., 1::2])], axis=-1).reshape(h, w, -1)
    pos_y = np.stack([np.sin(pos_y[..., 0::2]), np.cos(pos_y[..., 1::2])], axis=-1).reshape(h, w, -1)
    return np.concatenate([pos_y, pos_x], axis=-1).astype(np.float32)


class PositionalEncodingFourier(nn.Module):
    def __init__(self, dim, hidden=32, cdt=torch.float32):
        super().__init__()
        self.hidden = hidden
        self.token_projection = Conv2d(2 * hidden, dim, 1, cdt=cdt)

    def forward(self, h, w, device):
        pe = torch.from_numpy(fourier_pos_embedding(h, w, self.hidden)).to(device)
        return self.token_projection(pe.permute(2, 0, 1)[None])     # (1, C, h, w)


class XCA(nn.Module):
    """Cross-covariance attention with a learnable per-head temperature."""

    def __init__(self, dim, num_heads=HEADS, cdt=torch.float32):
        super().__init__()
        self.num_heads, self.cdt = num_heads, cdt
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = Linear(dim, 3 * dim, cdt=cdt)
        self.proj = Linear(dim, dim, cdt=cdt)

    def forward(self, x):
        B, N, C = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.num_heads, C // self.num_heads)
        q, k, v = cast(qkv, self.cdt).permute(2, 0, 3, 4, 1).unbind(0)   # (B, h, hd, N)
        qn = q / torch.clamp(torch.linalg.vector_norm(q.float(), dim=-1, keepdim=True), min=1e-12)
        kn = k / torch.clamp(torch.linalg.vector_norm(k.float(), dim=-1, keepdim=True), min=1e-12)
        attn = torch.einsum("bhcn,bhdn->bhcd", qn, kn) * self.temperature
        attn = torch.softmax(attn.float(), dim=-1)
        out = torch.einsum("bhcd,bhdn->bhcn", cast(attn, self.cdt), v)
        return self.proj(out.permute(0, 3, 1, 2).reshape(B, N, C))


class SplitTransposeBlock(nn.Module):
    """SDTA block: Res2Net-style cascaded depthwise convs over channel splits,
    cross-covariance attention, inverted MLP."""

    def __init__(self, dim, scales, use_pos_emb, cdt):
        super().__init__()
        self.width = int(math.ceil(dim / scales))
        n_splits = len([i for i in range(scales) if i * self.width < dim])
        n_dw = 1 if n_splits == 1 else n_splits - 1
        widths = [min((i + 1) * self.width, dim) - i * self.width for i in range(n_dw)]
        self.convs = nn.ModuleList(Conv2d(c, c, 3, 1, 1, groups=c, cdt=cdt) for c in widths)
        self.pos_embd = PositionalEncodingFourier(dim, cdt=cdt) if use_pos_emb else None
        self.norm_xca = LayerNorm(dim)
        self.gamma_xca = nn.Parameter(torch.full((dim,), LAYER_SCALE_INIT))
        self.xca = XCA(dim, cdt=cdt)
        self.norm = LayerNorm(dim)
        self.mlp = Mlp(dim, EXPAN_RATIO * dim, cdt)
        self.gamma = nn.Parameter(torch.full((dim,), LAYER_SCALE_INIT))

    def forward(self, x):
        B, C, H, W = x.shape
        shortcut = x
        splits = list(torch.split(x, self.width, dim=1))
        outs, sp = [], None
        for i, conv in enumerate(self.convs):
            sp = splits[i] if i == 0 else sp + splits[i]
            sp = conv(sp)
            outs.append(sp)
        if len(splits) > 1:
            outs.append(splits[-1])
        x = torch.cat(outs, dim=1)
        if self.pos_embd is not None:
            pe = self.pos_embd(H, W, x.device)
            x = x + pe.float()
        tokens = x.flatten(2).transpose(1, 2)                        # (B, HW, C)
        t = self.norm_xca(tokens)
        tokens = tokens + self.gamma_xca * self.xca(t)
        h = self.mlp(self.norm(tokens))
        h = (self.gamma * h).transpose(1, 2).reshape(B, C, H, W)
        return shortcut + h


class Stage(nn.Module):
    def __init__(self, si, cdt):
        super().__init__()
        self.downsample = None
        if si > 0:
            self.downsample = nn.Sequential(LayerNorm2d(DIMS[si - 1]),
                                            Conv2d(DIMS[si - 1], DIMS[si], 2, 2, cdt=cdt))
        n_global = GLOBAL_BLOCKS[si]
        blocks = [ConvBlock(DIMS[si], KERNEL_SIZES[si], cdt)
                  for _ in range(DEPTHS[si] - n_global)]
        blocks += [SplitTransposeBlock(DIMS[si], D2_SCALES[si], USE_POS_EMB[si] and g == 0, cdt)
                   for g in range(n_global)]
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x):
        if self.downsample is not None:
            x = self.downsample(x)
        for blk in self.blocks:
            x = blk(x)
        return x


def make_edgenext(cdt=torch.float32):
    """(stem, stages): the trunk's two parts, which ``Feature`` owns directly."""
    stem = nn.Sequential(Conv2d(3, DIMS[0], 4, 4, cdt=cdt), LayerNorm2d(DIMS[0]))
    stages = nn.ModuleList(Stage(si, cdt) for si in range(4))
    return stem, stages
