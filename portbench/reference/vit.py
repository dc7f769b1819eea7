"""The frozen monocular branch of the reference: DINOv2 ViT with dense
attention, and the DPT head that turns its taps into the 1/4-resolution
feature."""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.nn import Conv2d, ConvTranspose2d, LayerNorm, Linear
from portbench.reference.ops import cast, interp_matrix, resize, resize_via

VIT_CONFIGS = {
    "vits": dict(embed_dim=384, depth=12, num_heads=6, intermediate_layers=(2, 5, 8, 11),
                 dpt_features=64, dpt_out_channels=(48, 96, 192, 384)),
    "vitb": dict(embed_dim=768, depth=12, num_heads=12, intermediate_layers=(2, 5, 8, 11),
                 dpt_features=128, dpt_out_channels=(96, 192, 384, 768)),
    "vitl": dict(embed_dim=1024, depth=24, num_heads=16, intermediate_layers=(4, 11, 17, 23),
                 dpt_features=256, dpt_out_channels=(256, 512, 1024, 1024)),
}


class Attention(nn.Module):
    """Joint-qkv multi-head self-attention, dense softmax(q k^T / sqrt(d)) v."""

    def __init__(self, dim, num_heads, cdt):
        super().__init__()
        self.num_heads, self.cdt = num_heads, cdt
        self.qkv = Linear(dim, 3 * dim, cdt=cdt)
        self.proj = Linear(dim, dim, cdt=cdt)

    def forward(self, x):
        B, N, C = x.shape
        q, k, v = cast(self.qkv(x), self.cdt).reshape(B, N, 3, self.num_heads, -1).unbind(2)
        logits = torch.einsum("bnhd,bmhd->bhnm", q, k) * (1.0 / math.sqrt(C // self.num_heads))
        w = cast(torch.softmax(logits.float(), dim=-1), self.cdt)
        return self.proj(torch.einsum("bhnm,bmhd->bnhd", w, v).reshape(B, N, C))


class LayerScale(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return self.gamma * x


class Mlp(nn.Module):
    def __init__(self, dim, hidden, cdt):
        super().__init__()
        self.fc1 = Linear(dim, hidden, cdt=cdt)
        self.fc2 = Linear(hidden, dim, cdt=cdt)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim, num_heads, cdt):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, cdt)
        self.ls1 = LayerScale(dim)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, 4 * dim, cdt)
        self.ls2 = LayerScale(dim)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


def interpolate_pos_embed(pos_embed: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """Bicubic resize of the square grid of position embeddings to (hp, wp),
    with DINOv2's scale factors (hp + 0.1) / M and (wp + 0.1) / M."""
    m = int(math.isqrt(pos_embed.shape[1] - 1))
    if (hp, wp) == (m, m):
        return pos_embed
    grid = pos_embed[:, 1:].reshape(1, m, m, -1).movedim(-1, 1)
    for axis, n in ((2, hp), (3, wp)):
        mat = torch.from_numpy(interp_matrix(m, n, "cubic", False, float(n + 0.1) / m))
        grid = torch.tensordot(grid, mat.to(grid.device), dims=([axis], [1])).movedim(-1, axis)
    return torch.cat([pos_embed[:, :1], grid.flatten(2).transpose(1, 2)], dim=1)


class PatchEmbed(nn.Module):
    def __init__(self, patch, dim, cdt):
        super().__init__()
        self.proj = Conv2d(3, dim, patch, patch, cdt=cdt)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)


class DinoVisionTransformer(nn.Module):
    def __init__(self, embed_dim, depth, num_heads, cdt, patch_size=14, pretrain_img_size=518):
        super().__init__()
        self.patch_size = patch_size
        n = (pretrain_img_size // patch_size) ** 2
        self.patch_embed = PatchEmbed(patch_size, embed_dim, cdt)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, embed_dim))
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads, cdt) for _ in range(depth))
        self.norm = LayerNorm(embed_dim)

    def forward(self, x, taps):
        B, _, H, W = x.shape
        hp, wp = H // self.patch_size, W // self.patch_size
        t = self.patch_embed(x)
        t = torch.cat([self.cls_token.expand(B, -1, -1), t], dim=1)
        t = t + interpolate_pos_embed(self.pos_embed, hp, wp)
        out = {}
        for i, blk in enumerate(self.blocks):
            t = blk(t)
            if i in taps:
                out[i] = self.norm(t)[:, 1:]
        return [out[i] for i in taps]


class ResidualConvUnit(nn.Module):
    def __init__(self, f, cdt):
        super().__init__()
        self.conv1 = Conv2d(f, f, 3, 1, 1, cdt=cdt)
        self.conv2 = Conv2d(f, f, 3, 1, 1, cdt=cdt)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    def __init__(self, f, has_skip, cdt):
        super().__init__()
        if has_skip:
            self.resConfUnit1 = ResidualConvUnit(f, cdt)
        self.resConfUnit2 = ResidualConvUnit(f, cdt)
        self.out_conv = Conv2d(f, f, 1, cdt=cdt)

    def forward(self, x, skip=None, size=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        size = size or (x.shape[-2] * 2, x.shape[-1] * 2)
        return self.out_conv(resize(x, tuple(size), "bilinear", align_corners=True))


class Scratch(nn.Module):
    def __init__(self, f, outs, cdt):
        super().__init__()
        for i in range(4):
            setattr(self, f"layer{i + 1}_rn", Conv2d(outs[i], f, 3, 1, 1, bias=False, cdt=cdt))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", FeatureFusionBlock(f, i != 4, cdt))
        self.output_conv1 = Conv2d(f, f // 2, 3, 1, 1, cdt=cdt)


class DPTHead(nn.Module):
    def __init__(self, cin, f, outs, cdt, patch_size=14):
        super().__init__()
        self.patch_size = patch_size
        self.projects = nn.ModuleList(Conv2d(cin, oc, 1, cdt=cdt) for oc in outs)
        self.resize_layers = nn.ModuleList([
            ConvTranspose2d(outs[0], outs[0], 4, 4, cdt=cdt),
            ConvTranspose2d(outs[1], outs[1], 2, 2, cdt=cdt),
            nn.Identity(),
            Conv2d(outs[3], outs[3], 3, 2, 1, cdt=cdt)])
        self.scratch = Scratch(f, outs, cdt)

    def forward(self, tokens, hp, wp, out_hw):
        feats = [self.resize_layers[i](self.projects[i](
            t.transpose(1, 2).reshape(t.shape[0], -1, hp, wp))) for i, t in enumerate(tokens)]
        s = self.scratch
        rn = [getattr(s, f"layer{i + 1}_rn")(feats[i]) for i in range(4)]
        p = s.refinenet4(rn[3], size=rn[2].shape[-2:])
        p = s.refinenet3(p, rn[2], size=rn[1].shape[-2:])
        p = s.refinenet2(p, rn[1], size=rn[0].shape[-2:])
        p = s.refinenet1(p, rn[0])
        out = s.output_conv1(p)
        full = (hp * self.patch_size, wp * self.patch_size)
        return resize_via(out.float(), full, tuple(out_hw), "bilinear", align_corners=True)


class DepthAnything(nn.Module):
    def __init__(self, vit_size, cdt):
        super().__init__()
        c = VIT_CONFIGS[vit_size]
        self.intermediate_layers = c["intermediate_layers"]
        self.pretrained = DinoVisionTransformer(c["embed_dim"], c["depth"], c["num_heads"], cdt)
        self.depth_head = DPTHead(c["embed_dim"], c["dpt_features"], c["dpt_out_channels"], cdt)


class DepthAnythingFeature(nn.Module):
    """(B, 3, H, W) normalised RGB, H and W divisible by 14 -> the feature at ``out_hw``."""

    def __init__(self, vit_size, cdt):
        super().__init__()
        self.depth_anything = DepthAnything(vit_size, cdt)

    def forward(self, x, out_hw):
        da = self.depth_anything
        tokens = da.pretrained(x, da.intermediate_layers)
        return da.depth_head(tokens, x.shape[-2] // 14, x.shape[-1] // 14, out_hw)
