"""Layers of the reference model (channel-first NCHW / NCDHW).

Module and parameter names are those of the published model's ``state_dict``,
so one set of weights loads into the program and into the reference alike.
Every convolution and linear layer reads its input and weights in the
compute dtype ``cdt`` (fp32 for the reference; bf16 or fp8 for what it is
compared with); norms compute in fp32.

Training: batch norm takes the batch's mean and biased variance E[x^2] -
E[x]^2 and moves its running stats toward them (momentum 0.1); the
disparity transformer's dropouts draw their masks from the generator that
``Dropout`` holds while a train-mode forward runs.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.ops import cast, leaky_relu, resize


class Dropout:
    """The generator of train-mode dropout, set by the caller around a
    forward (``with Dropout.drawing(gen): ...``)."""

    gen: torch.Generator | None = None

    class drawing:
        def __init__(self, gen):
            self.gen = gen

        def __enter__(self):
            self.prev, Dropout.gen = Dropout.gen, self.gen

        def __exit__(self, *exc):
            Dropout.gen = self.prev


def dropout(x: torch.Tensor, rate: float, training: bool) -> torch.Tensor:
    """Keep where a uniform draw is below 1 - rate, scaled by 1 / (1 - rate)."""
    if not training or rate == 0.0:
        return x
    if Dropout.gen is None:
        raise RuntimeError("train-mode dropout needs a generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=Dropout.gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class Conv2d(nn.Conv2d):
    def __init__(self, cin, cout, k, stride=1, padding=0, groups=1, bias=True, cdt=torch.float32):
        super().__init__(cin, cout, k, stride, padding, groups=groups, bias=bias)
        self.cdt = cdt

    def forward(self, x):
        return F.conv2d(cast(x, self.cdt), cast(self.weight, self.cdt), cast(self.bias, self.cdt),
                        self.stride, self.padding, self.dilation, self.groups)


class Conv3d(nn.Conv3d):
    def __init__(self, cin, cout, k, stride=1, padding=0, groups=1, bias=True, cdt=torch.float32):
        super().__init__(cin, cout, k, stride, padding, groups=groups, bias=bias)
        self.cdt = cdt

    def forward(self, x):
        return F.conv3d(cast(x, self.cdt), cast(self.weight, self.cdt), cast(self.bias, self.cdt),
                        self.stride, self.padding, self.dilation, self.groups)


class ConvTranspose2d(nn.ConvTranspose2d):
    def __init__(self, cin, cout, k, stride=1, padding=0, bias=True, cdt=torch.float32):
        super().__init__(cin, cout, k, stride, padding, bias=bias)
        self.cdt = cdt

    def forward(self, x):
        return F.conv_transpose2d(cast(x, self.cdt), cast(self.weight, self.cdt),
                                  cast(self.bias, self.cdt), self.stride, self.padding)


class ConvTranspose3d(nn.ConvTranspose3d):
    def __init__(self, cin, cout, k, stride=1, padding=0, bias=True, cdt=torch.float32):
        super().__init__(cin, cout, k, stride, padding, bias=bias)
        self.cdt = cdt

    def forward(self, x):
        return F.conv_transpose3d(cast(x, self.cdt), cast(self.weight, self.cdt),
                                  cast(self.bias, self.cdt), self.stride, self.padding)


class Linear(nn.Linear):
    def __init__(self, cin, cout, bias=True, cdt=torch.float32):
        super().__init__(cin, cout, bias)
        self.cdt = cdt

    def forward(self, x):
        return F.linear(cast(x, self.cdt), cast(self.weight, self.cdt), cast(self.bias, self.cdt))


def conv_nd(is_3d, *args, **kwargs):
    return (Conv3d if is_3d else Conv2d)(*args, **kwargs)


class BatchNorm(nn.Module):
    def __init__(self, channels, eps=1e-5, momentum=0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        x = x.float()
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        axes = [0] + list(range(2, x.ndim))
        mean = x.mean(axes)
        var = ((x * x).mean(axes) - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1 - self.momentum).add_(self.momentum * var)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)


class InstanceNorm(nn.Module):
    def forward(self, x):
        return F.instance_norm(x.float(), eps=1e-5)


class LayerNorm(nn.LayerNorm):
    """Over the last axis, eps 1e-6."""

    def __init__(self, dim, eps=1e-6):
        super().__init__(dim, eps=eps)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)


class LayerNorm2d(LayerNorm):
    def forward(self, x):
        return super().forward(x.movedim(1, -1)).movedim(-1, 1)


class GroupNorm(nn.GroupNorm):
    def __init__(self, channels, eps=1e-5):
        super().__init__(channels // 8, channels, eps=eps)

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps)


def make_norm(kind, channels):
    return {"batch": BatchNorm, "instance": lambda c: InstanceNorm(),
            "group": GroupNorm}[kind](channels)


class BasicConv(nn.Module):
    """conv or transposed conv (no bias) + optional norm + LeakyReLU."""

    def __init__(self, cin, cout, k, stride=1, padding=0, deconv=False, is_3d=False, bn=True,
                 norm="batch", cdt=torch.float32):
        super().__init__()
        if deconv:
            cls = ConvTranspose3d if is_3d else ConvTranspose2d
            self.conv = cls(cin, cout, k, stride, padding, bias=False, cdt=cdt)
        else:
            self.conv = conv_nd(is_3d, cin, cout, k, stride, padding, bias=False, cdt=cdt)
        self.bn = make_norm(norm, cout) if bn else nn.Identity()

    def forward(self, x):
        return leaky_relu(self.bn(self.conv(x)))


class BasicConvIN(BasicConv):
    def __init__(self, cin, cout, k, stride=1, padding=0, deconv=False, is_3d=False,
                 cdt=torch.float32):
        super().__init__(cin, cout, k, stride, padding, deconv, is_3d, norm="instance", cdt=cdt)


class ResnetBasicBlock(nn.Module):
    def __init__(self, channels, norm="batch", is_3d=False, cdt=torch.float32):
        super().__init__()
        self.conv1 = conv_nd(is_3d, channels, channels, 3, 1, 1, bias=False, cdt=cdt)
        self.bn1 = make_norm(norm, channels)
        self.conv2 = conv_nd(is_3d, channels, channels, 3, 1, 1, bias=False, cdt=cdt)
        self.bn2 = make_norm(norm, channels)

    def forward(self, x):
        y = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        return F.relu(x + y)


class ResidualBlock(nn.Module):
    def __init__(self, cin, cout, norm, stride=1, cdt=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(cin, cout, 3, stride, 1, cdt=cdt)
        self.norm1 = make_norm(norm, cout)
        self.conv2 = Conv2d(cout, cout, 3, 1, 1, cdt=cdt)
        self.norm2 = make_norm(norm, cout)
        self.downsample = None
        if not (stride == 1 and cin == cout):
            self.downsample = nn.Sequential(Conv2d(cin, cout, 1, stride, cdt=cdt),
                                            make_norm(norm, cout))

    def forward(self, x):
        y = F.relu(self.norm2(self.conv2(F.relu(self.norm1(self.conv1(x))))))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class Conv3dNormActReduced(nn.Module):
    def __init__(self, cin, cout, cdt=torch.float32):
        super().__init__()
        self.conv1 = nn.Sequential(Conv3d(cin, cout, (1, 3, 3), 1, (0, 1, 1), cdt=cdt),
                                   BatchNorm(cout), nn.ReLU())
        self.conv2 = nn.Sequential(Conv3d(cout, cout, (17, 1, 1), 1, (8, 0, 0), cdt=cdt),
                                   BatchNorm(cout), nn.ReLU())

    def forward(self, x):
        return self.conv2(self.conv1(x))


def _match_hw(x, rem):
    if x.shape[-2:] != rem.shape[-2:]:
        x = resize(x, tuple(rem.shape[-2:]), "bilinear", False)
    return x


class Conv2x(nn.Module):
    def __init__(self, cin, cout, bn=True, cdt=torch.float32):
        super().__init__()
        self.conv1 = BasicConv(cin, cout, 4, 2, 1, deconv=True, bn=bn, cdt=cdt)
        self.conv2 = BasicConv(cout * 2, cout * 2, 3, 1, 1, bn=bn, cdt=cdt)

    def forward(self, x, rem):
        return self.conv2(torch.cat([_match_hw(self.conv1(x), rem).float(), rem.float()], dim=1))


class Conv2xIN(nn.Module):
    def __init__(self, cin, cout, cdt=torch.float32):
        super().__init__()
        self.conv1 = BasicConvIN(cin, cout, 4, 2, 1, deconv=True, cdt=cdt)
        self.conv2 = ResnetBasicBlock(cout * 2, norm="instance", cdt=cdt)

    def forward(self, x, rem):
        x = _match_hw(self.conv1(x), rem)
        return self.conv2(torch.cat([x.float(), rem.float()], dim=1))


class FeatureAtt(nn.Module):
    def __init__(self, cv_chan, feat_chan, cdt=torch.float32):
        super().__init__()
        self.feat_att = nn.Sequential(BasicConv(feat_chan, feat_chan // 2, 1, 1, 0, cdt=cdt),
                                      Conv2d(feat_chan // 2, cv_chan, 1, cdt=cdt))

    def forward(self, cv, feat):
        return torch.sigmoid(self.feat_att(feat).float())[:, :, None] * cv.float()


class ChannelAttentionEnhancement(nn.Module):
    def __init__(self, channels, cdt=torch.float32):
        super().__init__()
        self.fc = nn.Sequential(Conv2d(channels, channels // 16, 1, bias=False, cdt=cdt), nn.ReLU(),
                                Conv2d(channels // 16, channels, 1, bias=False, cdt=cdt))

    def forward(self, x):
        avg, mx = x.mean(dim=(2, 3), keepdim=True), x.amax(dim=(2, 3), keepdim=True)
        return torch.sigmoid(self.fc(avg) + self.fc(mx))


class SpatialAttentionExtractor(nn.Module):
    def __init__(self, k=7, cdt=torch.float32):
        super().__init__()
        self.samconv = Conv2d(2, 1, k, 1, k // 2, bias=False, cdt=cdt)

    def forward(self, x):
        s = torch.cat([x.mean(dim=1, keepdim=True), x.amax(dim=1, keepdim=True)], dim=1)
        return torch.sigmoid(self.samconv(s))


class EdgeNextConvEncoder(nn.Module):
    """Depthwise 7x7 conv + pointwise MLP (4x) + layer scale, residual."""

    def __init__(self, dim, cdt=torch.float32):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 7, 1, 3, groups=dim, cdt=cdt)
        self.pwconv1 = Linear(dim, 4 * dim, cdt=cdt)
        self.pwconv2 = Linear(4 * dim, dim, cdt=cdt)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x):
        y = self.pwconv2(F.gelu(self.pwconv1(self.dwconv(x).movedim(1, -1))))
        return x + (self.gamma * y).movedim(-1, 1)


def sinusoidal_position_embedding(max_len: int, d_model: int) -> np.ndarray:
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * -(math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), np.float64)
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe[None].astype(np.float32)


class MultiheadAttention(nn.Module):
    def __init__(self, embed_dim, num_heads, cdt=torch.float32):
        super().__init__()
        self.num_heads, self.cdt = num_heads, cdt
        self.q_proj = Linear(embed_dim, embed_dim, cdt=cdt)
        self.k_proj = Linear(embed_dim, embed_dim, cdt=cdt)
        self.v_proj = Linear(embed_dim, embed_dim, cdt=cdt)
        self.out_proj = Linear(embed_dim, embed_dim, cdt=cdt)

    def forward(self, x):
        B, L, C = x.shape
        h, dt = self.num_heads, self.cdt
        q, k, v = (cast(p(x), dt).reshape(B, L, h, C // h)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        logits = torch.einsum("blhd,bmhd->bhlm", q, k) * (1.0 / math.sqrt(C // h))
        w = cast(torch.softmax(logits.float(), dim=-1), dt)
        return self.out_proj(torch.einsum("bhlm,bmhd->blhd", w, v).reshape(B, L, C))


class TransformerEncoderLayer(nn.Module):
    """Post-norm layer with a GELU feed-forward and dropout 0.1 in training."""

    def __init__(self, embed_dim, num_heads, dim_feedforward, rate=0.1, cdt=torch.float32):
        super().__init__()
        self.rate = rate
        self.self_attn = MultiheadAttention(embed_dim, num_heads, cdt)
        self.linear1 = Linear(embed_dim, dim_feedforward, cdt=cdt)
        self.linear2 = Linear(dim_feedforward, embed_dim, cdt=cdt)
        self.norm1 = LayerNorm(embed_dim)
        self.norm2 = LayerNorm(embed_dim)

    def forward(self, x):
        def drop(t):
            return dropout(t, self.rate, self.training)

        x = self.norm1(x + drop(self.self_attn(x)))
        return self.norm2(x + drop(self.linear2(drop(F.gelu(self.linear1(x))))))


class CostVolumeDisparityAttention(nn.Module):
    """Self-attention along D at every (h, w) of a (B, C, D, H, W) volume."""

    def __init__(self, d_model, nhead=4, dim_feedforward=None, num_transformer=4, max_len=512,
                 cdt=torch.float32):
        super().__init__()
        self.max_len = max_len
        self.sa = nn.ModuleList(TransformerEncoderLayer(d_model, nhead, dim_feedforward or d_model,
                                                        cdt=cdt) for _ in range(num_transformer))

    def forward(self, cv):
        B, C, D, H, W = cv.shape
        x = cv.float().permute(0, 3, 4, 2, 1).reshape(B * H * W, D, C)
        pe = torch.from_numpy(sinusoidal_position_embedding(self.max_len, C))
        x = x + pe[:, :D].to(x.device)
        for layer in self.sa:
            x = layer(x)
        return x.reshape(B, H, W, D, C).permute(0, 4, 3, 1, 2)
