"""Building blocks (channel-first NCHW / NCDHW).

The port of the JAX package's ``models/layers.py``. Module and parameter
names follow the reference's torch modules, so a reference ``state_dict``
and the weight bridge (``convert/from_jax.py``) load by name.

Precision mirrors the JAX package's explicit casts: every convolution and
linear layer casts its input and weights to the module's compute dtype
``cdt`` (bf16 under mixed precision); batch, layer and group norms compute
in fp32 and return fp32 (flax promotes their bf16 inputs with the fp32
parameters); instance norm computes in fp32 and returns its input's dtype.
Parameters are stored in fp32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from foundationstereo_torch.ops.resize import resize2d


def leaky_relu(x):
    return F.leaky_relu(x, 0.01)


def gelu(x):
    return F.gelu(x)


def _cast(t, dt):
    return None if t is None else t.to(dt)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``cdt``."""

    def __init__(self, cin, cout, k, stride=1, padding=0, groups=1, bias=True,
                 cdt=torch.float32):
        super().__init__(cin, cout, k, stride, padding, groups=groups, bias=bias)
        self.cdt = cdt

    def forward(self, x):
        return self._conv_forward(x.to(self.cdt), self.weight.to(self.cdt),
                                  _cast(self.bias, self.cdt))


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` computing in ``cdt``."""

    def __init__(self, cin, cout, k, stride=1, padding=0, groups=1, bias=True,
                 cdt=torch.float32):
        super().__init__(cin, cout, k, stride, padding, groups=groups, bias=bias)
        self.cdt = cdt

    def forward(self, x):
        return self._conv_forward(x.to(self.cdt), self.weight.to(self.cdt),
                                  _cast(self.bias, self.cdt))


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in ``cdt``."""

    def __init__(self, cin, cout, k, stride=1, padding=0, bias=True, cdt=torch.float32):
        super().__init__(cin, cout, k, stride, padding, bias=bias)
        self.cdt = cdt

    def forward(self, x):
        return F.conv_transpose2d(x.to(self.cdt), self.weight.to(self.cdt),
                                  _cast(self.bias, self.cdt), self.stride, self.padding)


class ConvTranspose3d(nn.ConvTranspose3d):
    """``nn.ConvTranspose3d`` computing in ``cdt``."""

    def __init__(self, cin, cout, k, stride=1, padding=0, bias=True, cdt=torch.float32):
        super().__init__(cin, cout, k, stride, padding, bias=bias)
        self.cdt = cdt

    def forward(self, x):
        return F.conv_transpose3d(x.to(self.cdt), self.weight.to(self.cdt),
                                  _cast(self.bias, self.cdt), self.stride, self.padding)


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``cdt`` (over the last axis)."""

    def __init__(self, cin, cout, bias=True, cdt=torch.float32):
        super().__init__(cin, cout, bias)
        self.cdt = cdt

    def forward(self, x):
        return F.linear(x.to(self.cdt), self.weight.to(self.cdt), _cast(self.bias, self.cdt))


def conv_nd(is_3d: bool, *args, **kwargs):
    return (Conv3d if is_3d else Conv2d)(*args, **kwargs)


# ---------------------------------------------------------------------------
# Normalisation
# ---------------------------------------------------------------------------


class BatchNorm(nn.Module):
    """Inference batch norm over axis 1 (eps 1e-5) with the reference's
    parameter and buffer names; fp32 in, fp32 out."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        return F.batch_norm(x.float(), self.running_mean, self.running_var, self.weight,
                            self.bias, False, 0.0, self.eps)


class InstanceNorm(nn.Module):
    """Instance norm without affine parameters (eps 1e-5), in x's dtype."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x):
        return F.instance_norm(x.float(), eps=self.eps).to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis (flax's default eps 1e-6); fp32 out."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__(dim, eps=eps)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)


class LayerNorm2d(LayerNorm):
    """LayerNorm over the channel axis (1) of a channel-first tensor."""

    def forward(self, x):
        return super().forward(x.movedim(1, -1)).movedim(-1, 1)


class GroupNorm(nn.GroupNorm):
    """GroupNorm with C/8 groups (eps 1e-5); fp32 out."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__(channels // 8, channels, eps=eps)

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps)


def make_norm(kind: str, channels: int):
    """The reference's ``norm_fn`` strings."""
    if kind == "batch":
        return BatchNorm(channels)
    if kind == "instance":
        return InstanceNorm()
    if kind == "group":
        return GroupNorm(channels)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Composite blocks
# ---------------------------------------------------------------------------


class BasicConv(nn.Module):
    """conv or transposed conv (no bias) + optional norm + LeakyReLU."""

    def __init__(self, cin, cout, k, stride=1, padding=0, deconv=False, is_3d=False,
                 bn=True, norm="batch", cdt=torch.float32):
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
    """conv or transposed conv (no bias) + InstanceNorm + LeakyReLU."""

    def __init__(self, cin, cout, k, stride=1, padding=0, deconv=False, is_3d=False,
                 cdt=torch.float32):
        super().__init__(cin, cout, k, stride, padding, deconv=deconv, is_3d=is_3d,
                         norm="instance", cdt=cdt)


class ResnetBasicBlock(nn.Module):
    """Two bias-free convs with norms and a ReLU residual (2D or 3D)."""

    def __init__(self, channels, norm="batch", is_3d=False, cdt=torch.float32):
        super().__init__()
        self.conv1 = conv_nd(is_3d, channels, channels, 3, 1, 1, bias=False, cdt=cdt)
        self.bn1 = make_norm(norm, channels)
        self.conv2 = conv_nd(is_3d, channels, channels, 3, 1, 1, bias=False, cdt=cdt)
        self.bn2 = make_norm(norm, channels)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(x + y)


class ResidualBlock(nn.Module):
    """Extractor residual block: biased convs, norms, optional strided
    1x1 downsample of the shortcut."""

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
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class Conv3dNormActReduced(nn.Module):
    """Axial-planar 3D conv: (1, 3, 3) spatial then (17, 1, 1) disparity conv,
    each + BatchNorm + ReLU."""

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
        x = resize2d(x, tuple(rem.shape[-2:]), "bilinear", False)
    return x


class Conv2x(nn.Module):
    """Transposed conv 2x (k4/s2/p1), concat the skip, fuse conv to 2x the
    channels (the convex-upsample head's form)."""

    def __init__(self, cin, cout, bn=True, cdt=torch.float32):
        super().__init__()
        self.conv1 = BasicConv(cin, cout, 4, 2, 1, deconv=True, bn=bn, cdt=cdt)
        self.conv2 = BasicConv(cout * 2, cout * 2, 3, 1, 1, bn=bn, cdt=cdt)

    def forward(self, x, rem):
        return self.conv2(torch.cat([_match_hw(self.conv1(x), rem), rem], dim=1))


class Conv2xIN(nn.Module):
    """Transposed conv 2x + InstanceNorm, concat the skip, instance-norm
    residual block."""

    def __init__(self, cin, cout, cdt=torch.float32):
        super().__init__()
        self.conv1 = BasicConvIN(cin, cout, 4, 2, 1, deconv=True, cdt=cdt)
        self.conv2 = ResnetBasicBlock(cout * 2, norm="instance", cdt=cdt)

    def forward(self, x, rem):
        x = _match_hw(self.conv1(x), rem)
        return self.conv2(torch.cat([x, rem], dim=1))


class FeatureAtt(nn.Module):
    """Sigmoid gating of a cost volume (B, C, D, H, W) by 2D features (B, Cf, H, W)."""

    def __init__(self, cv_chan, feat_chan, cdt=torch.float32):
        super().__init__()
        self.feat_att = nn.Sequential(
            BasicConv(feat_chan, feat_chan // 2, 1, 1, 0, cdt=cdt),
            Conv2d(feat_chan // 2, cv_chan, 1, cdt=cdt))

    def forward(self, cv, feat):
        att = self.feat_att(feat)
        return torch.sigmoid(att.to(cv.dtype))[:, :, None] * cv


class ChannelAttentionEnhancement(nn.Module):
    """SE-style channel attention."""

    def __init__(self, channels, cdt=torch.float32):
        super().__init__()
        self.fc = nn.Sequential(Conv2d(channels, channels // 16, 1, bias=False, cdt=cdt),
                                nn.ReLU(),
                                Conv2d(channels // 16, channels, 1, bias=False, cdt=cdt))

    def forward(self, x):
        avg = x.mean(dim=(2, 3), keepdim=True)
        mx = x.amax(dim=(2, 3), keepdim=True)
        return torch.sigmoid(self.fc(avg) + self.fc(mx))


class SpatialAttentionExtractor(nn.Module):
    """7x7 conv over the [mean, max] channel maps -> sigmoid spatial attention."""

    def __init__(self, k=7, cdt=torch.float32):
        super().__init__()
        self.samconv = Conv2d(2, 1, k, 1, k // 2, bias=False, cdt=cdt)

    def forward(self, x):
        s = torch.cat([x.mean(dim=1, keepdim=True), x.amax(dim=1, keepdim=True)], dim=1)
        return torch.sigmoid(self.samconv(s))


class EdgeNextConvEncoder(nn.Module):
    """Depthwise 7x7 conv + pointwise MLP (4x) + layer scale, residual (the
    disparity head's form: no norm)."""

    def __init__(self, dim, cdt=torch.float32):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 7, 1, 3, groups=dim, cdt=cdt)
        self.pwconv1 = Linear(dim, 4 * dim, cdt=cdt)
        self.pwconv2 = Linear(4 * dim, dim, cdt=cdt)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x):
        y = self.pwconv2(gelu(self.pwconv1(self.dwconv(x).movedim(1, -1))))
        y = self.gamma.to(y.dtype) * y
        return x + y.movedim(-1, 1)


# ---------------------------------------------------------------------------
# Disparity transformer
# ---------------------------------------------------------------------------


def sinusoidal_position_embedding(max_len: int, d_model: int) -> np.ndarray:
    """(1, max_len, d_model) sinusoidal table."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * -(math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), np.float64)
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe[None].astype(np.float32)


class MultiheadAttention(nn.Module):
    """Softmax attention with separate q/k/v/out projections (short sequences:
    max_disp/16 tokens, so plain einsums)."""

    def __init__(self, embed_dim, num_heads, cdt=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = Linear(embed_dim, embed_dim, cdt=cdt)
        self.k_proj = Linear(embed_dim, embed_dim, cdt=cdt)
        self.v_proj = Linear(embed_dim, embed_dim, cdt=cdt)
        self.out_proj = Linear(embed_dim, embed_dim, cdt=cdt)

    def forward(self, q, k, v):
        B, L, C = q.shape
        hd = C // self.num_heads
        qp = self.q_proj(q).reshape(B, L, self.num_heads, hd)
        kp = self.k_proj(k).reshape(B, -1, self.num_heads, hd)
        vp = self.v_proj(v).reshape(B, -1, self.num_heads, hd)
        logits = torch.einsum("blhd,bmhd->bhlm", qp, kp) * (1.0 / math.sqrt(hd))
        w = torch.softmax(logits.float(), dim=-1).to(vp.dtype)
        out = torch.einsum("bhlm,bmhd->blhd", w, vp).reshape(B, L, C)
        return self.out_proj(out)


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer with a GELU feed-forward (inference: no dropout)."""

    def __init__(self, embed_dim, num_heads, dim_feedforward, cdt=torch.float32):
        super().__init__()
        self.self_attn = MultiheadAttention(embed_dim, num_heads, cdt=cdt)
        self.linear1 = Linear(embed_dim, dim_feedforward, cdt=cdt)
        self.linear2 = Linear(dim_feedforward, embed_dim, cdt=cdt)
        self.norm1 = LayerNorm(embed_dim)
        self.norm2 = LayerNorm(embed_dim)

    def forward(self, x):
        x = self.norm1(x + self.self_attn(x, x, x))
        return self.norm2(x + self.linear2(gelu(self.linear1(x))))


class CostVolumeDisparityAttention(nn.Module):
    """Self-attention along the disparity axis of a (B, C, D, H, W) volume:
    every (h, w) location is an independent D-token sequence."""

    def __init__(self, d_model, nhead=4, dim_feedforward=None, num_transformer=4,
                 max_len=512, cdt=torch.float32):
        super().__init__()
        self.max_len = max_len
        ff = dim_feedforward or d_model
        self.sa = nn.ModuleList(TransformerEncoderLayer(d_model, nhead, ff, cdt=cdt)
                                for _ in range(num_transformer))

    def forward(self, cv):
        B, C, D, H, W = cv.shape
        x = cv.permute(0, 3, 4, 2, 1).reshape(B * H * W, D, C)
        pe = torch.from_numpy(sinusoidal_position_embedding(self.max_len, C))
        x = x + pe[:, :D].to(device=x.device, dtype=x.dtype)
        for layer in self.sa:
            x = layer(x)
        return x.reshape(B, H, W, D, C).permute(0, 4, 3, 1, 2)
