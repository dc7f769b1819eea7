"""The reference FoundationStereo: features -> group-wise and concatenation
cost volume -> correlation stem -> hourglass with the disparity transformer
-> soft-argmin -> context network -> geometry and correlation pyramids ->
GRU refinement steps with pyramid lookups -> convex upsampling.

Plain PyTorch with dense volumes and dense attention, no kernels, no
caching of derived weights, no checkpointing. ``cdt`` is the compute dtype
of every convolution, linear layer and attention product and of the tensors
the published mixed-precision model stores in it (the volumes, the lookup
features, the pyramids): fp32 for the reference; fp8 for the lower-precision
control (``ops.cast``). Everything else is fp32.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference import edgenext
from portbench.reference.nn import (
    BasicConv, BasicConvIN, BatchNorm, ChannelAttentionEnhancement, Conv2d, Conv2x, Conv2xIN,
    Conv3d, Conv3dNormActReduced, ConvTranspose2d, CostVolumeDisparityAttention,
    EdgeNextConvEncoder, FeatureAtt, InstanceNorm, ResidualBlock, ResnetBasicBlock,
    SpatialAttentionExtractor,
)
from portbench.reference.ops import (
    all_pairs_correlation, avg_pool2x, cast, concat_volume, context_upsample,
    disparity_lookup, disparity_regression, gwc_volume, normalize_image, pool_last_axis,
    resize, resize_keep_aspect,
)
from portbench.reference.vit import VIT_CONFIGS, DepthAnythingFeature, LayerScale

# ---------------------------------------------------------------------------
# features
# ---------------------------------------------------------------------------


def vit_feat_dim(vit_size: str) -> int:
    return VIT_CONFIGS[vit_size]["dpt_features"] // 2


def feature_dims(vit_size: str) -> list[int]:
    c = edgenext.DIMS
    return [c[0] * 2 + vit_feat_dim(vit_size), c[1] * 2, c[2] * 2, c[3]]


class Feature(nn.Module):
    def __init__(self, vit_size, cdt):
        super().__init__()
        c = edgenext.DIMS
        self.stem, self.stages = edgenext.make_edgenext(cdt)
        self.deconv32_16 = Conv2xIN(c[3], c[2], cdt=cdt)
        self.deconv16_8 = Conv2xIN(c[2] * 2, c[1], cdt=cdt)
        self.deconv8_4 = Conv2xIN(c[1] * 2, c[0], cdt=cdt)
        c4 = c[0] * 2 + vit_feat_dim(vit_size)
        self.conv4 = nn.Sequential(BasicConv(c4, c4, 3, 1, 1, norm="instance", cdt=cdt),
                                   ResidualBlock(c4, c4, "instance", cdt=cdt),
                                   ResidualBlock(c4, c4, "instance", cdt=cdt))
        self.dino = DepthAnythingFeature(vit_size, cdt)
        self.dino.requires_grad_(False)

    def forward(self, x):
        H, W = x.shape[-2:]
        hr, wr = resize_keep_aspect(H, W, 112, 1344, 1344)
        with torch.no_grad():
            vit = self.dino(resize(x.float(), (hr, wr), "bicubic"), (H // 4, W // 4))
        x = self.stem(x)
        feats = []
        for stage in self.stages:
            x = stage(x)
            feats.append(x)
        x4, x8, x16, x32 = feats
        x16 = self.deconv32_16(x32, x16)
        x8 = self.deconv16_8(x16, x8)
        x4 = self.deconv8_4(x8, x4)
        x4 = self.conv4(torch.cat([x4.float(), vit.float()], dim=1))
        return [x4, x8, x16, x32], vit


class ContextNetDino(nn.Module):
    def __init__(self, vit_size, hidden_dims, n_downsample, cdt, norm="batch"):
        super().__init__()
        down = n_downsample

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
        self.conv2 = BasicConv(128 + vit_feat_dim(vit_size), 128, 3, 1, 1, cdt=cdt)
        self.outputs04 = nn.ModuleList(head(hidden_dims[2]) for _ in range(2))
        self.outputs08 = nn.ModuleList(head(hidden_dims[1]) for _ in range(2))
        self.layer4 = layer(128, 128, 2)
        self.layer5 = layer(128, 128, 2)
        self.outputs16 = nn.ModuleList(Conv2d(128, hidden_dims[0], 3, 1, 1, cdt=cdt)
                                       for _ in range(2))

    def forward(self, x, vit):
        x = F.relu(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        x = self.conv2(torch.cat([x.float(), vit.float()], dim=1))
        y = self.layer4(x)
        z = self.layer5(y)
        return [tuple(f(x) for f in self.outputs04), tuple(f(y) for f in self.outputs08),
                tuple(f(z) for f in self.outputs16)]


class Stem2(nn.Sequential):
    def __init__(self, cdt):
        super().__init__(BasicConvIN(3, 32, 3, 2, 1, cdt=cdt),
                         Conv2d(32, 32, 3, 1, 1, bias=False, cdt=cdt), InstanceNorm(), nn.ReLU())


# ---------------------------------------------------------------------------
# cost filtering
# ---------------------------------------------------------------------------


class Hourglass(nn.Module):
    def __init__(self, c, max_disp, feat_dims, cdt):
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

        self.conv1, self.conv2, self.conv3 = down(c, 2 * c), down(2 * c, 4 * c), down(4 * c, 6 * c)
        self.conv3_up, self.conv2_up, self.conv1_up = up(6 * c, 4 * c), up(4 * c, 2 * c), up(2 * c, c)
        self.agg_0, self.agg_1 = agg(8 * c, 4 * c), agg(4 * c, 2 * c)
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

    def forward(self, x, f):
        c1 = self.feature_att_8(self.conv1(x), f[1])
        c2 = self.feature_att_16(self.conv2(c1), f[2])
        c3 = self.feature_att_32(self.conv3(c2), f[3])
        c2 = self.feature_att_up_16(self.agg_0(torch.cat([self.conv3_up(c3), c2], dim=1)), f[2])
        c1 = self.feature_att_up_8(self.agg_1(torch.cat([self.conv2_up(c2), c1], dim=1)), f[1])
        p = self.atts["4"](self.conv_patch(x))
        p = resize(p, tuple(s * 4 for s in p.shape[-3:]), "trilinear")
        return self.conv_out(self.conv1_up(c1) + p)


class CorrStem(nn.Sequential):
    """1x1x1 projection of the (gwc, concat) volume, then 3D convs."""

    def __init__(self, in_dim, volume_dim, cdt):
        super().__init__(Conv3d(in_dim, volume_dim, 1, cdt=cdt),
                         BasicConv(volume_dim, volume_dim, 3, 1, 1, is_3d=True, cdt=cdt),
                         ResnetBasicBlock(volume_dim, is_3d=True, cdt=cdt),
                         ResnetBasicBlock(volume_dim, is_3d=True, cdt=cdt))


class Classifier(nn.Sequential):
    """(B, C, D, H, W) -> (B, D, H, W) logits."""

    def __init__(self, volume_dim, cdt):
        c = volume_dim // 2
        super().__init__(BasicConv(volume_dim, c, 3, 1, 1, is_3d=True, cdt=cdt),
                         ResnetBasicBlock(c, is_3d=True, cdt=cdt),
                         Conv3d(c, 1, 7, 1, 3, cdt=cdt))

    def forward(self, x):
        return super().forward(x)[:, 0]


# ---------------------------------------------------------------------------
# refinement
# ---------------------------------------------------------------------------


class DispHead(nn.Module):
    def __init__(self, dim, cdt):
        super().__init__()
        self.conv = nn.Sequential(Conv2d(dim, dim, 3, 1, 1, cdt=cdt), nn.ReLU(),
                                  EdgeNextConvEncoder(dim, cdt), EdgeNextConvEncoder(dim, cdt),
                                  Conv2d(dim, 1, 3, 1, 1, cdt=cdt))

    def forward(self, x):
        return self.conv(x)


class RaftConvGRU(nn.Module):
    def __init__(self, hidden, inputs, k, cdt):
        super().__init__()
        self.convz = Conv2d(hidden + inputs, hidden, k, 1, k // 2, cdt=cdt)
        self.convr = Conv2d(hidden + inputs, hidden, k, 1, k // 2, cdt=cdt)
        self.convq = Conv2d(hidden + inputs, hidden, k, 1, k // 2, cdt=cdt)

    def forward(self, h, x, hx):
        z, r = torch.sigmoid(self.convz(hx)), torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q


class SelectiveConvGRU(nn.Module):
    def __init__(self, hidden, inputs, cdt):
        super().__init__()
        self.conv0 = nn.Sequential(Conv2d(inputs, inputs, 3, 1, 1, cdt=cdt), nn.ReLU())
        self.conv1 = nn.Sequential(Conv2d(inputs + hidden, inputs + hidden, 3, 1, 1, cdt=cdt),
                                   nn.ReLU())
        self.small_gru = RaftConvGRU(hidden, inputs, 1, cdt)
        self.large_gru = RaftConvGRU(hidden, inputs, 3, cdt)

    def forward(self, att, h, *xs):
        x = self.conv0(torch.cat([t.float() for t in xs], dim=1))
        hx = self.conv1(torch.cat([x, h.float()], dim=1))
        return self.small_gru(h, x, hx) * att + self.large_gru(h, x, hx) * (1 - att)


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_channels, cdt):
        super().__init__()
        self.convc1 = Conv2d(corr_channels, 256, 1, cdt=cdt)
        self.convc2 = Conv2d(256, 256, 3, 1, 1, cdt=cdt)
        self.convd1 = Conv2d(1, 64, 7, 1, 3, cdt=cdt)
        self.convd2 = Conv2d(64, 64, 3, 1, 1, cdt=cdt)
        self.conv = Conv2d(256 + 64, 127, 3, 1, 1, cdt=cdt)

    def forward(self, disp, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        d = F.relu(self.convd2(F.relu(self.convd1(disp))))
        return torch.cat([F.relu(self.conv(torch.cat([cor, d], dim=1))), disp.float()], dim=1)


class BasicSelectiveMultiUpdateBlock(nn.Module):
    """Coarse-to-fine GRU update over [1/4, 1/8, 1/16] (three GRU levels)."""

    def __init__(self, hidden, corr_channels, cdt):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_channels, cdt)
        self.gru16 = SelectiveConvGRU(hidden, hidden * 2, cdt)
        self.gru08 = SelectiveConvGRU(hidden, hidden * 3, cdt)
        self.gru04 = SelectiveConvGRU(hidden, hidden + 256, cdt)
        self.disp_head = DispHead(hidden, cdt)
        self.mask = nn.Sequential(Conv2d(hidden, 64, 3, 1, 1, cdt=cdt), nn.ReLU(),
                                  Conv2d(64, 32, 3, 1, 1, cdt=cdt), nn.ReLU())

    def forward(self, net, inp, corr, disp, att):
        def up(x, dest):
            return resize(x.float(), tuple(dest.shape[-2:]), "bilinear", align_corners=True)

        net = list(net)
        net[2] = self.gru16(att[2], net[2], inp[2], avg_pool2x(net[1].float()))
        net[1] = self.gru08(att[1], net[1], inp[1], avg_pool2x(net[0].float()), up(net[2], net[1]))
        motion = torch.cat([inp[0].float(), self.encoder(disp, corr)], dim=1)
        net[0] = self.gru04(att[0], net[0], motion, up(net[1], net[0]))
        return net, 0.25 * self.mask(net[0]), self.disp_head(net[0])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


class FoundationStereo(nn.Module):
    """``forward(left, right, iters, test_mode)`` on (B, H, W, 3) RGB in
    0-255 with H and W divisible by 32: the (B, H, W) disparity in test
    mode, else the (B, H/4, W/4) initial disparity and the ``iters``
    full-resolution disparities. ``taps``, when a dict, receives the
    classifier's logits under "classifier", the filter stack's input (the
    cost volume after ``corr_stem``) under "volume" and the context
    network's outputs, (h, c) per level, under "context"."""

    def __init__(self, cfg: dict, cdt: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.cdt = cfg, cdt
        # Recompute each refinement step in the backward (memory only).
        self.remat = False
        vit, hidden = cfg["vit_size"], tuple(cfg["hidden_dims"])
        dims = feature_dims(vit)
        vd, radius, levels = cfg["volume_dim"], cfg["corr_radius"], cfg["corr_levels"]
        self.feature = Feature(vit, cdt)
        self.stem_2 = Stem2(cdt)
        self.proj_cmb = Conv2d(dims[0], 12, 1, cdt=cdt)
        self.corr_stem = CorrStem(cfg["cv_group"] + 2 * 12, vd, cdt)
        self.corr_feature_att = FeatureAtt(vd, dims[0], cdt)
        self.cost_agg = Hourglass(vd, cfg["max_disp"], dims, cdt)
        self.classifier = Classifier(vd, cdt)
        self.cnet = ContextNetDino(vit, hidden, cfg["n_downsample"], cdt)
        self.cam = ChannelAttentionEnhancement(hidden[0], cdt)
        self.sam = SpatialAttentionExtractor(cdt=cdt)
        self.update_block = BasicSelectiveMultiUpdateBlock(
            hidden[0], levels * (vd + 1) * (2 * radius + 1), cdt)
        self.spx_2_gru = Conv2x(32, 32, bn=False, cdt=cdt)
        self.spx_gru = nn.Sequential(ConvTranspose2d(64, 9, 4, 2, 1, cdt=cdt))

    def forward(self, left, right, iters, test_mode=False, taps=None):
        cfg, dt = self.cfg, self.cdt
        B, D = left.shape[0], cfg["max_disp"] // 4
        img1 = cast(normalize_image(left), dt)
        img2 = cast(normalize_image(right), dt)
        out, vit = self.feature(torch.cat([img1, img2], dim=0))
        vit = vit[:B]
        fl, fr = [o[:B] for o in out], [o[B:] for o in out]
        stem_2x = self.stem_2(img1)

        gwc = cast(gwc_volume(fl[0], fr[0], D, cfg["cv_group"]), dt)
        cat = cast(concat_volume(self.proj_cmb(fl[0]).float(), self.proj_cmb(fr[0]).float(), D), dt)
        comb = self.corr_stem(torch.cat([gwc.float(), cat.float()], dim=1))
        del gwc, cat
        if taps is not None:
            taps["volume"] = comb
        comb = self.corr_feature_att(comb, fl[0])
        comb = self.cost_agg(comb, fl)
        logits = self.classifier(comb).float()
        if taps is not None:
            taps["classifier"] = logits
        init_disp = disparity_regression(torch.softmax(logits, dim=1), D)

        cnet = self.cnet(img1, vit)
        if taps is not None:
            taps["context"] = [t for pair in cnet for t in pair]
        net = [torch.tanh(h.float()) for h, _ in cnet]
        inp = [torch.relu(c.float()) for _, c in cnet]
        inp = [self.cam(x) * x for x in inp]
        att = [self.sam(x) for x in inp]

        geo = pool_last_axis(comb.float().permute(0, 3, 4, 1, 2), cfg["corr_levels"] - 1)
        corr = pool_last_axis(all_pairs_correlation(fl[0], fr[0]), cfg["corr_levels"] - 1)
        geo = [cast(g, dt).float() for g in geo]
        corr = [cast(c, dt).float() for c in corr]
        del comb

        def refine(net, disp):
            feat = cast(disparity_lookup(geo, corr, disp, cfg["corr_radius"]), dt)
            net, mask_feat, delta = self.update_block(net, inp, feat, cast(disp[:, None], dt), att)
            return net, disp + delta[:, 0].float(), mask_feat

        def run(fn, *args):
            if self.remat and torch.is_grad_enabled():
                return checkpoint(fn, *args, use_reentrant=False)
            return fn(*args)

        disp = init_disp.float()
        mask_feat = None
        preds = []
        for _ in range(iters):
            net, disp, mask_feat = run(refine, net, disp.detach())
            if not test_mode:
                preds.append(run(self.upsample, disp, mask_feat, stem_2x))
        if test_mode:
            return self.upsample(disp, mask_feat, stem_2x)
        return init_disp, preds

    def upsample(self, disp, mask_feat, stem_2x):
        spx = torch.softmax(self.spx_gru(self.spx_2_gru(mask_feat, stem_2x)).float(), dim=1)
        return context_upsample(disp * 4.0, spx)


# ---------------------------------------------------------------------------
# weights from a seed
# ---------------------------------------------------------------------------

TRUNC = 0.87962566103423978     # the std of a unit normal truncated to [-2, 2]


@torch.no_grad()
def init_weights(model: nn.Module, gen: torch.Generator) -> None:
    """Seeded weights by the published model's initialisation rule, drawn in
    two large calls: conv and linear weights truncated-normal (std
    sqrt(1 / fan_in) / 0.8796, cut at 2 std; fan_in as flax counts it), the
    ViT's position embedding normal(0, 0.02); zero biases, class token and
    running means; EdgeNeXt layer scales 1e-6; every other parameter and
    the running variances 1."""
    trunc, normal = [], []
    for m in model.modules():
        for leaf, p in m.named_parameters(recurse=False):
            if leaf == "weight" and p.ndim >= 2:
                transposed = isinstance(m, (nn.ConvTranspose2d, nn.ConvTranspose3d))
                fan_in = p.shape[0] * p[0, 0].numel() if transposed else p[0].numel()
                trunc.append((p, math.sqrt(1.0 / fan_in) / TRUNC))
            elif leaf in ("bias", "cls_token"):
                p.zero_()
            elif leaf == "pos_embed":
                normal.append((p, 0.02))
            elif leaf in ("gamma", "gamma_xca") and not isinstance(m, LayerScale):
                p.fill_(1e-6)
            else:
                p.fill_(1.0)
    for group, draw in ((trunc, lambda t: nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, gen)),
                        (normal, lambda t: t.normal_(0.0, 1.0, generator=gen))):
        if not group:
            continue
        flat = torch.empty(sum(p.numel() for p, _ in group), device=group[0][0].device)
        draw(flat)
        i = 0
        for p, std in group:
            p.copy_(flat[i:i + p.numel()].view_as(p) * std)
            i += p.numel()
    for name, b in model.named_buffers():
        b.fill_(1.0 if name.endswith("running_var") else 0.0)


def build(cfg: dict, device, seed: int, cdt: torch.dtype = torch.float32) -> FoundationStereo:
    """The reference model on ``device`` with the weights of ``seed``, in eval mode."""
    with torch.device(device):
        model = FoundationStereo(cfg, cdt)
    init_weights(model, torch.Generator(device=device).manual_seed(seed))
    return model.eval()
