"""The full stereo model, inference forward (``test_mode=True``).

The port of the JAX package's ``models/foundation_stereo.py``: features ->
cost-volume parts -> CorrStem / FeatureAtt -> hourglass with the disparity
transformer -> soft-argmin -> context net and attention gates -> geometry
and correlation pyramids -> ``iters`` GRU refinement steps with pyramid
lookups -> convex upsampling.

Precision mirrors the JAX package: modules compute in bf16 under
``mixed_precision``; correlation normalisation and dots, the classifier
softmax and soft-argmin, the pyramids' pooling, the disparity carry and the
upsampling softmax stay fp32; on the kernel path (``use_pallas``) the
pyramids are stored in bf16 when ``bf16_pyramids`` is set (the lookup
accumulates in fp32), on the plain path in fp32.

With ``use_pallas`` the cost-volume build and the lookup go through the
kernel wrappers in ``ops/kernels.py`` (CUDA kernels on the card, their
plain twins on the CPU); without it the model calls the plain twins
directly. With ``use_pallas`` and ``pallas_conv3x3`` the constructor also
marks the eligible 3x3 convs (``models/layers.py:route_conv3x3``), which
then run through the conv kernel. Nothing else changes between the paths.

Under a mesh (``parallel.mesh_context``) each forward call picks its kernels
as the JAX package's ``_pallas_mode`` does (``kernel_mode``): the
width-sharded build and lookup (``ops/sharded.py``, K5) where the mesh's
``spatial`` axis divides W/4, the ViT attention per (batch, heads) shard
(K3s, ``vit_attention="auto"``), and no 3x3 conv kernel. Every other module
runs on the model's device.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn as nn

from foundationstereo_torch.config import ModelConfig
from foundationstereo_torch.models.cost_filter import Classifier, CorrStem, Hourglass
from foundationstereo_torch.models.dinov2 import LayerScale
from foundationstereo_torch.models.extractor import ContextNetDino, Feature, Stem2, feature_dims
from foundationstereo_torch.models.layers import (
    ChannelAttentionEnhancement,
    Conv2d,
    Conv2x,
    ConvTranspose2d,
    FeatureAtt,
    SpatialAttentionExtractor,
    route_conv3x3,
)
from foundationstereo_torch.models.update import BasicSelectiveMultiUpdateBlock
from foundationstereo_torch.ops import cost_volume, kernels, sampler, sharded
from foundationstereo_torch.ops.upsample import context_upsample, disparity_regression
from foundationstereo_torch.parallel.mesh import Mesh, current_mesh
from foundationstereo_torch.utils.misc import IMAGENET_MEAN, IMAGENET_STD


def normalize_image(img: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) RGB in 0-255 -> (B, 3, H, W) ImageNet-normalised fp32."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=img.device)
    std = torch.as_tensor(IMAGENET_STD, device=img.device)
    return ((img.float() / 255.0 - mean) / std).permute(0, 3, 1, 2)


def kernel_mode(cfg: ModelConfig, mesh: Mesh | None, w4: int) -> str:
    """The cost-volume build and lookup of one forward call: "plain" (the
    twins; no ``use_pallas``), "sharded" (K5, on a mesh whose ``spatial``
    axis is > 1 and divides W/4) or "single" (K1 and K2 on the model's
    device). A mesh whose ``spatial`` axis does not divide W/4 takes
    "single" where the JAX package takes its XLA forms: the same numbers,
    and no plain twin serves on the card."""
    if not cfg.use_pallas:
        return "plain"
    spatial = 1 if mesh is None else mesh.shape.get("spatial", 1)
    return "sharded" if spatial > 1 and w4 % spatial == 0 else "single"


def resolve_device(device) -> torch.device:
    """The entry points' device: CUDA unless the caller asks for the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")
    return device


class FoundationStereo(nn.Module):
    """``forward(left, right, iters=12, test_mode=False, low_memory=False,
    init_disp=None, train=False)``, the JAX package's ``__call__`` signature:
    left and right are (B, H, W, 3) RGB in [0, 255] with H and W divisible
    by 32; with ``test_mode=True`` returns the (B, H, W) disparity.
    ``low_memory`` is accepted and ignored, as there. The train-mode forward
    (``test_mode=False`` or ``train=True``) is not ported yet and raises.

    Weights are drawn from a ``torch.Generator`` seeded with ``seed``
    (the same families of initialisers as the JAX package's flax modules);
    load real ones with ``load_state_dict``.
    """

    def __init__(self, cfg: ModelConfig, device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        cdt = torch.bfloat16 if cfg.mixed_precision else torch.float32
        self.cdt = cdt
        # The dtype the lookup pyramids are stored in; assign it to compare
        # the two paths with the same pyramids.
        self.pyramid_dtype = (torch.bfloat16 if cfg.use_pallas and cfg.bf16_pyramids
                              else torch.float32)
        dims = feature_dims(cfg)
        n_corr = cfg.corr_levels * (cfg.volume_dim + 1) * (2 * cfg.corr_radius + 1)
        with torch.device(device):
            self.feature = Feature(cfg, cdt)
            self.stem_2 = Stem2(cdt)
            self.proj_cmb = Conv2d(dims[0], 12, 1, cdt=cdt)
            self.corr_stem = CorrStem(cfg.cv_group + 2 * 12, cfg.volume_dim, cdt)
            self.corr_feature_att = FeatureAtt(cfg.volume_dim, dims[0], cdt)
            self.cost_agg = Hourglass(cfg.volume_dim, cfg.max_disp, dims, cdt)
            self.classifier = Classifier(cfg.volume_dim, cdt)
            self.cnet = ContextNetDino(cfg, cdt=cdt)
            self.cam = ChannelAttentionEnhancement(cfg.hidden_dims[0], cdt)
            self.sam = SpatialAttentionExtractor(cdt=cdt)
            self.update_block = BasicSelectiveMultiUpdateBlock(
                cfg.hidden_dims[0], cfg.n_gru_layers, n_corr, cdt)
            self.spx_2_gru = Conv2x(32, 32, bn=False, cdt=cdt)
            self.spx_gru = nn.Sequential(ConvTranspose2d(64, 9, 4, 2, 1, cdt=cdt))
        if cfg.use_pallas and cfg.pallas_conv3x3:
            route_conv3x3(self)
        self.init_weights(torch.Generator(device=device).manual_seed(seed))
        self.eval()

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """Truncated-normal fan-in scaling for conv and linear weights, zero
        biases, identity norms, and the ViT's own initialisers."""
        for m in self.modules():
            for leaf, p in m.named_parameters(recurse=False):
                if leaf == "weight" and p.ndim >= 2:
                    # fan_in as flax counts it: input channels x kernel taps
                    transposed = isinstance(m, (nn.ConvTranspose2d, nn.ConvTranspose3d))
                    fan_in = p.shape[0] * p[0, 0].numel() if transposed else p[0].numel()
                    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                    nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=gen)
                elif leaf in ("bias", "cls_token"):
                    p.zero_()
                elif leaf == "pos_embed":
                    p.normal_(0.0, 0.02, generator=gen)
                elif leaf in ("gamma", "gamma_xca") and not isinstance(m, LayerScale):
                    p.fill_(1e-6)       # EdgeNeXt-style layer scale
                else:                   # norm scales, ViT layer scales, XCA temperatures
                    p.fill_(1.0)
        for name, b in self.named_buffers():
            b.fill_(1.0 if name.endswith("running_var") else 0.0)

    def forward(self, left, right, iters: int = 12, test_mode: bool = False,
                low_memory: bool = False, init_disp: torch.Tensor | None = None,
                train: bool = False):
        del low_memory      # part of the reference's forward contract; nothing to gate
        if not test_mode or train:
            raise NotImplementedError("the train-mode forward is not ported yet: pass "
                                      "test_mode=True")
        cfg, dt = self.cfg, self.cdt
        B = left.shape[0]
        D = cfg.max_disp // 4
        mesh = current_mesh()
        mode = kernel_mode(cfg, mesh, left.shape[2] // 4)
        img1 = normalize_image(left).to(dt)
        img2 = normalize_image(right).to(dt)

        out, vit_feat = self.feature(torch.cat([img1, img2], dim=0))
        vit_feat = vit_feat[:B]
        fl = [o[:B] for o in out]
        fr = [o[B:] for o in out]
        stem_2x = self.stem_2(img1)

        # Cost volume as parts: CorrStem contracts them with the left term.
        lproj, rproj = self.proj_cmb(fl[0]), self.proj_cmb(fr[0])
        args = (fl[0].contiguous(), fr[0].contiguous(), rproj.contiguous(), D, cfg.cv_group)
        if mode == "sharded":
            gwc, rps = sharded.cost_volume_parts_sharded(*args, mesh, out_dtype=dt)
        else:
            build = kernels.cost_volume_parts if mode == "single" else cost_volume.cost_volume_parts
            gwc, rps = build(*args, out_dtype=dt)
        comb = self.corr_stem((gwc, rps, lproj))
        del gwc, rps
        comb = self.corr_feature_att(comb, fl[0])
        comb = self.cost_agg(comb, fl)

        # Initial disparity: soft-argmin in fp32.
        prob = torch.softmax(self.classifier(comb).float(), dim=1)    # (B, D, H/4, W/4)
        if init_disp is None:
            init_disp = disparity_regression(prob, D)

        cnet_list = self.cnet(img1, vit_feat)
        net_list = [torch.tanh(h) for h, _ in cnet_list]
        inp_list = [torch.relu(c) for _, c in cnet_list]
        inp_list = [self.cam(x) * x for x in inp_list]
        att = [self.sam(x) for x in inp_list]

        # Geometry and all-pairs correlation pyramids, pooled in fp32.
        pyr_dt = self.pyramid_dtype
        geo_base = comb.float().permute(0, 3, 4, 1, 2)                  # (B, H, W, C, D)
        corr_base = cost_volume.all_pairs_correlation(fl[0], fr[0])     # (B, H, W, W)
        geo_pyr = [g.to(pyr_dt).contiguous()
                   for g in sampler.pool_last_axis(geo_base, cfg.corr_levels - 1)]
        corr_pyr = [c.to(pyr_dt).contiguous()
                    for c in sampler.pool_last_axis(corr_base, cfg.corr_levels - 1)]
        del comb, geo_base, corr_base

        if mode == "sharded":       # the shards' pyramids are cut once, before the loop
            lookup = functools.partial(sharded.disparity_lookup_sharded,
                                       sharded.shard_pyramids(geo_pyr, corr_pyr, mesh))
        else:
            fn = kernels.disparity_lookup if mode == "single" else sampler.disparity_lookup
            lookup = functools.partial(fn, geo_pyr, corr_pyr)
        del geo_pyr, corr_pyr
        disp = init_disp.float().contiguous()
        mask_feat = torch.zeros((B, 32) + disp.shape[1:], device=disp.device, dtype=dt)
        for _ in range(iters):
            geo_feat = lookup(disp, cfg.corr_radius, out_dtype=dt)
            net_list, mask_feat, delta = self.update_block(
                net_list, inp_list, geo_feat, disp[:, None].to(dt), att)
            disp = disp + delta[:, 0].float()
        return self._upsample_head(disp, mask_feat, stem_2x)

    def _upsample_head(self, disp, mask_feat, stem_2x):
        """Convex upsampling to full resolution with the spx head."""
        xspx = self.spx_2_gru(mask_feat, stem_2x)
        spx_pred = torch.softmax(self.spx_gru(xspx).float(), dim=1)     # (B, 9, H, W)
        return context_upsample(disp * 4.0, spx_pred)
