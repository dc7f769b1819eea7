"""The full stereo model: the inference forward (``test_mode=True``) and the
train-mode forward (``test_mode=False``).

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

With ``use_pallas`` the cost-volume build, the lookup and the classifier's
last conv (K6) go through the kernel wrappers in ``ops/kernels.py`` (CUDA
kernels on the card, their plain twins on the CPU); without it the model
calls the plain twins directly, and the classifier ``F.conv3d``. With ``use_pallas`` and ``pallas_conv3x3`` the constructor also
marks the eligible 3x3 convs (``models/layers.py:route_conv3x3``), which
then run through the conv kernel. Nothing else changes between the paths.

The train-mode forward (``test_mode=False``) returns the initial disparity
at 1/4 resolution and the full-resolution disparity of every refinement
step, each step's input disparity detached, as the JAX package's does.
With ``train=True`` (the model in ``train()`` mode) batch norm takes the
batch's statistics and the disparity transformer's dropouts draw from the
enclosing ``layers.dropout_generator``; the cost-volume build and the lookup
run their differentiable twins with fp32 pyramids, the 3x3 convs
``F.conv2d``, the classifier's last conv ``F.conv3d``, and only the frozen
ViT's attention runs its kernel, under
``no_grad``. ``forward`` decides this once per call, from ``train`` or
grad mode (``differentiable``): the kernels have no backward, so an
eval-mode forward that takes gradients takes the same route (as the JAX
package's ``train_flag=False`` gradients take its XLA forms), and a kernel
wrapper handed a tensor that needs a backward raises. ``remat_filter``
checkpoints CorrStem, FeatureAtt, Hourglass and Classifier,
``remat_refine`` each refinement step and ``scan_upsample`` each step's
upsampling head (``layers.checkpointed``).

The forward's stages are spans (``utils/trace.py``), recorded only inside
``trace.recording()``: ``forward``, ``features``, ``filter`` and
``refine``, inside it each step's ``lookup`` and ``update``.

Under a device ``Mesh`` (``parallel.mesh_context``) each forward call picks
its kernels as the JAX package's ``_pallas_mode`` does (``kernel_mode``):
the width-sharded build and lookup (``ops/sharded.py``, K5) where the mesh's
``spatial`` axis divides W/4, the ViT attention per (batch, heads) shard
(K3s, ``vit_attention="auto"``), and no 3x3 conv kernel. Every other module
runs on the model's device.

Under a ``RankMesh`` whose ``spatial`` axis is > 1 (one process per rank,
``parallel/spatial.py``) the forward is partitioned along image width where
the JAX package places ``shard_spatial``: ``feature``, ``stem_2``,
``proj_cmb``, ``cnet``, ``cam`` and ``sam`` run whole on every rank; each
rank takes its columns of the left features, ``stem_2x`` and the context
lists, builds its columns of the cost volume against the full right
features (K5's build, ``kernels.cost_volume_parts_haloed``, with its x
offset), runs CorrStem, FeatureAtt, the hourglass, the classifier (K6 on
the rank's haloed columns), the
pyramids, every refinement step (K5's lookup, ``kernels.
disparity_lookup_shard``) and the upsampling head on them with halo
exchanges, and the outputs are gathered along W, so every rank returns the
whole disparity. No 3x3 conv kernel runs. The ViT runs on every rank
outside the partitioned region; with ``vit_attention="auto"`` its
attention is K3s on the rank's H/S heads, gathered over the spatial group
(``parallel.spatial.gather_heads``), where ``spatial`` divides the heads,
and K3 whole otherwise (``vit_attention="flash"`` keeps K3 whole).
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
    checkpointed,
    route_conv3x3,
)
from foundationstereo_torch.models.update import BasicSelectiveMultiUpdateBlock
from foundationstereo_torch.ops import cost_volume, kernels, sampler, sharded
from foundationstereo_torch.ops.upsample import context_upsample, disparity_regression
from foundationstereo_torch.parallel import spatial
from foundationstereo_torch.parallel.mesh import Mesh, RankMesh, current_mesh
from foundationstereo_torch.utils.misc import IMAGENET_MEAN, IMAGENET_STD
from foundationstereo_torch.utils.trace import span


def normalize_image(img: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) RGB in 0-255 -> (B, 3, H, W) ImageNet-normalised fp32."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=img.device)
    std = torch.as_tensor(IMAGENET_STD, device=img.device)
    return ((img.float() / 255.0 - mean) / std).permute(0, 3, 1, 2)


def kernel_mode(cfg: ModelConfig, mesh: Mesh | RankMesh | None, w4: int,
                differentiable: bool = False) -> str:
    """The cost-volume build and lookup of one forward call: "plain" (the
    twins; no ``use_pallas``, or ``differentiable``: in training, as the JAX
    package's ``_pallas_mode`` rules, and wherever the forward takes
    gradients, since the kernels have no backward), "sharded" (K5 shard by
    shard, on a device mesh whose ``spatial`` axis is > 1 and divides W/4),
    "rank" (K5 on this rank's columns, under a rank mesh whose ``spatial``
    axis is > 1) or "single" (K1 and K2 on the model's device). A device
    mesh whose ``spatial`` axis does not divide W/4 takes "single" where the
    JAX package takes its XLA forms: the same numbers, and no plain twin
    serves on the card in inference."""
    if not cfg.use_pallas or differentiable:
        return "plain"
    n = 1 if mesh is None else mesh.shape.get("spatial", 1)
    if isinstance(mesh, RankMesh):
        return "rank" if n > 1 else "single"
    return "sharded" if n > 1 and w4 % n == 0 else "single"


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
    by 32; with ``test_mode=True`` returns the (B, H, W) disparity, with
    ``test_mode=False`` the (B, H/4, W/4) initial disparity and the list of
    ``iters`` (B, H, W) disparities. ``low_memory`` is accepted and ignored,
    as there. ``train`` must match the module's mode (``model.train()`` /
    ``model.eval()``), or the call raises.

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
        # The convs routed through K4; ``forward`` sets their ``k4_on``.
        self._k4_convs = route_conv3x3(self) if cfg.use_pallas and cfg.pallas_conv3x3 else []
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
        with span("forward"):
            return self._forward(left, right, iters, test_mode, init_disp, train)

    def _forward(self, left, right, iters, test_mode, init_disp, train):
        if train != self.training:
            raise ValueError(f"train={train} but the model is in {'train' if self.training else 'eval'}"
                             f" mode: call model.{'train' if train else 'eval'}() first")
        cfg, dt = self.cfg, self.cdt
        B = left.shape[0]
        D = cfg.max_disp // 4
        mesh = current_mesh()
        part = spatial.partition(mesh, left.shape[2])
        grad = torch.is_grad_enabled()
        differentiable = train or grad
        mode = kernel_mode(cfg, mesh, left.shape[2] // 4, differentiable)
        # K4 as the JAX package enables it: single-device inference only.
        k4_on = not differentiable and (mesh is None or mesh.size == 1)
        for m in self._k4_convs:
            m.k4_on = k4_on
        self.classifier.k6_on = mode != "plain"     # K6 wherever the kernels run
        remat_filter = train and grad and cfg.remat_filter
        remat_refine = train and grad and cfg.remat_refine
        remat_head = grad and not test_mode and cfg.scan_upsample

        def filt(module, *args):
            return checkpointed(module, *args) if remat_filter else module(*args)

        img1 = normalize_image(left).to(dt)
        img2 = normalize_image(right).to(dt)

        with span("features"):
            out, vit_feat = self.feature(torch.cat([img1, img2], dim=0))
            vit_feat = vit_feat[:B]
            fl = [o[:B] for o in out]
            fr = [o[B:] for o in out]
            stem_2x = self.stem_2(img1)

        # Cost volume as parts: CorrStem contracts them with the left term.
        lproj, rproj = self.proj_cmb(fl[0]), self.proj_cmb(fr[0])
        if part is not None:        # from here on, this rank's columns
            fl = [part.take(f) for f in fl]
            lproj, stem_2x = part.take(lproj), part.take(stem_2x)
        args = (fl[0].contiguous(), fr[0].contiguous(), rproj.contiguous(), D, cfg.cv_group)
        if mode == "sharded":
            gwc, rps = sharded.cost_volume_parts_sharded(*args, mesh, out_dtype=dt)
        elif part is not None:
            build = (kernels.cost_volume_parts_haloed if mode == "rank"
                     else cost_volume.cost_volume_parts_haloed)
            gwc, rps = build(*args, part.columns(fr[0].shape[-1])[0], out_dtype=dt)
        else:
            build = kernels.cost_volume_parts if mode == "single" else cost_volume.cost_volume_parts
            gwc, rps = build(*args, out_dtype=dt)
        with span("filter"):
            with spatial.region(part):
                comb = filt(self.corr_stem, (gwc, rps, lproj))
                del gwc, rps
                comb = filt(self.corr_feature_att, comb, fl[0])
                comb = filt(self.cost_agg, comb, fl)
                # Initial disparity: soft-argmin in fp32.
                prob = torch.softmax(filt(self.classifier, comb).float(), dim=1)  # (B, D, H/4, W/4)
            given_disp = init_disp
            if init_disp is None:
                init_disp = disparity_regression(prob, D)
            elif part is not None:
                init_disp = part.take(init_disp)

        cnet_list = self.cnet(img1, vit_feat)
        net_list = [torch.tanh(h) for h, _ in cnet_list]
        inp_list = [torch.relu(c) for _, c in cnet_list]
        inp_list = [self.cam(x) * x for x in inp_list]
        att = [self.sam(x) for x in inp_list]
        if part is not None:
            net_list, inp_list, att = ([part.take(x) for x in xs] for xs in (net_list, inp_list, att))

        # Geometry and all-pairs correlation pyramids, pooled in fp32 (and
        # kept in fp32 where gradients flow, as the JAX package's XLA forms
        # keep them).
        pyr_dt = torch.float32 if differentiable else self.pyramid_dtype
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
        elif part is not None:
            fn = kernels.disparity_lookup_shard if mode == "rank" else sampler.disparity_lookup
            lookup = functools.partial(fn, geo_pyr, corr_pyr,
                                       x_offset=part.columns(fr[0].shape[-1])[0])
        else:
            fn = kernels.disparity_lookup if mode == "single" else sampler.disparity_lookup
            lookup = functools.partial(fn, geo_pyr, corr_pyr)
        del geo_pyr, corr_pyr

        def refine(net_list, disp):
            with span("lookup"):
                geo_feat = lookup(disp, cfg.corr_radius, out_dtype=dt)
            with span("update"):
                net_list, mask_feat, delta = self.update_block(
                    net_list, inp_list, geo_feat, disp[:, None].to(dt), att)
            return net_list, disp + delta[:, 0].float(), mask_feat

        gather = (lambda x: x) if part is None else part.gather  # noqa: E731
        disp = init_disp.float().contiguous()
        mask_feat = torch.zeros((B, 32) + disp.shape[1:], device=disp.device, dtype=dt)
        preds = []
        with span("refine"), spatial.region(part):
            for _ in range(iters):
                disp = disp.detach()
                if remat_refine:
                    net_list, disp, mask_feat = checkpointed(refine, net_list, disp)
                else:
                    net_list, disp, mask_feat = refine(net_list, disp)
                if not test_mode:
                    head = (checkpointed(self._upsample_head, disp, mask_feat, stem_2x)
                            if remat_head else self._upsample_head(disp, mask_feat, stem_2x))
                    preds.append(gather(head))
            if test_mode:
                return gather(self._upsample_head(disp, mask_feat, stem_2x))
        return (gather(init_disp) if given_disp is None else given_disp), preds

    def _upsample_head(self, disp, mask_feat, stem_2x):
        """Convex upsampling to full resolution with the spx head."""
        xspx = self.spx_2_gru(mask_feat, stem_2x)
        spx_pred = torch.softmax(self.spx_gru(xspx).float(), dim=1)     # (B, 9, H, W)
        return context_upsample(disp * 4.0, spx_pred)
