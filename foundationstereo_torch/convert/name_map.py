"""Flax parameter path <-> reference torch parameter name rules.

The port's own copy of the JAX package's ``convert/torch_import.py`` name map
(``build_name_map`` and its helpers). Each rule maps a flax path
(``batch_stats::``-prefixed for BatchNorm statistics) to a torch key and the
name of the layout transform that turns the torch tensor into the flax leaf:

* ``conv``    (O, I, *k) -> (*k, I, O)
* ``deconv``  (I, O, *k) -> (*k, I, O)  (the JAX ConvTranspose flips its
  kernel spatially at call time, so the layouts carry no flip)
* ``linear``  (O, I)     -> (I, O)
* ``dense1x1`` (O, I, 1, 1) -> (I, O)   (a 1x1 conv held as a flax Dense)
* ``ident``
"""

from __future__ import annotations

from foundationstereo_torch.config import VIT_CONFIGS
from foundationstereo_torch.models import edgenext as EN


class NameMap:
    """Accumulates flax_path -> (torch_key, transform) rules."""

    def __init__(self):
        self.rules: dict[str, tuple[str, str]] = {}

    def add(self, flax_path: str, torch_key: str, tf: str = "ident"):
        self.rules[flax_path] = (torch_key, tf)

    def bn(self, fp: str, tk: str, i: int = 0):
        self.add(f"{fp}/BatchNorm_{i}/scale", f"{tk}.weight")
        self.add(f"{fp}/BatchNorm_{i}/bias", f"{tk}.bias")
        self.add(f"batch_stats::{fp}/BatchNorm_{i}/mean", f"{tk}.running_mean")
        self.add(f"batch_stats::{fp}/BatchNorm_{i}/var", f"{tk}.running_var")

    def conv(self, fp: str, tk: str, tf: str = "conv"):
        """A kernel (or Dense weight) and its bias."""
        self.add(f"{fp}/kernel", f"{tk}.weight", tf)
        self.add(f"{fp}/bias", f"{tk}.bias")


def _basic_conv(m: NameMap, fp: str, tk: str, bn: bool = True, deconv: bool = False):
    sub = "ConvTranspose_0" if deconv else "Conv_0"
    m.add(f"{fp}/{sub}/kernel", f"{tk}.conv.weight", "deconv" if deconv else "conv")
    if bn:
        m.bn(fp, f"{tk}.bn")


def _resnet_block(m: NameMap, fp: str, tk: str, norm_batch: bool = True):
    m.add(f"{fp}/Conv_0/kernel", f"{tk}.conv1.weight", "conv")
    m.add(f"{fp}/Conv_1/kernel", f"{tk}.conv2.weight", "conv")
    if norm_batch:
        m.bn(fp, f"{tk}.bn1", 0)
        m.bn(fp, f"{tk}.bn2", 1)


def _residual_block(m: NameMap, fp: str, tk: str, norm: str, downsample: bool = False):
    m.conv(f"{fp}/Conv_0", f"{tk}.conv1")
    m.conv(f"{fp}/Conv_1", f"{tk}.conv2")
    if norm == "batch":
        m.bn(fp, f"{tk}.norm1", 0)
        m.bn(fp, f"{tk}.norm2", 1)
    if downsample:
        m.conv(f"{fp}/Conv_2", f"{tk}.downsample.0")
        if norm == "batch":
            m.bn(fp, f"{tk}.downsample.1", 2)


def _apc(m: NameMap, fp: str, tk: str):
    m.conv(f"{fp}/Conv_0", f"{tk}.conv1.0")
    m.bn(fp, f"{tk}.conv1.1", 0)
    m.conv(f"{fp}/Conv_1", f"{tk}.conv2.0")
    m.bn(fp, f"{tk}.conv2.1", 1)


def _dense(m: NameMap, fp: str, tk: str):
    m.conv(fp, tk, tf="linear")


def _transformer_layer(m: NameMap, fp: str, tk: str):
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _dense(m, f"{fp}/MultiheadAttention_0/{proj}", f"{tk}.self_attn.{proj}")
    _dense(m, f"{fp}/Dense_0", f"{tk}.linear1")
    _dense(m, f"{fp}/Dense_1", f"{tk}.linear2")
    _layer_norm(m, f"{fp}/LayerNorm_0", f"{tk}.norm1")
    _layer_norm(m, f"{fp}/LayerNorm_1", f"{tk}.norm2")


def _layer_norm(m: NameMap, fp: str, tk: str):
    m.add(f"{fp}/scale", f"{tk}.weight")
    m.add(f"{fp}/bias", f"{tk}.bias")


def _rcu(m: NameMap, fp: str, tk: str):
    m.conv(f"{fp}/Conv_0", f"{tk}.conv1")
    m.conv(f"{fp}/Conv_1", f"{tk}.conv2")


def build_name_map(cfg) -> NameMap:
    """The full flax <-> torch map for a ``ModelConfig``."""
    m = NameMap()

    # proj_cmb, stems, convex-upsample heads
    m.conv("proj_cmb/Conv_0", "proj_cmb")
    _basic_conv(m, "stem_2/BasicConvIN_0", "stem_2.0", bn=False)
    m.add("stem_2/Conv_0/kernel", "stem_2.1.weight", "conv")
    m.add("spx_2_gru/BasicConv_0/ConvTranspose_0/kernel", "spx_2_gru.conv1.conv.weight", "deconv")
    m.add("spx_2_gru/BasicConv_1/Conv_0/kernel", "spx_2_gru.conv2.conv.weight", "conv")
    m.conv("spx_gru", "spx_gru.0", tf="deconv")

    # corr_stem, corr_feature_att, classifier
    m.conv("corr_stem/proj/Conv_0", "corr_stem.0")
    _basic_conv(m, "corr_stem/conv", "corr_stem.1")
    _resnet_block(m, "corr_stem/res0", "corr_stem.2")
    _resnet_block(m, "corr_stem/res1", "corr_stem.3")
    _basic_conv(m, "corr_feature_att/BasicConv_0", "corr_feature_att.feat_att.0")
    m.conv("corr_feature_att/Conv_0", "corr_feature_att.feat_att.1")
    _basic_conv(m, "classifier/conv", "classifier.0")
    _resnet_block(m, "classifier/res", "classifier.1")
    m.conv("classifier/out/Conv_0", "classifier.2")

    # hourglass
    hg = "cost_agg"
    for name in ("conv1", "conv2", "conv3"):
        _basic_conv(m, f"{hg}/{name}_conv", f"cost_agg.{name}.0")
        _apc(m, f"{hg}/{name}_apc", f"cost_agg.{name}.1")
    for name in ("conv3_up", "conv2_up", "conv1_up"):
        _basic_conv(m, f"{hg}/{name}", f"cost_agg.{name}", deconv=True)
    for agg in ("agg_0", "agg_1"):
        _basic_conv(m, f"{hg}/{agg}_proj", f"cost_agg.{agg}.0")
        _apc(m, f"{hg}/{agg}_apc0", f"cost_agg.{agg}.1")
        _apc(m, f"{hg}/{agg}_apc1", f"cost_agg.{agg}.2")
    for name in ("feature_att_8", "feature_att_16", "feature_att_32",
                 "feature_att_up_16", "feature_att_up_8"):
        _basic_conv(m, f"{hg}/{name}/BasicConv_0", f"cost_agg.{name}.feat_att.0")
        m.conv(f"{hg}/{name}/Conv_0", f"cost_agg.{name}.feat_att.1")
    m.conv(f"{hg}/conv_patch/Conv_0", "cost_agg.conv_patch.0")
    m.bn(f"{hg}/conv_patch_bn", "cost_agg.conv_patch.1")
    for t in range(4):
        _transformer_layer(m, f"{hg}/dt/TransformerEncoderLayer_{t}", f"cost_agg.atts.4.sa.{t}")
    _apc(m, f"{hg}/conv_out_apc0", "cost_agg.conv_out.0")
    _apc(m, f"{hg}/conv_out_apc1", "cost_agg.conv_out.1")

    # cam / sam
    m.add("cam/Conv_0/kernel", "cam.fc.0.weight", "conv")
    m.add("cam/Conv_1/kernel", "cam.fc.2.weight", "conv")
    m.add("sam/Conv_0/kernel", "sam.samconv.weight", "conv")

    # update block (under refine/ in the JAX tree)
    ub, tub = "refine/update_block", "update_block"
    for g in ("gru04", "gru08", "gru16"):
        m.conv(f"{ub}/{g}/conv0", f"{tub}.{g}.conv0.0")
        m.conv(f"{ub}/{g}/conv1", f"{tub}.{g}.conv1.0")
        for sz in ("small", "large"):
            for cz in ("convz", "convr", "convq"):
                m.conv(f"{ub}/{g}/{sz}_gru/{cz}/Conv_0", f"{tub}.{g}.{sz}_gru.{cz}")
    for c in ("convc1", "convc2", "convd1", "convd2", "conv"):
        m.conv(f"{ub}/encoder/{c}/Conv_0", f"{tub}.encoder.{c}")
    m.conv(f"{ub}/disp_head/Conv_0", f"{tub}.disp_head.conv.0")
    for i, ti in ((0, 2), (1, 3)):
        e, te = f"{ub}/disp_head/EdgeNextConvEncoder_{i}", f"{tub}.disp_head.conv.{ti}"
        m.conv(f"{e}/Conv_0", f"{te}.dwconv")
        _dense(m, f"{e}/Dense_0", f"{te}.pwconv1")
        _dense(m, f"{e}/Dense_1", f"{te}.pwconv2")
        m.add(f"{e}/gamma", f"{te}.gamma")
    m.conv(f"{ub}/disp_head/Conv_1", f"{tub}.disp_head.conv.4")
    m.conv(f"{ub}/mask0/Conv_0", f"{tub}.mask.0")
    m.conv(f"{ub}/mask1/Conv_0", f"{tub}.mask.2")

    # context net
    m.conv("cnet/conv1/Conv_0", "cnet.conv1")
    m.bn("cnet/norm1", "cnet.norm1")
    for li in range(1, 6):
        for ab, idx in (("a", 0), ("b", 1)):
            _residual_block(m, f"cnet/layer{li}{ab}", f"cnet.layer{li}.{idx}", "batch",
                            downsample=(ab == "a" and li > 1))
    _basic_conv(m, "cnet/conv2", "cnet.conv2")
    for lvl, tlvl in (("heads04", "outputs04"), ("heads08", "outputs08")):
        for j in range(2):
            _residual_block(m, f"cnet/{lvl}/res{j}", f"cnet.{tlvl}.{j}.0", "batch")
            m.conv(f"cnet/{lvl}/out{j}/Conv_0", f"cnet.{tlvl}.{j}.1")
    for j in range(2):
        m.conv(f"cnet/heads16/out{j}/Conv_0", f"cnet.outputs16.{j}")

    # side-tuning feature pyramid
    ft = "feature"
    for name in ("deconv32_16", "deconv16_8", "deconv8_4"):
        m.add(f"{ft}/{name}/BasicConvIN_0/ConvTranspose_0/kernel",
              f"feature.{name}.conv1.conv.weight", "deconv")
        _resnet_block(m, f"{ft}/{name}/ResnetBasicBlock_0", f"feature.{name}.conv2",
                      norm_batch=False)
    _basic_conv(m, f"{ft}/conv4_0", "feature.conv4.0", bn=False)
    _residual_block(m, f"{ft}/conv4_1", "feature.conv4.1", "instance")
    _residual_block(m, f"{ft}/conv4_2", "feature.conv4.2", "instance")

    # DINOv2 ViT
    vit = VIT_CONFIGS[cfg.vit_size]
    dp, tdp = f"{ft}/dino/pretrained", "feature.dino.depth_anything.pretrained"
    m.add(f"{dp}/cls_token", f"{tdp}.cls_token")
    m.add(f"{dp}/pos_embed", f"{tdp}.pos_embed")
    m.conv(f"{dp}/patch_embed", f"{tdp}.patch_embed.proj")
    _layer_norm(m, f"{dp}/norm", f"{tdp}.norm")
    for i in range(vit["depth"]):
        b, tb = f"{dp}/block{i}", f"{tdp}.blocks.{i}"
        _layer_norm(m, f"{b}/norm1", f"{tb}.norm1")
        _layer_norm(m, f"{b}/norm2", f"{tb}.norm2")
        _dense(m, f"{b}/attn/qkv", f"{tb}.attn.qkv")
        _dense(m, f"{b}/attn/proj", f"{tb}.attn.proj")
        _dense(m, f"{b}/mlp_fc1", f"{tb}.mlp.fc1")
        _dense(m, f"{b}/mlp_fc2", f"{tb}.mlp.fc2")
        m.add(f"{b}/ls1_gamma", f"{tb}.ls1.gamma")
        m.add(f"{b}/ls2_gamma", f"{tb}.ls2.gamma")

    # DPT head
    hd, thd = f"{ft}/dino/depth_head", "feature.dino.depth_anything.depth_head"
    for i in range(4):
        m.conv(f"{hd}/project{i}/Conv_0", f"{thd}.projects.{i}")
    m.conv(f"{hd}/resize0", f"{thd}.resize_layers.0", tf="deconv")
    m.conv(f"{hd}/resize1", f"{thd}.resize_layers.1", tf="deconv")
    m.conv(f"{hd}/resize3/Conv_0", f"{thd}.resize_layers.3")
    for i in range(4):
        m.add(f"{hd}/layer{i + 1}_rn/Conv_0/kernel", f"{thd}.scratch.layer{i + 1}_rn.weight", "conv")
    for i in (1, 2, 3, 4):
        rb, trb = f"{hd}/refinenet{i}", f"{thd}.scratch.refinenet{i}"
        if i == 4:     # no skip: only the second residual unit runs
            _rcu(m, f"{rb}/ResidualConvUnit_0", f"{trb}.resConfUnit2")
        else:
            _rcu(m, f"{rb}/ResidualConvUnit_0", f"{trb}.resConfUnit1")
            _rcu(m, f"{rb}/ResidualConvUnit_1", f"{trb}.resConfUnit2")
        m.conv(f"{rb}/Conv_0", f"{trb}.out_conv")
    m.conv(f"{hd}/output_conv1/Conv_0", f"{thd}.scratch.output_conv1")

    # EdgeNeXt trunk (timm names)
    en = f"{ft}/edgenext"
    m.conv(f"{en}/stem_conv", "feature.stem.0")
    _layer_norm(m, f"{en}/stem_norm/LayerNorm_0", "feature.stem.1")
    for s in range(4):
        ts = f"feature.stages.{s}"
        if s > 0:
            _layer_norm(m, f"{en}/down{s}_norm/LayerNorm_0", f"{ts}.downsample.0")
            m.conv(f"{en}/down{s}_conv", f"{ts}.downsample.1")
        n_local = EN.DEPTHS[s] - EN.GLOBAL_BLOCKS[s]
        for b in range(n_local):
            fb, tb = f"{en}/stage{s}_block{b}", f"{ts}.blocks.{b}"
            m.conv(f"{fb}/Conv_0", f"{tb}.conv_dw")
            _layer_norm(m, f"{fb}/LayerNorm2d_0/LayerNorm_0", f"{tb}.norm")
            _dense(m, f"{fb}/Dense_0", f"{tb}.mlp.fc1")
            _dense(m, f"{fb}/Dense_1", f"{tb}.mlp.fc2")
            m.add(f"{fb}/gamma", f"{tb}.gamma")
        for g in range(EN.GLOBAL_BLOCKS[s]):
            fb, tb = f"{en}/stage{s}_sdta{g}", f"{ts}.blocks.{n_local + g}"
            n_dw = 1 if EN.D2_SCALES[s] == 1 else EN.D2_SCALES[s] - 1
            for j in range(n_dw):
                m.conv(f"{fb}/dwconv{j}", f"{tb}.convs.{j}")
            if EN.USE_POS_EMB[s] and g == 0:
                m.conv(f"{fb}/pos_proj", f"{tb}.pos_embd.token_projection", tf="dense1x1")
            _layer_norm(m, f"{fb}/norm_xca", f"{tb}.norm_xca")
            m.add(f"{fb}/gamma_xca", f"{tb}.gamma_xca")
            _dense(m, f"{fb}/xca/qkv", f"{tb}.xca.qkv")
            _dense(m, f"{fb}/xca/proj", f"{tb}.xca.proj")
            m.add(f"{fb}/xca/temperature", f"{tb}.xca.temperature")
            _layer_norm(m, f"{fb}/norm/LayerNorm_0", f"{tb}.norm")
            _dense(m, f"{fb}/Dense_0", f"{tb}.mlp.fc1")
            _dense(m, f"{fb}/Dense_1", f"{tb}.mlp.fc2")
            m.add(f"{fb}/gamma", f"{tb}.gamma")
    return m


_COLLAPSIBLE = {"Conv_0", "BatchNorm_0", "GroupNorm_0"}


def canonical_path(path: str) -> str:
    """Drop the JAX wrapper modules' single inner auto-named module
    (``Conv_0`` / ``BatchNorm_0`` / ``GroupNorm_0``) from a parameter path."""
    parts = path.split("/")
    if len(parts) >= 2 and parts[-2] in _COLLAPSIBLE:
        parts = parts[:-2] + parts[-1:]
    return "/".join(parts)
