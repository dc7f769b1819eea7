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

The 3x3 conv kernel (K4, ``ops/kernels.py:conv3x3``) is opt-in per module:
``route_conv3x3(model)`` asks every conv to decide from its own shapes
whether the JAX package's rule (``k4_eligible``) routes it. The forms routed
are those the JAX package routes under its ``pallas_conv3x3_scope``: the 2D
conv, the (1, 3, 3) 3D conv with D folded into the batch (the kernel reads
the (B, C, D, H, W) volume in place through its strides, no copy), and the
per-tap decomposition of a full 3D conv whose spatial part is 3x3/s1/p1.
Whether a routed conv takes K4 in a call is its ``k4_on``, which the
model's ``forward`` sets once per call for all of them: off where the
forward takes gradients (K4 has no backward) and on a multi-device mesh.

Training (``self.training``, set by ``model.train()``): batch norm
normalises with the batch's statistics and moves its running ones, and the
disparity transformer's dropouts draw masks from the generator of the
enclosing ``dropout_generator`` block (flax's "dropout" stream).
``checkpointed`` runs a region under ``torch.utils.checkpoint`` so that its
recompute in the backward draws the same masks and moves no running stats.
Inside a ``global_batch`` block each rank of a data-parallel step computes
its slice as a part of the global batch: batch norm takes the global batch's
statistics, and dropout the global batch's masks.

Inside a spatial partition (``parallel/spatial.py:region``) each rank holds
its columns of the image width: every convolution runs on them with the
halo its kernel reads across the shard borders (none for a kernel one
column wide), batch norm in training sums its statistics over all the
mesh's ranks, dropout keeps the rank's columns of the global mask, and the
norms and pooling over whole images refuse to run.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from foundationstereo_torch.ops import kernels
from foundationstereo_torch.ops.resize import resize2d
from foundationstereo_torch.parallel import spatial
from foundationstereo_torch.parallel.distributed import all_reduce_sum


def leaky_relu(x):
    """LeakyReLU (slope 0.01) with flax's derivative 1 at exactly 0
    (``F.leaky_relu``'s is 0.01 there, which moves the gradient wherever a
    bias-free conv sees an all-zero window)."""
    return torch.where(x >= 0, x, 0.01 * x)


def gelu(x):
    return F.gelu(x)


def _cast(t, dt):
    return None if t is None else t.to(dt)


def k4_eligible(ks, st, pd, dl, groups: int, c: int, f: int) -> bool:
    """The JAX package's rule for the 3x3 conv kernel
    (``models/layers.py:_pallas3x3_eligible``): kernel 3x3, stride 1,
    padding 1, no dilation, no groups, C >= 128 and F >= 64."""
    return (tuple(ks) == (3, 3) and tuple(st) == (1, 1) and tuple(pd) == (1, 1)
            and tuple(dl) == (1, 1) and groups == 1 and c >= 128 and f >= 64)


def k4_input(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """x in ``dt`` with the contiguous (H, W) planes K4 reads (a copy only
    for another layout, such as channels-last)."""
    x = x.to(dt)
    return x if x.stride(-1) == 1 and x.stride(-2) == x.shape[-1] else x.contiguous()


def route_conv3x3(model: nn.Module) -> list[nn.Module]:
    """Route every eligible conv of ``model`` through the 3x3 conv kernel;
    returns the routed modules."""
    routed = []
    for m in model.modules():
        if hasattr(m, "enable_k4"):
            m.enable_k4()
            if m.k4:
                routed.append(m)
    return routed


class PackedWeights:
    """Weights derived from parameters (cast, fused or packed for K4), made
    once and made again when a source parameter changes (its ``_version``),
    moves (its storage) or the compute dtype differs; made anew in each call,
    under autograd, where gradients flow to the parameters, and while
    ``torch.export`` or ``torch.compile`` traces (a traced tensor has no
    storage to key on, and the graph must hold the derivation)."""

    def __init__(self):
        self.key, self.value = None, None

    def __call__(self, params, extra, make):
        if torch.compiler.is_compiling() or (
                torch.is_grad_enabled() and any(p.requires_grad for p in params)):
            return make()
        key = tuple((p._version, p.data_ptr(), p.device) for p in params) + tuple(extra)
        if key != self.key:
            with torch.no_grad():
                self.value = make()
            self.key = key
        return self.value


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``cdt``; through K4 once ``enable_k4``
    found it eligible."""

    def __init__(self, cin, cout, k, stride=1, padding=0, groups=1, bias=True,
                 cdt=torch.float32):
        super().__init__(cin, cout, k, stride, padding, groups=groups, bias=bias)
        self.cdt = cdt
        self.k4, self.k4_on = False, True
        self._k4_weight = PackedWeights()

    def enable_k4(self):
        self.k4 = k4_eligible(self.kernel_size, self.stride, self.padding, self.dilation,
                              self.groups, self.in_channels, self.out_channels)

    def forward(self, x):
        if self.k4 and self.k4_on:
            packed = self._k4_weight(
                [self.weight], [self.cdt],
                lambda: kernels.pack_conv3x3_weight(self.weight, self.cdt)) if x.is_cuda else None
            return kernels.conv3x3(k4_input(x, self.cdt), self.weight, _cast(self.bias, self.cdt),
                                   packed)
        return spatial.conv(F.conv2d, x.to(self.cdt), self.weight.to(self.cdt),
                            _cast(self.bias, self.cdt), self.stride, self.padding, self.dilation,
                            self.groups)


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` computing in ``cdt``. Once ``enable_k4`` found its
    spatial part eligible, a (1, 3, 3) conv runs as one K4 call over the
    volume with D as a batch axis ("fold"), and a full 3D conv as one K4
    call per depth tap summed with shifts along D ("taps"), as the JAX
    package's ``Conv`` decomposes it."""

    def __init__(self, cin, cout, k, stride=1, padding=0, groups=1, bias=True,
                 cdt=torch.float32):
        super().__init__(cin, cout, k, stride, padding, groups=groups, bias=bias)
        self.cdt = cdt
        self.k4, self.k4_on = None, True
        self._k4_weight = PackedWeights()

    def enable_k4(self):
        ks, st, pd = self.kernel_size, self.stride, self.padding
        if (self.dilation == (1, 1, 1) and not isinstance(pd, str)
                and k4_eligible(ks[1:], st[1:], pd[1:], (1, 1), self.groups,
                                self.in_channels, self.out_channels)):
            if ks[0] > 1:
                self.k4 = "taps"
            elif st[0] == 1 and pd[0] == 0:
                self.k4 = "fold"

    def forward(self, x):
        if self.k4 is None or not self.k4_on:
            return spatial.conv(F.conv3d, x.to(self.cdt), self.weight.to(self.cdt),
                                _cast(self.bias, self.cdt), self.stride, self.padding,
                                self.dilation, self.groups)
        x = k4_input(x, self.cdt)
        kd = self.kernel_size[0]
        packed = self._k4_weight(
            [self.weight], [self.cdt],
            lambda: [kernels.pack_conv3x3_weight(self.weight[:, :, t], self.cdt)
                     for t in range(kd)]) if x.is_cuda else [None] * kd
        bias = _cast(self.bias, self.cdt)
        if self.k4 == "fold":
            return kernels.conv3x3(x, self.weight[:, :, 0], bias, packed[0])
        sd, pdd = self.stride[0], self.padding[0]
        d_out = (x.shape[2] + 2 * pdd - kd) // sd + 1
        acc = None
        for t in range(kd):
            y = F.pad(kernels.conv3x3(x, self.weight[:, :, t], None, packed[t]),
                      (0, 0, 0, 0, pdd, pdd))
            y = y[:, :, t:t + sd * (d_out - 1) + 1:sd]
            acc = y if acc is None else acc + y
        return acc if bias is None else acc + bias[:, None, None, None]


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in ``cdt``."""

    def __init__(self, cin, cout, k, stride=1, padding=0, bias=True, cdt=torch.float32):
        super().__init__(cin, cout, k, stride, padding, bias=bias)
        self.cdt = cdt

    def forward(self, x):
        return spatial.conv_transpose(F.conv_transpose2d, x.to(self.cdt), self.weight.to(self.cdt),
                                      _cast(self.bias, self.cdt), self.stride, self.padding)


class ConvTranspose3d(nn.ConvTranspose3d):
    """``nn.ConvTranspose3d`` computing in ``cdt``."""

    def __init__(self, cin, cout, k, stride=1, padding=0, bias=True, cdt=torch.float32):
        super().__init__(cin, cout, k, stride, padding, bias=bias)
        self.cdt = cdt

    def forward(self, x):
        return spatial.conv_transpose(F.conv_transpose3d, x.to(self.cdt), self.weight.to(self.cdt),
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
# Training: dropout masks and checkpointed regions
# ---------------------------------------------------------------------------

# The generator of the innermost ``dropout_generator`` block, the process
# group of the innermost ``global_batch`` block (None: the batch is this
# process's alone), and how many checkpointed regions are being recomputed
# (lists: the recompute runs on the autograd engine's thread).
_DROPOUT_GEN: list = [None]
_GLOBAL_GROUP: list = [None]
_RECOMPUTE: list = [0]


@contextlib.contextmanager
def dropout_generator(gen: torch.Generator | None):
    """Inside the block, train-mode dropouts draw their masks from ``gen``."""
    prev, _DROPOUT_GEN[0] = _DROPOUT_GEN[0], gen
    try:
        yield gen
    finally:
        _DROPOUT_GEN[0] = prev


@contextlib.contextmanager
def global_batch(group=None):
    """Inside the block, the batch a train-mode forward sees is this rank's
    slice of the global batch: the ranks of ``group`` (None: the default
    group) each hold an equal slice, in rank order. Batch norm normalises
    with the global batch's statistics (an all-reduce whose backward
    all-reduces their gradient, so every rank's input gets the global loss's
    gradient), and dropout draws the global batch's mask and keeps this
    rank's rows. So a step on N ranks computes what one process computes on
    the global batch. With a group of one, or no process group, nothing
    changes. Inference never reads it."""
    if dist.is_initialized() and group is None:
        group = dist.group.WORLD
    active = group is not None and dist.get_world_size(group) > 1
    prev, _GLOBAL_GROUP[0] = _GLOBAL_GROUP[0], group if active else None
    try:
        yield
    finally:
        _GLOBAL_GROUP[0] = prev


def dropout(x: torch.Tensor, rate: float, training: bool,
            grid: tuple[int, int, int] | None = None) -> torch.Tensor:
    """flax's ``nn.Dropout``: keep with probability 1 - rate (a uniform draw
    below it), scale the kept values by 1 / (1 - rate). Identity outside
    training; in training the mask comes from the ``dropout_generator``
    (inside ``global_batch``, this rank's rows of the global batch's mask:
    axis 0 is the batch's, outermost). Inside a spatial partition axis 0
    must be (B, H, W) flattened, ``grid``: the mask is drawn for the global
    width and the rank keeps its columns."""
    if not training or rate == 0.0:
        return x
    gen = _DROPOUT_GEN[0]
    if gen is None:
        raise RuntimeError("train-mode dropout needs a generator: run the forward inside "
                           "layers.dropout_generator(torch.Generator(...))")
    keep_prob = 1.0 - rate
    group, part = _GLOBAL_GROUP[0], spatial.active()
    n, r = (1, 0) if group is None else (dist.get_world_size(group), dist.get_rank(group))
    if part is not None:
        if grid is None or grid[0] * grid[1] * grid[2] != x.shape[0]:
            raise ValueError(f"dropout inside the spatial partition needs its rows' (B, H, W) "
                             f"grid, got {grid} for {x.shape[0]} rows")
        b, h, w = grid
        c0, c1 = part.columns(part.global_width(w))
        full = torch.rand((n * b, h, part.global_width(w)) + x.shape[1:], generator=gen,
                          device=x.device)
        keep = full[r * b:(r + 1) * b, :, c0:c1].reshape(x.shape) < keep_prob
    else:
        rows = x.shape[0]
        keep = torch.rand((n * rows,) + x.shape[1:], generator=gen,
                          device=x.device)[r * rows:(r + 1) * rows] < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


@contextlib.contextmanager
def _forward_entry(gen, saved: dict):
    """A checkpointed region's forward: records the dropout generator's state
    at its entry."""
    if gen is not None:
        saved["state"] = gen.get_state()
    yield


@contextlib.contextmanager
def _recompute(gen, group, part, saved: dict):
    """The recompute of a checkpointed region: the dropout generator back at
    the state the forward began with (and put back where it was after), the
    forward's ``global_batch`` group and spatial partition (so every rank
    issues the forward's collectives again, in the same order), and batch
    norm's running stats left alone."""
    _RECOMPUTE[0] += 1
    prev_gen, _DROPOUT_GEN[0] = _DROPOUT_GEN[0], gen
    prev_group, _GLOBAL_GROUP[0] = _GLOBAL_GROUP[0], group
    after = gen.get_state() if gen is not None else None
    if gen is not None:
        gen.set_state(saved["state"])
    try:
        with spatial.region(part):
            yield
    finally:
        if gen is not None:
            gen.set_state(after)
        _GLOBAL_GROUP[0] = prev_group
        _DROPOUT_GEN[0] = prev_gen
        _RECOMPUTE[0] -= 1


def checkpointed(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are recomputed in the backward instead of kept, as flax's
    ``nn.remat`` does. ``checkpoint`` restores the global RNGs for the
    recompute but not an explicit generator, so the dropout generator is put
    back to its state at the forward's entry here; batch norm skips its
    running-stat update in the recompute."""
    gen, group, part, saved = _DROPOUT_GEN[0], _GLOBAL_GROUP[0], spatial.active(), {}
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (_forward_entry(gen, saved),
                                          _recompute(gen, group, part, saved)))


# ---------------------------------------------------------------------------
# Normalisation
# ---------------------------------------------------------------------------


class BatchNorm(nn.Module):
    """Batch norm over axis 1 (eps 1e-5, momentum 0.1) with the reference's
    parameter and buffer names; computes in fp32, returns fp32.

    In training it normalises with the batch's mean and its biased variance
    E[x^2] - E[x]^2 (clipped at 0), and moves the running stats toward that
    same biased variance, as flax's ``nn.BatchNorm`` does
    (``F.batch_norm(training=True)`` would move them toward the unbiased
    one); the update is made once per forward, never in the recompute of a
    ``checkpointed`` region. Inside ``global_batch`` the statistics are the
    global batch's: the per-channel sums of x and x^2 and the element count,
    all-reduced in fp32 (``nn.SyncBatchNorm`` would move the running
    variance toward the unbiased one). Inside a spatial partition the sums
    and counts are all-reduced over all the mesh's ranks (each holds its
    columns of its slice; the counts differ where the shards do)."""

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        x = x.float()
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        axes = [0] + list(range(2, x.ndim))
        part = spatial.active()
        group = part.mesh.group if part is not None else _GLOBAL_GROUP[0]
        if group is None:
            mean = x.mean(axes)
            var = ((x * x).mean(axes) - mean * mean).clamp_min(0.0)
        else:
            c = x.shape[1]
            count = x.new_full((1,), x.numel() // c)
            sums = all_reduce_sum(torch.cat([x.sum(axes), (x * x).sum(axes), count]), group)
            mean = sums[:c] / sums[2 * c]
            var = (sums[c:2 * c] / sums[2 * c] - mean * mean).clamp_min(0.0)
        if not _RECOMPUTE[0]:
            keep = 1.0 - self.momentum             # flax's momentum
            with torch.no_grad():
                self.running_mean.copy_(keep * self.running_mean + (1.0 - keep) * mean)
                self.running_var.copy_(keep * self.running_var + (1.0 - keep) * var)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)


class InstanceNorm(nn.Module):
    """Instance norm without affine parameters (eps 1e-5), in x's dtype."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x):
        spatial.refuse("InstanceNorm")
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
        spatial.refuse("GroupNorm")
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
        if spatial.active() is not None:
            raise ValueError(f"shard shapes {tuple(x.shape[-2:])} and {tuple(rem.shape[-2:])} "
                             "differ inside the spatial partition")
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
        spatial.refuse("ChannelAttentionEnhancement")
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
    """Post-norm encoder layer with a GELU feed-forward; in training, dropout
    (``rate``) on the attention output, the hidden layer and the
    feed-forward output."""

    def __init__(self, embed_dim, num_heads, dim_feedforward, rate=0.1, cdt=torch.float32):
        super().__init__()
        self.rate = rate
        self.self_attn = MultiheadAttention(embed_dim, num_heads, cdt=cdt)
        self.linear1 = Linear(embed_dim, dim_feedforward, cdt=cdt)
        self.linear2 = Linear(dim_feedforward, embed_dim, cdt=cdt)
        self.norm1 = LayerNorm(embed_dim)
        self.norm2 = LayerNorm(embed_dim)

    def forward(self, x, grid: tuple[int, int, int] | None = None):
        drop = lambda t: dropout(t, self.rate, self.training, grid)  # noqa: E731
        x = self.norm1(x + drop(self.self_attn(x, x, x)))
        return self.norm2(x + drop(self.linear2(drop(gelu(self.linear1(x))))))


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
            x = layer(x, (B, H, W))
        return x.reshape(B, H, W, D, C).permute(0, 4, 3, 1, 2)
