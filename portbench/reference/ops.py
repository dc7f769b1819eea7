"""Plain tensor operations of the reference: precision casts, resizing,
cost volumes, the disparity lookup, convex upsampling and padding.

A frozen copy of the model's published arithmetic in plain ``torch``; it
imports nothing of the program under test.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)
# The precision the controls compute in, the step below a bf16 configuration.
CONTROL_DTYPE = torch.float8_e4m3fn
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _round(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """x rounded to ``dt`` with one scale per tensor (its absolute maximum
    onto the format's largest value), returned in fp32."""
    x = x.float()
    scale = x.abs().amax().clamp_min(1e-30) / torch.finfo(dt).max
    return (x / scale).to(dt).float() * scale


class _RoundFp8(torch.autograd.Function):
    """An fp8 operand as fp8 training rounds it: e4m3 in the forward, and its
    gradient in e5m2 (each with one scale per tensor) in the backward."""

    @staticmethod
    def forward(ctx, x, dt):
        return _round(x, dt)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2), None


def cast(x: torch.Tensor | None, dt: torch.dtype) -> torch.Tensor | None:
    """``x`` in the compute dtype ``dt``. An fp8 ``dt`` gives x as an fp8
    matrix unit reads it (``_RoundFp8``), in fp32 for the fp32 accumulation."""
    if x is None:
        return None
    if dt in FP8:
        return _RoundFp8.apply(x, dt)
    return x.to(dt)


def leaky_relu(x):
    """LeakyReLU (slope 0.01) with derivative 1 at exactly 0."""
    return torch.where(x >= 0, x, 0.01 * x)


# ---------------------------------------------------------------------------
# resizing: dense interpolation matrices with torch's semantics
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=256)
def interp_matrix(in_size: int, out_size: int, method: str, align_corners: bool,
                  scale_factor: float | None = None) -> np.ndarray:
    """(out_size, in_size) matrix of ``F.interpolate`` along one axis."""
    if method == "nearest":
        idx = np.minimum((np.arange(out_size) * (in_size / out_size)).astype(np.int64),
                         in_size - 1)
        m = np.zeros((out_size, in_size), np.float64)
        m[np.arange(out_size), idx] = 1.0
        return m.astype(np.float32)
    if align_corners:
        src = (np.zeros(out_size) if out_size == 1 else
               np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1))
    else:
        scale = (1.0 / scale_factor) if scale_factor else (in_size / out_size)
        src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    m = np.zeros((out_size, in_size), np.float64)
    rows = np.arange(out_size)
    x0 = np.floor(src).astype(np.int64)
    if method == "linear":
        w1 = src - x0
        for tap, w in ((x0, 1.0 - w1), (x0 + 1, w1)):
            np.add.at(m, (rows, np.clip(tap, 0, in_size - 1)), w)
    elif method == "cubic":
        a = -0.75

        def k(t):
            t = np.abs(t)
            return np.where(t <= 1.0, ((a + 2.0) * t - (a + 3.0)) * t * t + 1.0,
                            np.where(t < 2.0, (((t - 5.0) * t + 8.0) * t - 4.0) * a, 0.0))

        for off in (-1, 0, 1, 2):
            tap = x0 + off
            np.add.at(m, (rows, np.clip(tap, 0, in_size - 1)), k(src - tap))
    else:
        raise ValueError(method)
    return m.astype(np.float32)


_METHODS = {"bilinear": "linear", "trilinear": "linear", "bicubic": "cubic", "nearest": "nearest"}


def apply_axis(x: torch.Tensor, m: np.ndarray, axis: int) -> torch.Tensor:
    mt = torch.from_numpy(m).to(device=x.device, dtype=x.dtype)
    return torch.tensordot(x, mt, dims=([axis], [1])).movedim(-1, axis)


def resize(x: torch.Tensor, out: tuple[int, ...], method: str = "bilinear",
           align_corners: bool = False) -> torch.Tensor:
    """Resize the ``len(out)`` trailing axes of x."""
    method = _METHODS[method]
    for i, n_out in enumerate(out):
        axis = x.ndim - len(out) + i
        if x.shape[axis] != n_out:
            x = apply_axis(x, interp_matrix(x.shape[axis], n_out, method, align_corners), axis)
    return x


def resize_via(x: torch.Tensor, mid: tuple[int, int], out: tuple[int, int],
               method: str = "bilinear", align_corners: bool = False) -> torch.Tensor:
    """``resize(resize(x, mid), out)`` with the two matrices of each axis
    multiplied first (in float64)."""
    method = _METHODS[method]
    for i in range(2):
        axis = x.ndim - 2 + i
        n_in = x.shape[axis]
        if (mid[i], out[i]) == (n_in, n_in):
            continue
        m1 = interp_matrix(n_in, mid[i], method, align_corners).astype(np.float64)
        m2 = interp_matrix(mid[i], out[i], method, align_corners).astype(np.float64)
        x = apply_axis(x, (m2 @ m1).astype(np.float32), axis)
    return x


def resize_keep_aspect(H: int, W: int, divider: int, max_H: int, max_W: int) -> tuple[int, int]:
    """(H, W) rounded up to multiples of ``divider``, capped with the aspect kept."""
    def up(x):
        return int(math.ceil(x / divider) * divider)

    h, w = up(H), up(W)
    if h > max_H or w > max_W:
        if h > w:
            h, w = max_H, up(w * max_H / h)
        else:
            h, w = up(h * max_W / w), max_W
    return h, w


# ---------------------------------------------------------------------------
# cost volumes, pyramids, lookup, upsampling
# ---------------------------------------------------------------------------


def group_normalize(feat: torch.Tensor, groups: int, eps: float = 1e-12) -> torch.Tensor:
    """(B, C, H, W) -> (B, G, C/G, H, W), L2-normalised within each group, fp32."""
    b, c, h, w = feat.shape
    x = feat.float().reshape(b, groups, c // groups, h, w)
    return x / torch.sqrt((x * x).sum(dim=2, keepdim=True)).clamp_min(eps)


def shift_right(x: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """(..., H, W) -> (..., D, H, W): out[..., d, h, w] = x[..., h, w - d], 0 where w < d."""
    w = x.shape[-1]
    out = x.new_zeros(x.shape[:-2] + (maxdisp,) + x.shape[-2:])
    for d in range(min(maxdisp, w)):
        out[..., d, :, d:] = x[..., :w - d]
    return out


def gwc_volume(left: torch.Tensor, right: torch.Tensor, maxdisp: int, groups: int):
    """Group-wise correlation volume (B, G, D, H, W), fp32."""
    ln, rn = group_normalize(left, groups), group_normalize(right, groups)
    b, g, _, h, w = ln.shape
    vol = ln.new_zeros((b, g, maxdisp, h, w))
    for d in range(min(maxdisp, w)):
        vol[:, :, d, :, d:] = (ln[..., d:] * rn[..., :w - d]).sum(dim=2)
    return vol


def concat_volume(left: torch.Tensor, right: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """[left, right shifted by d] along channels: (B, 2C, D, H, W)."""
    return torch.cat([left[:, :, None].expand(-1, -1, maxdisp, -1, -1),
                      shift_right(right, maxdisp)], dim=1)


def all_pairs_correlation(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) x 2 -> (B, H, W1, W2) of full-channel-normalised dots, fp32."""
    ln, rn = group_normalize(left, 1)[:, 0], group_normalize(right, 1)[:, 0]
    return torch.einsum("bchw,bchv->bhwv", ln, rn)


def pool_last_axis(x: torch.Tensor, times: int) -> list[torch.Tensor]:
    """x and ``times`` successive 2x average poolings of its last axis (floor)."""
    levels = [x]
    for _ in range(times):
        n = x.shape[-1] // 2
        x = x[..., :2 * n].reshape(x.shape[:-1] + (n, 2)).mean(dim=-1)
        levels.append(x)
    return levels


def sample_linear(vol: torch.Tensor, x: torch.Tensor, radius: int) -> torch.Tensor:
    """vol (..., L) sampled linearly at x + k for k in [-r, r], zero outside
    [0, L - 1]: (..., 2r + 1)."""
    L = vol.shape[-1]
    taps = x[..., None] + torch.arange(-radius, radius + 1, device=vol.device, dtype=x.dtype)
    x0 = torch.floor(taps)
    f = taps - x0
    out = 0.0
    for idx, w in ((x0, 1.0 - f), (x0 + 1, f)):
        valid = (idx >= 0) & (idx <= L - 1)
        i = idx.clamp(0, L - 1).long()
        out = out + torch.gather(vol.float(), -1, i) * valid * w
    return out


def disparity_lookup(geo_pyr, corr_pyr, disp: torch.Tensor, radius: int) -> torch.Tensor:
    """Geometry (B, H, W, C, D_l) and correlation (B, H, W, W_l) levels
    sampled at ``disp`` / 2^l and (x - disp) / 2^l: (B, L (C + 1) (2r + 1), H, W)."""
    b, h, w = disp.shape
    x = torch.arange(w, device=disp.device, dtype=torch.float32)
    out = []
    for i, (geo, corr) in enumerate(zip(geo_pyr, corr_pyr)):
        s = 0.5 ** i
        xg = (disp * s)[..., None].expand(b, h, w, geo.shape[3])
        out.append(sample_linear(geo, xg, radius).reshape(b, h, w, -1))
        out.append(sample_linear(corr, (x - disp) * s, radius))
    return torch.cat(out, dim=-1).permute(0, 3, 1, 2)


def disparity_regression(prob: torch.Tensor, maxdisp: int) -> torch.Tensor:
    d = torch.arange(maxdisp, device=prob.device, dtype=prob.dtype).reshape(1, maxdisp, 1, 1)
    return (prob * d).sum(dim=1)


def context_upsample(disp_low: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Convex upsampling: (B, h, w) with (B, 9, 4h, 4w) weights -> (B, 4h, 4w)."""
    b, h, w = disp_low.shape
    taps = F.unfold(disp_low[:, None], 3, padding=1).reshape(b, 9, h, w)
    taps = taps.repeat_interleave(4, dim=2).repeat_interleave(4, dim=3)
    return (taps * weights).sum(dim=1)


def avg_pool2x(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=True)


def normalize_image(img: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) in 0-255 -> (B, 3, H, W) ImageNet-normalised fp32."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=img.device)
    std = torch.as_tensor(IMAGENET_STD, device=img.device)
    return ((img.float() / 255.0 - mean) / std).permute(0, 3, 1, 2)


def pad_to(img: torch.Tensor, divis_by: int = 32) -> tuple[torch.Tensor, tuple[int, int, int, int]]:
    """(B, H, W, C) replicate-padded so H and W divide ``divis_by``, the pad
    centred on both axes; returns the image and (left, right, top, bottom)."""
    h, w = img.shape[1:3]
    ph, pw = (-h) % divis_by, (-w) % divis_by
    pads = (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2)
    return F.pad(img.permute(0, 3, 1, 2), pads, mode="replicate").permute(0, 2, 3, 1), pads
