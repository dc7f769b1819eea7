"""Hierarchical (coarse-to-fine, two-pass) inference.

The port of the JAX package's ``inference/hierarchical.py``: run the model at
``small_ratio`` of the resolution, upsample that disparity, and feed it (on
the 1/4 grid, at 1/4 of its value, offset by the left pad) as ``init_disp``
into the full-resolution pass, which then skips the soft-argmin
initialisation.
"""

from __future__ import annotations

import torch

from foundationstereo_torch.ops.pad import InputPadder
from foundationstereo_torch.ops.resize import resize2d


def _resize_nhwc(x: torch.Tensor, hw, align_corners: bool) -> torch.Tensor:
    return resize2d(x.permute(0, 3, 1, 2), hw, "bilinear", align_corners).permute(0, 2, 3, 1)


def run_hierarchical(model: torch.nn.Module, left: torch.Tensor, right: torch.Tensor,
                     iters: int = 32, small_ratio: float = 0.5) -> torch.Tensor:
    """left/right: (B, H, W, 3) float RGB in 0-255 on the model's device, any
    size (padded here to multiples of 32). Returns the (B, H, W) disparity."""
    B, H, W, _ = left.shape
    hw_s = (int(H * small_ratio), int(W * small_ratio))
    left_s, right_s = _resize_nhwc(left, hw_s, False), _resize_nhwc(right, hw_s, False)

    padder_s = InputPadder(left_s.shape, divis_by=32)
    ls, rs = padder_s.pad(left_s, right_s)
    disp_s = model(ls, rs, iters=iters, test_mode=True)                   # (B, h', w')
    disp_s = padder_s.unpad(disp_s[..., None])
    disp_up = (_resize_nhwc(disp_s, (H, W), True) / small_ratio).clamp_min(0.0)

    padder = InputPadder(left.shape, divis_by=32)
    lf, rf, disp_up = padder.pad(left, right, disp_up)
    disp_up = disp_up + padder.pad_left
    hp, wp = lf.shape[1], lf.shape[2]
    init_disp = _resize_nhwc(disp_up, (hp // 4, wp // 4), True)[..., 0] * 0.25
    disp = model(lf, rf, iters=iters, test_mode=True, init_disp=init_disp)
    return padder.unpad(disp[..., None])[..., 0]
