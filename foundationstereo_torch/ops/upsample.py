"""Disparity regression, convex upsampling and 2x average pooling.

The port of the JAX package's ``ops/upsample.py``. The JAX package's phased
convex upsample is a TPU layout workaround; the port computes the same math
once, from the interleaved (full-resolution) weights of a standard
``ConvTranspose2d``. Inside a spatial partition (``parallel/spatial.py``)
the 3x3 neighbourhoods of both reach one column across the shard borders.
"""

from __future__ import annotations

import torch

from foundationstereo_torch.parallel import spatial


def disparity_regression(prob: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """Soft-argmin: (B, D, H, W) probabilities -> (B, H, W) expected disparity."""
    d = torch.arange(maxdisp, device=prob.device, dtype=prob.dtype).reshape(1, maxdisp, 1, 1)
    return torch.sum(prob * d, dim=1)


def context_upsample(disp_low: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Convex 1/4 -> full-resolution upsampling.

    disp_low: (B, h, w) disparity at 1/4 resolution (already scaled by 4);
    weights: (B, 9, 4h, 4w) softmax weights over the 3x3 neighbourhood taps
    (row-major over (dy, dx), ``F.unfold`` order). Returns (B, 4h, 4w).
    """
    b, h, w = disp_low.shape
    taps = spatial.unfold3(disp_low[:, None]).reshape(b, 9, h, w)
    taps = taps.repeat_interleave(4, dim=2).repeat_interleave(4, dim=3)
    return torch.sum(taps * weights, dim=1)


def avg_pool2x(x: torch.Tensor) -> torch.Tensor:
    """``F.avg_pool2d(x, 3, stride=2, padding=1)`` with count_include_pad."""
    return spatial.avg_pool2x(x)
