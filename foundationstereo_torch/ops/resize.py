"""Torch-semantics resizing built on explicit interpolation matrices.

The same (out, in) matrices as the JAX package's ``ops/resize.py``: the
bicubic pos-embed interpolation with an explicit fractional scale factor and
the DPT's composed up-then-down ``out_hw`` map need the exact matrices, so
``F.interpolate`` is not used. Tensors are channel-first: the resized axes
are the trailing ones ((..., H, W) or (..., D, H, W)).

2-byte float inputs interpolate at their own width (the matrix is cast
down) and fp32 inputs in fp32, as in the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def interp_matrix_np(in_size: int, out_size: int, method: str, align_corners: bool,
                     scale_factor: float | None = None) -> np.ndarray:
    """Dense (out_size, in_size) interpolation matrix with torch semantics.

    ``scale_factor`` (align_corners=False only) uses torch's scale-factor
    coordinate map src = (dst + 0.5) / scale - 0.5 instead of the size ratio.
    """
    if align_corners:
        if out_size == 1:
            src = np.zeros(out_size, np.float64)
        else:
            src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    else:
        scale = (1.0 / scale_factor) if scale_factor else (in_size / out_size)
        src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5

    m = np.zeros((out_size, in_size), np.float64)
    rows = np.arange(out_size)
    if method == "linear":
        x0 = np.floor(src).astype(np.int64)
        w1 = src - x0
        for tap, w in ((x0, 1.0 - w1), (x0 + 1, w1)):
            np.add.at(m, (rows, np.clip(tap, 0, in_size - 1)), w)
    elif method == "cubic":
        a = -0.75  # Keys cubic convolution kernel, torch's choice

        def k(t):
            t = np.abs(t)
            return np.where(
                t <= 1.0,
                ((a + 2.0) * t - (a + 3.0)) * t * t + 1.0,
                np.where(t < 2.0, (((t - 5.0) * t + 8.0) * t - 4.0) * a, 0.0),
            )

        x0 = np.floor(src).astype(np.int64)
        for off in (-1, 0, 1, 2):
            tap = x0 + off
            np.add.at(m, (rows, np.clip(tap, 0, in_size - 1)), k(src - tap))
    else:
        raise ValueError(f"unknown method {method}")
    return m.astype(np.float32)


_METHOD_ALIASES = {"bilinear": "linear", "trilinear": "linear", "bicubic": "cubic"}


def _apply_axis(x: torch.Tensor, m: np.ndarray, axis: int) -> torch.Tensor:
    """Contract axis ``axis`` of ``x`` with the (out, in) matrix ``m``."""
    cdt = x.dtype if x.dtype in (torch.bfloat16, torch.float16) else torch.float32
    mt = torch.from_numpy(m).to(device=x.device, dtype=cdt)
    y = torch.tensordot(x.to(cdt), mt, dims=([axis], [1]))   # axis moved last
    return y.movedim(-1, axis).to(x.dtype)


def resize2d(x: torch.Tensor, out_hw: tuple[int, int], method: str = "bilinear",
             align_corners: bool = False) -> torch.Tensor:
    """``F.interpolate(x, size=out_hw, mode=method, align_corners=...)`` on the
    two trailing axes, through the interpolation matrices."""
    method = _METHOD_ALIASES[method]
    h_in, w_in = x.shape[-2], x.shape[-1]
    if h_in != out_hw[0]:
        x = _apply_axis(x, interp_matrix_np(h_in, out_hw[0], method, align_corners), x.ndim - 2)
    if w_in != out_hw[1]:
        x = _apply_axis(x, interp_matrix_np(w_in, out_hw[1], method, align_corners), x.ndim - 1)
    return x


def resize2d_via(x: torch.Tensor, mid_hw: tuple[int, int], out_hw: tuple[int, int],
                 method: str = "bilinear", align_corners: bool = False) -> torch.Tensor:
    """``resize2d(resize2d(x, mid_hw), out_hw)`` as one composed matrix per
    axis (multiplied in float64), so the intermediate never exists."""
    method = _METHOD_ALIASES[method]
    for axis, (n_in, n_mid, n_out) in ((x.ndim - 2, (x.shape[-2], mid_hw[0], out_hw[0])),
                                       (x.ndim - 1, (x.shape[-1], mid_hw[1], out_hw[1]))):
        if (n_mid, n_out) == (n_in, n_in):
            continue
        m1 = interp_matrix_np(n_in, n_mid, method, align_corners).astype(np.float64)
        m2 = interp_matrix_np(n_mid, n_out, method, align_corners).astype(np.float64)
        x = _apply_axis(x, (m2 @ m1).astype(np.float32), axis)
    return x


def resize_dhw(x: torch.Tensor, out_dhw: tuple[int, int, int], method: str = "trilinear",
               align_corners: bool = False) -> torch.Tensor:
    """Resize the three trailing (D, H, W) axes (torch trilinear)."""
    method = _METHOD_ALIASES[method]
    for i, n_out in enumerate(out_dhw):
        axis = x.ndim - 3 + i
        if x.shape[axis] != n_out:
            x = _apply_axis(x, interp_matrix_np(x.shape[axis], n_out, method, align_corners), axis)
    return x
