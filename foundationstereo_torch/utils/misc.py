"""Shared helpers (the port's copy of the JAX package's ``utils/misc.py``)."""

from __future__ import annotations

import math

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def get_resize_keep_aspect_ratio(H: int, W: int, divider: int = 16,
                                 max_H: int = 1232, max_W: int = 1232):
    """Round (H, W) up to multiples of ``divider``, capped at (max_H, max_W)
    with the aspect ratio kept."""
    if max_H % divider or max_W % divider:
        raise ValueError(f"max sizes ({max_H}, {max_W}) not divisible by {divider}")

    def round_by_divider(x):
        return int(math.ceil(x / divider) * divider)

    H_resize = round_by_divider(H)
    W_resize = round_by_divider(W)
    if H_resize > max_H or W_resize > max_W:
        if H_resize > W_resize:
            W_resize = round_by_divider(W_resize * max_H / H_resize)
            H_resize = max_H
        else:
            H_resize = round_by_divider(H_resize * max_W / W_resize)
            W_resize = max_W
    return int(H_resize), int(W_resize)


def depth_uint8_decoding(depth_uint8: np.ndarray, scale: float = 1000) -> np.ndarray:
    """Decode a 3-channel base-255 uint8 disparity image (float64)."""
    d = depth_uint8.astype(np.float64)
    return (d[..., 0] * 255 * 255 + d[..., 1] * 255 + d[..., 2]) / float(scale)


def depth_uint8_encoding(depth: np.ndarray, scale: float = 1000) -> np.ndarray:
    """Inverse of :func:`depth_uint8_decoding` (for writing datasets)."""
    v = np.round(depth.astype(np.float64) * scale).astype(np.int64)
    c0 = v // (255 * 255)
    rem = v - c0 * 255 * 255
    c1 = rem // 255
    c2 = rem - c1 * 255
    return np.stack([c0, c1, c2], axis=-1).astype(np.uint8)


def set_seed(seed: int) -> None:
    """Seed numpy's and Python's global generators (the data pipeline's
    sampling draws from Python's ``random``)."""
    import random

    np.random.seed(seed)
    random.seed(seed)
