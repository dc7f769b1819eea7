"""Disparity visualization (reference Utils.py:108-133) without cv2.

The port's own copy of the JAX package's ``utils/vis.py``, numpy only.

Uses Google's polynomial approximation of the TURBO colormap (public domain
reference implementation) to mirror cv2.COLORMAP_TURBO.
"""

from __future__ import annotations

import numpy as np

_TURBO_R = np.array([0.13572138, 4.61539260, -42.66032258, 132.13108234,
                     -152.94239396, 59.28637943])
_TURBO_G = np.array([0.09140261, 2.19418839, 4.84296658, -14.18503333,
                     4.27729857, 2.82956604])
_TURBO_B = np.array([0.10667330, 12.64194608, -60.58204836, 110.36276771,
                     -89.90310912, 27.34824973])


def turbo_colormap(x: np.ndarray) -> np.ndarray:
    """Map x in [0, 1] -> RGB uint8 via the turbo polynomial."""
    x = np.clip(x, 0.0, 1.0)
    v = np.stack([np.ones_like(x), x, x ** 2, x ** 3, x ** 4, x ** 5], axis=-1)
    r = v @ _TURBO_R
    g = v @ _TURBO_G
    b = v @ _TURBO_B
    rgb = np.stack([r, g, b], axis=-1)
    return (np.clip(rgb, 0.0, 1.0) * 255).astype(np.uint8)


def vis_disparity(disp: np.ndarray, min_val=None, max_val=None,
                  invalid_thres=np.inf, other_output=None) -> np.ndarray:
    """(H, W) disparity -> (H, W, 3) uint8 turbo visualization."""
    if other_output is None:
        other_output = {}
    disp = np.array(disp, copy=True)
    H, W = disp.shape[:2]
    invalid_mask = disp >= invalid_thres
    if (invalid_mask == 0).sum() == 0:
        other_output["min_val"] = None
        other_output["max_val"] = None
        return np.zeros((H, W, 3), np.uint8)
    if min_val is None:
        min_val = disp[invalid_mask == 0].min()
    if max_val is None:
        max_val = disp[invalid_mask == 0].max()
    other_output["min_val"] = min_val
    other_output["max_val"] = max_val
    denom = max(max_val - min_val, 1e-12)
    norm = np.clip((disp - min_val) / denom, 0, 1)
    vis = turbo_colormap(norm)
    if invalid_mask.any():
        vis[invalid_mask] = 0
    return vis
