"""Single-pair inference: the request path the port serves.

``run_pair`` pads the pair to multiples of 32, runs the forward and unpads,
as the JAX package's demo does for one pair. The command-line demo, image and
point-cloud I/O and the hierarchical mode are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from foundationstereo_torch.ops.pad import InputPadder


def run_pair(model: torch.nn.Module, left, right, iters: int = 32) -> torch.Tensor:
    """left/right: (B, H, W, 3) or (H, W, 3) RGB in 0-255 (arrays or tensors),
    moved to the model's device. Returns the (B, H, W) disparity there."""
    device = next(model.parameters()).device
    pair = []
    for img in (left, right):
        t = torch.as_tensor(np.asarray(img) if not isinstance(img, torch.Tensor) else img,
                            device=device).float()
        pair.append(t[None] if t.ndim == 3 else t)
    padder = InputPadder(pair[0].shape, divis_by=32)
    lp, rp = padder.pad(*pair)
    with torch.inference_mode():
        disp = model(lp, rp, iters=iters, test_mode=True)
    return padder.unpad(disp[..., None])[..., 0]
