"""Input padding to divisibility constraints (replicate pad, centred placement)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


class InputPadder:
    """Pads (B, H, W, C) images so H and W divide ``divis_by``, centring the
    pad, as the JAX package's ``InputPadder`` does in its default mode."""

    def __init__(self, dims, divis_by: int = 8):
        # dims: a (B, H, W, C) shape, or (H, W).
        self.ht, self.wd = (dims[-3], dims[-2]) if len(dims) >= 3 else tuple(dims)
        pad_ht = (((self.ht // divis_by) + 1) * divis_by - self.ht) % divis_by
        pad_wd = (((self.wd // divis_by) + 1) * divis_by - self.wd) % divis_by
        self._pad = [pad_wd // 2, pad_wd - pad_wd // 2, pad_ht // 2, pad_ht - pad_ht // 2]

    @property
    def pads(self):
        """(left, right, top, bottom) pad amounts."""
        return tuple(self._pad)

    def padded_shape(self):
        l, r, t, b = self._pad
        return self.ht + t + b, self.wd + l + r

    def pad(self, *inputs: torch.Tensor):
        out = []
        for x in inputs:
            if x.ndim != 4:
                raise ValueError(f"expected (B, H, W, C), got {tuple(x.shape)}")
            y = F.pad(x.permute(0, 3, 1, 2), self._pad, mode="replicate")
            out.append(y.permute(0, 2, 3, 1))
        return out if len(out) > 1 else out[0]

    def unpad(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> the unpadded window."""
        if x.ndim != 4:
            raise ValueError(f"expected (B, H, W, C), got {tuple(x.shape)}")
        l, r, t, b = self._pad
        h, w = x.shape[1], x.shape[2]
        return x[:, t:h - b, l:w - r, :]
