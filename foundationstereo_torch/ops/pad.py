"""Input padding to divisibility constraints (replicate pad)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


class InputPadder:
    """Pads (B, H, W, C) images so H and W divide ``divis_by``, as the JAX
    package's ``InputPadder``: mode "sintel" centres the pad on both axes,
    any other mode centres it on W and pads H at the bottom only;
    ``force_square`` pads both sides past the longer one."""

    def __init__(self, dims, mode: str = "sintel", divis_by: int = 8,
                 force_square: bool = False):
        # dims: a (B, H, W, C) shape, or (H, W).
        self.ht, self.wd = (dims[-3], dims[-2]) if len(dims) >= 3 else tuple(dims)
        if force_square:
            side = max(self.ht, self.wd)
            pad_ht = ((side // divis_by) + 1) * divis_by - self.ht
            pad_wd = ((side // divis_by) + 1) * divis_by - self.wd
        else:
            pad_ht = (((self.ht // divis_by) + 1) * divis_by - self.ht) % divis_by
            pad_wd = (((self.wd // divis_by) + 1) * divis_by - self.wd) % divis_by
        if mode == "sintel":
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2, pad_ht // 2, pad_ht - pad_ht // 2]
        else:
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht]

    @property
    def pad_left(self) -> int:
        """The left pad: hierarchical mode offsets the disparity by it."""
        return self._pad[0]

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

    def pad_np(self, *inputs: np.ndarray):
        """The numpy twin of :meth:`pad` (same placement, edge mode)."""
        l, r, t, b = self._pad
        out = []
        for x in inputs:
            if x.ndim != 4:
                raise ValueError(f"expected (B, H, W, C), got {tuple(x.shape)}")
            out.append(np.pad(x, ((0, 0), (t, b), (l, r), (0, 0)), mode="edge"))
        return out if len(out) > 1 else out[0]

    def unpad(self, x):
        """(B, H, W, C) -> the unpadded window."""
        if x.ndim != 4:
            raise ValueError(f"expected (B, H, W, C), got {tuple(x.shape)}")
        l, r, t, b = self._pad
        h, w = x.shape[1], x.shape[2]
        return x[:, t:h - b, l:w - r, :]
