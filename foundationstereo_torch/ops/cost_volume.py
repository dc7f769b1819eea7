"""Cost-volume construction (channel-first, NCDHW volumes).

The port of the JAX package's ``ops/cost_volume.py``. Correlations are
computed in fp32 whatever the input dtype. ``cost_volume_parts`` is the plain
twin of the cost-volume kernel (``ops/kernels.py:cost_volume_parts``),
``cost_volume_parts_haloed`` that of its width-shard form
(``ops/kernels.py:cost_volume_parts_haloed``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def group_normalize(feat: torch.Tensor, num_groups: int, eps: float = 1e-12) -> torch.Tensor:
    """(B, C, H, W) -> (B, G, C/G, H, W), L2-normalised within each group (fp32)."""
    b, c, h, w = feat.shape
    if c % num_groups:
        raise ValueError(f"C={c} not divisible by groups={num_groups}")
    x = feat.float().reshape(b, num_groups, c // num_groups, h, w)
    norm = torch.sqrt(torch.sum(x * x, dim=2, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def build_gwc_volume(left: torch.Tensor, right: torch.Tensor, maxdisp: int,
                     num_groups: int) -> torch.Tensor:
    """Group-wise correlation volume, (B, C, H, W) x 2 -> (B, G, D, H, W) fp32.

    gwc[b, g, d, h, w] = <Ln[b, g, :, h, w], Rn[b, g, :, h, w - d]>, 0 where w < d.
    """
    b, c, h, w = left.shape
    ln = group_normalize(left, num_groups)
    rn = group_normalize(right, num_groups)
    vol = ln.new_zeros((b, num_groups, maxdisp, h, w))
    for d in range(min(maxdisp, w)):
        vol[:, :, d, :, d:] = (ln[..., d:] * rn[..., :w - d]).sum(dim=2)
    return vol


def shift_right(x: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, D, H, W) with out[..., d, h, w] = x[..., h, w - d]
    (0 where w < d)."""
    b, c, h, w = x.shape
    out = x.new_zeros((b, c, maxdisp, h, w))
    for d in range(min(maxdisp, w)):
        out[:, :, d, :, d:] = x[..., :w - d]
    return out


def build_concat_volume(left: torch.Tensor, right: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """Concatenation volume: (B, C, H, W) x 2 -> (B, 2C, D, H, W) in the input
    dtype; channels [left, right shifted by d]."""
    left_b = left[:, :, None].expand(-1, -1, maxdisp, -1, -1)
    return torch.cat([left_b, shift_right(right, maxdisp)], dim=1)


def cost_volume_parts(left: torch.Tensor, right: torch.Tensor, right_proj: torch.Tensor,
                      maxdisp: int, num_groups: int,
                      out_dtype: torch.dtype = torch.float32):
    """Plain twin of the cost-volume kernel.

    left/right (B, C, H, W) features, right_proj (B, P, H, W) ->
    gwc (B, G, D, H, W) and rps (B, P, D, H, W) in ``out_dtype``, where
    rps[b, p, d, h, w] = right_proj[b, p, h, w - d] (0 where w < d). The
    d-invariant left-projection part of the concat volume is not emitted:
    ``CorrStem`` adds it once per pixel.
    """
    gwc = build_gwc_volume(left, right, maxdisp, num_groups).to(out_dtype)
    rps = shift_right(right_proj.float(), maxdisp).to(out_dtype)
    return gwc, rps


def cost_volume_parts_haloed(left: torch.Tensor, right: torch.Tensor, right_proj: torch.Tensor,
                             maxdisp: int, num_groups: int, x_offset: int,
                             out_dtype: torch.dtype = torch.float32):
    """Plain twin of the haloed cost-volume kernel: one width shard.

    left (B, C, H, W_local) holds the global columns [x_offset, x_offset +
    W_local); right (B, C, H, W) and right_proj (B, P, H, W) are full width.
    Returns gwc (B, G, D, H, W_local) and rps (B, P, D, H, W_local) in
    ``out_dtype``: gwc[..., d, h, w] = <Ln[..., h, w], Rn[..., h, x_offset +
    w - d]> and rps[..., d, h, w] = right_proj[..., h, x_offset + w - d], 0
    where x_offset + w < d. As the TPU kernel receives them, the right rows
    are cut to the window [x_offset - D, x_offset + W_local) of the rows
    zero-padded by D columns on the left.
    """
    w = left.shape[-1]
    win = slice(x_offset, x_offset + maxdisp + w)
    ln = group_normalize(left, num_groups)
    rn = group_normalize(F.pad(right.float(), (maxdisp, 0)), num_groups)[..., win]
    rp = F.pad(right_proj.float(), (maxdisp, 0))[..., win]
    shifts = [slice(maxdisp - d, maxdisp - d + w) for d in range(maxdisp)]
    gwc = torch.stack([(ln * rn[..., s]).sum(dim=2) for s in shifts], dim=2)
    rps = torch.stack([rp[..., s] for s in shifts], dim=2)
    return gwc.to(out_dtype), rps.to(out_dtype)


def all_pairs_correlation(left: torch.Tensor, right: torch.Tensor,
                          eps: float = 1e-12) -> torch.Tensor:
    """corr[b, h, w1, w2] = <Ln[b, :, h, w1], Rn[b, :, h, w2]> with a
    full-channel L2 norm: (B, C, H, W) x 2 -> (B, H, W1, W2) fp32."""
    ln = group_normalize(left, 1, eps)[:, 0]    # (B, C, H, W)
    rn = group_normalize(right, 1, eps)[:, 0]
    return torch.einsum("bchw,bchv->bhwv", ln, rn)
