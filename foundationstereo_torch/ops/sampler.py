"""1-D linear disparity lookup over the geometry and correlation pyramids.

The port of the JAX package's ``ops/sampler.py``. ``disparity_lookup`` is
also the plain twin of the lookup kernel (``ops/kernels.py``): it samples by
a direct two-tap gather (all 2r+1 taps share one fractional part), with
zero padding outside [0, L-1] -- ``grid_sample`` with ``align_corners=True``
and ``padding_mode="zeros"``, the same values as the JAX package's tent-weight
contraction.
"""

from __future__ import annotations

import torch


def pool_last_axis(x: torch.Tensor, times: int) -> list[torch.Tensor]:
    """Average-pool the last axis by 2, ``times`` times; returns all levels
    (floor semantics: a trailing odd element is dropped)."""
    levels = [x]
    for _ in range(times):
        n = x.shape[-1] // 2
        x = x[..., :2 * n].reshape(x.shape[:-1] + (n, 2)).mean(dim=-1)
        levels.append(x)
    return levels


def _sample_taps(vol: torch.Tensor, x: torch.Tensor, radius: int) -> torch.Tensor:
    """vol (..., L), x (...) positions -> (..., 2r+1) samples at x + k, k in [-r, r]."""
    L = vol.shape[-1]
    # Far-out positions are zero either way; the clamp keeps the index math finite.
    x = x.clamp(-(L + 2 * radius + 2), L + 2 * radius + 2)
    x0 = torch.floor(x)
    f = (x - x0)[..., None]
    offs = torch.arange(-radius, radius + 2, device=vol.device)
    idx = x0.long()[..., None] + offs                         # (..., 2r+2)
    valid = (idx >= 0) & (idx < L)
    v = torch.gather(vol, -1, idx.clamp(0, L - 1)).float() * valid
    return v[..., :-1] * (1.0 - f) + v[..., 1:] * f


def disparity_lookup(geo_pyramid: list[torch.Tensor], corr_pyramid: list[torch.Tensor],
                     disp: torch.Tensor, radius: int,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Gather geometry and all-pairs-correlation features at ``disp``.

    geo_pyramid: levels of (B, H, W, C, D_l); corr_pyramid: levels of
    (B, H, W, W_l); disp: (B, H, W) fp32 at 1/4 resolution. Level l samples
    the geometry at disp / 2^l + k and the correlation at (x - disp) / 2^l + k.

    Returns (B, L * (C + 1) * (2r + 1), H, W) in ``out_dtype`` (fp32
    accumulation), channels [geo_l0 (C-major, taps fastest), corr_l0, geo_l1, ...].
    """
    b, h, w = disp.shape
    disp = disp.float()
    coords = torch.arange(w, device=disp.device, dtype=torch.float32)
    out = []
    for i, (geo, corr) in enumerate(zip(geo_pyramid, corr_pyramid)):
        scale = 1.0 / (2.0 ** i)
        c = geo.shape[3]
        xg = (disp * scale)[..., None].expand(b, h, w, c)
        out.append(_sample_taps(geo, xg, radius).reshape(b, h, w, -1))
        out.append(_sample_taps(corr, (coords - disp) * scale, radius))
    return torch.cat(out, dim=-1).permute(0, 3, 1, 2).to(out_dtype)
