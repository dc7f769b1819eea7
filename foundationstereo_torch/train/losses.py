"""Training losses and stereo metrics, batched.

The port of the JAX package's ``train/losses.py``: every function takes
(B, H, W) predictions, ground truth and masks and returns per-sample (B,)
losses and a dict of per-sample metric tensors; the trainer weights the
per-sample losses by the config's per-label-type weights.

Naming: the reference's ``d1_error`` is the >3 px rate and ``d3_error`` the
>1 px rate (swapped against convention); both those names and the
conventional ``bp1``/``bp2``/``bp3`` are reported.
"""

from __future__ import annotations

from typing import Callable

import torch

from foundationstereo_torch.ops.resize import resize2d


def _smooth_l1(x: torch.Tensor, y: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    diff = (x - y).abs()
    if beta == 0:
        return diff
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-sample masked mean over (H, W): (B, H, W) -> (B,), 0 where the
    mask is empty."""
    m = mask.to(x.dtype)
    count = m.sum(dim=(1, 2))
    total = (x * m).sum(dim=(1, 2))
    return torch.where(count > 0, total / count.clamp_min(1.0), torch.zeros_like(total))


def _resize_pred(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Bilinear-resize a (B, h, w) prediction to gt's (H, W)
    (align_corners=False), the reference's resolution-mismatch handling."""
    if pred.shape[1:] != gt.shape[1:]:
        pred = resize2d(pred[:, None], tuple(gt.shape[1:3]), "bilinear", False)[:, 0]
    return pred


def _rate(diff: torch.Tensor, t: float, mask: torch.Tensor) -> torch.Tensor:
    return _masked_mean((diff > t).float(), mask)


def _error_metrics(pred, gt, mask, prefix=""):
    diff = (pred - gt).abs()
    return {
        prefix + "epe": _masked_mean(diff, mask),
        prefix + "bp1": _rate(diff, 1.0, mask),
        prefix + "bp2": _rate(diff, 2.0, mask),
        prefix + "bp3": _rate(diff, 3.0, mask),
        # legacy reference names (swapped):
        prefix + "d1_error": _rate(diff, 3.0, mask),
        prefix + "d3_error": _rate(diff, 1.0, mask),
    }


def disparity_l1_loss(pred, gt, mask, max_disparity: float = 192.0, **_):
    pred = _resize_pred(pred, gt).clamp(0.0, max_disparity)
    loss = _masked_mean((pred - gt).abs(), mask)
    return loss, _error_metrics(pred, gt, mask)


def disparity_smooth_l1_loss(pred, gt, mask, beta: float = 1.0,
                             max_disparity: float = 192.0, **_):
    pred = _resize_pred(pred, gt).clamp(0.0, max_disparity)
    loss = _masked_mean(_smooth_l1(pred, gt, beta), mask)
    return loss, _error_metrics(pred, gt, mask)


def disparity_epe_loss(pred, gt, mask, max_disparity: float = 192.0, **_):
    pred = pred.clamp(0.0, max_disparity)
    loss = _masked_mean((pred - gt).abs(), mask)
    return loss, _error_metrics(pred, gt, mask)


def gradient_loss(pred, gt, mask, **_):
    """Disparity-gradient matching loss."""
    pgx = (pred[:, :, 1:] - pred[:, :, :-1]).abs()
    pgy = (pred[:, 1:, :] - pred[:, :-1, :]).abs()
    ggx = (gt[:, :, 1:] - gt[:, :, :-1]).abs()
    ggy = (gt[:, 1:, :] - gt[:, :-1, :]).abs()
    mx = mask[:, :, 1:] & mask[:, :, :-1]
    my = mask[:, 1:, :] & mask[:, :-1, :]
    lx = _masked_mean((pgx - ggx).abs(), mx)
    ly = _masked_mean((pgy - ggy).abs(), my)
    return 0.5 * (lx + ly), {"gradient_loss_x": lx, "gradient_loss_y": ly}


def multi_scale_loss(pred_pyramid, gt, mask, weights=None, loss_type: str = "smooth_l1",
                     beta: float = 1.0, max_disparity: float = 192.0, **_):
    """Per-scale loss with nearest-downsampled, scale-adjusted ground truth."""
    if weights is None:
        weights = [1.0] * len(pred_pyramid)
    total = 0.0
    epe = 0.0
    for pred, w in zip(pred_pyramid, weights):
        scale = pred.shape[-1] / gt.shape[-1]
        if scale != 1.0:
            hw = tuple(pred.shape[1:3])
            gt_s = resize2d(gt[:, None], hw, "nearest")[:, 0] * scale
            m_s = resize2d(mask[:, None].float(), hw, "nearest")[:, 0] > 0.5
        else:
            gt_s, m_s = gt, mask
        pred = pred.clamp(0.0, max_disparity * scale)
        if loss_type in ("l1", "epe"):
            per = (pred - gt_s).abs()
        elif loss_type == "smooth_l1":
            per = _smooth_l1(pred, gt_s, beta)
        else:
            raise ValueError(loss_type)
        total = total + w * _masked_mean(per, m_s)
        epe = epe + w * _masked_mean((pred - gt_s).abs(), m_s)
    return total, {"multi_scale_epe": epe / sum(weights)}


def foundation_stereo_loss(pred_initial, pred_pyramid, gt, mask, gamma: float = 0.9,
                           max_disparity: float = 192.0, **_):
    """The paper's loss: smoothL1(d0) + sum_k gamma^(K-k) L1(d_k).
    ``pred_initial`` is the initial disparity in full-resolution units (4x
    the 1/4-grid value), upsampled here."""
    init = _resize_pred(pred_initial, gt).clamp(0.0, max_disparity)
    loss = _masked_mean(_smooth_l1(init, gt, 1.0), mask)
    metrics = _error_metrics(init, gt, mask, prefix="initial_")
    K = len(pred_pyramid)
    for k, pred in enumerate(pred_pyramid):
        pred = _resize_pred(pred, gt).clamp(0.0, max_disparity)
        loss = loss + gamma ** (K - (k + 1)) * _masked_mean((pred - gt).abs(), mask)
    final = _resize_pred(pred_pyramid[-1], gt).clamp(0, max_disparity)
    metrics.update(_error_metrics(final, gt, mask, prefix="final_"))
    return loss, metrics


LOSS_REGISTRY: dict[str, Callable] = {
    "disparity_l1_loss": disparity_l1_loss,
    "disparity_smooth_l1_loss": disparity_smooth_l1_loss,
    "disparity_epe_loss": disparity_epe_loss,
    "multi_scale_loss": multi_scale_loss,
    "gradient_loss": gradient_loss,
    "foundation_stereo_loss": foundation_stereo_loss,
}


def compute_stereo_metrics(pred, gt, mask, thresholds=(1.0, 3.0, 5.0)):
    """The standalone metric pack, batched: epe, rmse and d{t}_error."""
    diff = (pred - gt).abs()
    out = {"epe": _masked_mean(diff, mask), "rmse": torch.sqrt(_masked_mean(diff * diff, mask))}
    for t in thresholds:
        out[f"d{int(t)}_error"] = _rate(diff, t, mask)
    return out
