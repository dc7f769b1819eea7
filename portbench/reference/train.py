"""The reference training step: the train-mode forward, the published
composite loss, the backward, clipping by the global gradient norm, AdamW
with the configured learning-rate schedule, and the EMA of the parameters.

Plain PyTorch, written from the recipe (``configs/train/stereo_v1.json``
as shipped) and not from the program's code.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.nn import Dropout
from portbench.reference.ops import resize


def _masked_mean(x, mask):
    m = mask.to(x.dtype)
    count = m.sum(dim=(1, 2))
    return torch.where(count > 0, (x * m).sum(dim=(1, 2)) / count.clamp_min(1.0),
                       torch.zeros_like(count))


def _full(pred, gt):
    if pred.shape[1:] != gt.shape[1:]:
        pred = resize(pred[:, None], tuple(gt.shape[1:3]), "bilinear")[:, 0]
    return pred


def foundation_stereo_loss(init_full, preds, gt, mask, gamma=0.9, max_disparity=192.0):
    """smooth-L1 of the upsampled initial disparity plus the gamma-weighted
    L1 of every refinement step, per sample."""
    d = (_full(init_full, gt).clamp(0.0, max_disparity) - gt).abs()
    loss = _masked_mean(torch.where(d < 1.0, 0.5 * d * d, d - 0.5), mask)
    K = len(preds)
    for k, pred in enumerate(preds):
        err = (_full(pred, gt).clamp(0.0, max_disparity) - gt).abs()
        loss = loss + gamma ** (K - k - 1) * _masked_mean(err, mask)
    return loss


def disparity_l1_loss(init_full, preds, gt, mask, max_disparity=192.0):
    return _masked_mean((_full(preds[-1], gt).clamp(0.0, max_disparity) - gt).abs(), mask)


LOSSES = {"foundation_stereo_loss": foundation_stereo_loss, "disparity_l1_loss": disparity_l1_loss}


def composite_loss(loss_cfg: dict, init_disp, preds, gt, mask, label_idx) -> torch.Tensor:
    """Per sample, the weighted losses of its label type (label types sorted
    by name); the batch's mean."""
    per_label = []
    for lt in sorted(loss_cfg):
        total = torch.zeros(gt.shape[0], device=gt.device)
        for spec in loss_cfg[lt].values():
            fn = LOSSES[spec["function"]]
            total = total + spec.get("weight", 1.0) * fn(4.0 * init_disp, preds, gt, mask,
                                                         **spec.get("params", {}))
        per_label.append(total)
    onehot = F.one_hot(label_idx.long(), len(per_label)).T
    return (torch.stack(per_label) * onehot).sum(dim=0).mean()


def lr_schedule(recipe: dict, base_lr: float):
    """step -> learning rate of the recipe's ``lr_scheduler`` (a sympy
    expression in ``epoch`` for LambdaLR; constant without one)."""
    sched = recipe.get("lr_scheduler")
    if not sched:
        return lambda step: base_lr
    if sched.get("type") != "LambdaLR":
        raise ValueError(f"the reference has no {sched.get('type')} schedule")
    import sympy

    fn = sympy.lambdify(sympy.Symbol("epoch"), sympy.sympify(sched["params"]["lr_lambda"]))
    return lambda step: base_lr * float(fn(step))


class Step:
    """AdamW over the parameters that require grad, with clipping at global
    norm 1 (g / |g| where |g| >= 1) and an EMA (decay 0.999) of every
    parameter. A step whose loss or gradient norm is not finite applies no
    update."""

    def __init__(self, model, recipe: dict, ema_decay: float = 0.999):
        group = recipe["optimizer"]["params"][0]
        if recipe["optimizer"]["type"] != "AdamW" or len(recipe["optimizer"]["params"]) != 1:
            raise ValueError("the reference has one AdamW group")
        self.model, self.loss_cfg = model, recipe["loss"]
        self.lr = lr_schedule(recipe, group.get("lr", 1e-4))
        self.b1, self.b2 = group.get("betas", (0.9, 0.999))
        self.eps, self.wd = group.get("eps", 1e-8), group.get("weight_decay", 0.0)
        self.params = {n: p for n, p in model.named_parameters() if p.requires_grad}
        self.m = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.ema = {n: p.detach().clone() for n, p in model.named_parameters()}
        self.decay, self.count = ema_decay, 0

    def over_ranks(self, loss, grads):
        """The loss and gradients the update uses: this process's own
        (``data_parallel.Step`` averages them over the ranks)."""
        return loss, grads

    def __call__(self, batch: dict, iters: int, seed: int) -> dict:
        """One step on ``batch``; ``seed`` seeds the dropout generator.
        Returns the loss, the clipped gradients as the update used them, and
        the train-mode forward's outputs (``outputs``, detached: the filter
        stack's input volume and the context network's outputs)."""
        model = self.model.train()
        gen = torch.Generator(device=batch["left"].device).manual_seed(seed)
        taps = {}
        with Dropout.drawing(gen):
            init_disp, preds = model(batch["left"], batch["right"], iters, test_mode=False,
                                     taps=taps)
            loss = composite_loss(self.loss_cfg, init_disp, preds, batch["disparity"],
                                  batch["mask"], batch["label_idx"])
        grads = torch.autograd.grad(loss, list(self.params.values()))
        loss, grads = self.over_ranks(loss.detach(), grads)
        gnorm = torch.sqrt(sum((g * g).sum() for g in grads))
        clipped = {}
        with torch.no_grad():
            if torch.isfinite(loss) and torch.isfinite(gnorm):
                scale = 1.0 / gnorm if gnorm >= 1.0 else torch.ones_like(gnorm)
                self.count += 1
                lr = self.lr(self.count - 1)
                c1, c2 = 1.0 - self.b1 ** self.count, 1.0 - self.b2 ** self.count
                for (n, p), g in zip(self.params.items(), grads):
                    g = g * scale
                    clipped[n] = g
                    self.m[n].mul_(self.b1).add_((1.0 - self.b1) * g)
                    self.v[n].mul_(self.b2).add_((1.0 - self.b2) * g * g)
                    p.mul_(1.0 - lr * self.wd)
                    p.sub_(lr * (self.m[n] / c1) / ((self.v[n] / c2).sqrt() + self.eps))
            for n, p in self.model.named_parameters():
                self.ema[n].mul_(self.decay).add_((1.0 - self.decay) * p)
        outputs = {"volume": taps["volume"].detach(),
                   "context": [t.detach() for t in taps["context"]]}
        return {"loss": float(loss.detach()), "grads": clipped, "grad_norm": float(gnorm),
                "outputs": outputs}


def dropout_seed(rng) -> int:
    """The dropout generator's seed from a batch's two-word key."""
    a, b = (int(x) for x in np.asarray(rng, np.uint32).reshape(-1)[:2])
    return (a << 32) | b
