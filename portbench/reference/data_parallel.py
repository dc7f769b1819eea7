"""The reference training step over the ranks of a process group, as data
parallelism defines it: each rank holds its rows of the global batch (the
ranks' rows in rank order), and the step is the one-process step on the
global batch.

- Batch norm in training takes the global batch's statistics: the
  per-channel sums of x and x^2 and the element count, summed over the
  ranks in fp32 by an all-reduce whose backward sums their gradient the same
  way (each rank's rows feed every rank's statistics); the mean and the
  biased variance follow from them, as flax's batch norm has it.
- Dropout draws the global batch's mask from the step's generator, which
  holds the same key on every rank, and keeps the rank's rows (axis 0 is the
  batch's, outermost).
- The gradients, and the loss, are averaged over the ranks before clipping,
  AdamW and the EMA, so every rank applies the same update.

``convert(model)`` turns a reference model's batch norms and transformer
layers into these; ``Step`` is the reference step that averages. Nothing
of the program is imported.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from portbench.reference import train
from portbench.reference.nn import BatchNorm, Dropout, TransformerEncoderLayer


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


class GlobalBatchNorm(BatchNorm):
    def forward(self, x):
        if not self.training:
            return super().forward(x)
        x = x.float()
        axes = [0] + list(range(2, x.ndim))
        c = x.shape[1]
        count = x.new_full((1,), x.numel() // c)
        sums = _SumOverRanks.apply(torch.cat([x.sum(axes), (x * x).sum(axes), count]))
        mean = sums[:c] / sums[2 * c]
        var = (sums[c:2 * c] / sums[2 * c] - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1 - self.momentum).add_(self.momentum * var)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)


def global_dropout(x: torch.Tensor, rate: float, training: bool) -> torch.Tensor:
    """The global batch's mask, drawn whole; the rank's rows kept."""
    if not training or rate == 0.0:
        return x
    if Dropout.gen is None:
        raise RuntimeError("train-mode dropout needs a generator")
    n, r, rows = dist.get_world_size(), dist.get_rank(), x.shape[0]
    keep = 1.0 - rate
    mask = torch.rand((n * rows,) + x.shape[1:], generator=Dropout.gen,
                      device=x.device)[r * rows:(r + 1) * rows] < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class GlobalDropoutLayer(TransformerEncoderLayer):
    def forward(self, x):
        def drop(t):
            return global_dropout(t, self.rate, self.training)

        x = self.norm1(x + drop(self.self_attn(x)))
        return self.norm2(x + drop(self.linear2(drop(F.gelu(self.linear1(x))))))


def convert(model: torch.nn.Module) -> torch.nn.Module:
    """The model's batch norms and transformer layers made global, in place."""
    for m in model.modules():
        if type(m) is BatchNorm:
            m.__class__ = GlobalBatchNorm
        elif type(m) is TransformerEncoderLayer:
            m.__class__ = GlobalDropoutLayer
    return model


class Step(train.Step):
    """The reference step with the gradients and the loss averaged over the
    ranks (one all-reduce of a flat fp32 buffer each); with
    ``average=False`` each rank keeps its own (a fault: the replicas part)."""

    def __init__(self, model, recipe: dict, average: bool = True):
        super().__init__(model, recipe)
        self.average = average

    def over_ranks(self, loss, grads):
        parts = [loss.reshape(1)] + ([g.reshape(-1) for g in grads] if self.average else [])
        flat = torch.cat([p.float() for p in parts])
        dist.all_reduce(flat)
        flat /= dist.get_world_size()
        if not self.average:        # the loss is still the global batch's
            return flat[0], grads
        split = torch.split(flat[1:], [g.numel() for g in grads])
        return flat[0], tuple(p.view_as(g).to(g.dtype) for p, g in zip(split, grads))
