"""Train state, train step, the per-label composite loss and the eval step.

The port of the JAX package's ``train/trainer.py``. One step is: the
train-mode forward (batch statistics, dropout from a generator seeded by the
batch's ``rng``) and the composite per-label loss, the backward, the global
gradient norm (before clipping), and -- only where the loss and that norm
are finite -- optax's clipping and the optimizer update. A non-finite step
leaves the parameters and the optimizer state (its count too) as they were;
``step`` advances either way, the EMA moves toward the (possibly unchanged)
parameters, and batch norm's running stats keep the batch's update, as in
the JAX step.

Deciding the skip reads the two norms on the host: one synchronisation per
step.

Data-parallel (a process group of N ranks, ``parallel/distributed.py``):
the JAX package's sharded step, which equals the one-device step on the
global batch (``foundationstereo_tpu/train/trainer.py:6-9``). Each rank
builds the same seeded model and takes rank 0's (``replicate``), runs its
slice's forward and backward inside ``layers.global_batch`` (the global
batch's batch-norm statistics and dropout masks), and before the update the
gradients are averaged over the ranks in one all-reduce of a flat fp32
buffer (once per optimizer step, after any accumulation), as are the loss
and the metrics. So the norm, the skip, clipping, AdamW and the EMA see the
global gradient and decide alike on every rank, and the ranks' parameters
stay equal bit for bit.

Under a ``RankMesh`` (``parallel.mesh_context``; without one, the ranks are
all on ``data``) the batch is split over ``data`` only: the ranks that share
a data index hold the same samples, and where ``spatial`` > 1 each computes
its columns of the image from the cost volume on (``parallel/spatial.py``).
The forward gathers its outputs along W, so the loss is computed whole on
every rank, and the gather's backward hands each rank its columns'
gradient. Batch norm outside the partition reduces over ``data`` (every
spatial rank sees the whole tensor), inside it over all the ranks; the
gradients are summed over ``spatial`` and averaged over ``data`` (one
all-reduce over all the ranks, divided by the data axis's size).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
from torch.func import functional_call

from foundationstereo_torch.config import ModelConfig
from foundationstereo_torch.models.foundation_stereo import FoundationStereo, resolve_device
from foundationstereo_torch.models.layers import dropout_generator, global_batch
from foundationstereo_torch.parallel import distributed
from foundationstereo_torch.parallel.mesh import RankMesh, current_mesh
from foundationstereo_torch.parallel.sharding import replicate
from foundationstereo_torch.train import losses as L
from foundationstereo_torch.train.optim import (
    ScheduledOptimizer,
    build_optimizer,
    clip_by_global_norm,
    ema_init,
    ema_update,
    global_norm,
)

DEFAULT_LOSS = {"stereo": {"main": {"function": "foundation_stereo_loss", "weight": 1.0,
                                    "params": {"gamma": 0.9, "max_disparity": 192.0}}}}
DEFAULT_OPTIMIZER = {"type": "AdamW", "params": [
    {"params": {"include": ["*"], "exclude": []}, "lr": 1e-4, "weight_decay": 1e-4}]}


@dataclasses.dataclass
class TrainState:
    """The model (parameters and batch stats), the optimizer (its state and
    update count), the EMA copies of the parameters (or None) and the step."""

    step: int
    model: FoundationStereo
    optimizer: ScheduledOptimizer
    ema: dict | None


def make_label_index(label_types: list[str], loss_cfg: dict) -> np.ndarray:
    """Map per-sample label_type strings to indices into sorted(loss_cfg)."""
    keys = sorted(loss_cfg.keys())
    return np.array([keys.index(lt) for lt in label_types], np.int64)


def dropout_seed(rng) -> int:
    """A generator seed from a batch's two-word ``rng``."""
    a, b = (int(x) for x in np.asarray(rng, np.uint32).reshape(-1)[:2])
    return (a << 32) | b


class Trainer:
    """Owns the model config, the loss dispatch and the steps."""

    def __init__(self, config: dict, seed: int = 0, enable_ema: bool = True, device="cuda"):
        self.config = config
        self.model_cfg = ModelConfig.from_dict(config["model"])
        self.loss_cfg = config.get("loss", DEFAULT_LOSS)
        self.label_keys = sorted(self.loss_cfg.keys())
        self.seed = seed
        self.enable_ema = enable_ema
        self.device = resolve_device(device)
        self.iters = self.model_cfg.train_iters
        # With False the forward under grad runs as train=False (running
        # stats, no dropout), as the JAX trainer's knob: for parity checks,
        # not a training mode.
        self.train_flag = True

    def init_state(self) -> TrainState:
        """A model with seeded weights (rank 0's on every rank), its optimizer
        and the EMA."""
        model = FoundationStereo(self.model_cfg, device=self.device, seed=self.seed)
        replicate(model)
        opt, _ = build_optimizer(model, self.config.get("optimizer", DEFAULT_OPTIMIZER),
                                 self.config.get("lr_scheduler"))
        return TrainState(step=0, model=model, optimizer=opt,
                          ema=ema_init(model) if self.enable_ema else None)

    @staticmethod
    def rank_mesh() -> RankMesh | None:
        """The ranks' mesh of a step: the current ``RankMesh``, else all the
        ranks on ``data`` (None without a process group)."""
        mesh = current_mesh()
        if isinstance(mesh, RankMesh):
            return mesh
        return RankMesh((distributed.world_size(), 1)) if distributed.world_size() > 1 else None

    # -- loss ---------------------------------------------------------------

    def composite_loss(self, init_disp, preds, gt, mask, label_idx):
        """Per-sample weighted loss over the label-type registry: each
        sample takes the loss of its label type."""
        init_full = init_disp * 4.0      # full-resolution units; upsampled in the loss
        per_label, metrics = [], {}
        for lt in self.label_keys:
            total = torch.zeros(gt.shape[0], device=gt.device)
            for name, spec in self.loss_cfg[lt].items():
                fn = L.LOSS_REGISTRY[spec["function"]]
                kwargs = dict(spec.get("params", {}))
                if spec["function"] == "foundation_stereo_loss":
                    loss, m = fn(init_full, preds, gt, mask, **kwargs)
                elif spec["function"] == "multi_scale_loss":
                    loss, m = fn(preds, gt, mask, **kwargs)
                else:
                    loss, m = fn(preds[-1], gt, mask, **kwargs)
                total = total + spec.get("weight", 1.0) * loss
                if lt != "invalid":
                    for k, v in m.items():
                        metrics[f"{lt}.{name}.{k}"] = v
            per_label.append(total)
        onehot = torch.nn.functional.one_hot(label_idx.long(), len(self.label_keys)).T
        return (torch.stack(per_label) * onehot).sum(dim=0), metrics

    def loss_and_grads(self, state: TrainState, batch: dict):
        """Forward and backward of one (micro-)batch; gradients accumulate
        into ``.grad``. Returns (loss, metrics), both on the device."""
        model = state.model
        model.train(self.train_flag)
        gen = None
        if "rng" in batch:
            gen = torch.Generator(device=self.device).manual_seed(dropout_seed(batch["rng"]))
        mesh = self.rank_mesh()
        over_data = (global_batch(mesh.data_group) if mesh is not None and mesh.shape["data"] > 1
                     else contextlib.nullcontext())
        with dropout_generator(gen), over_data:
            init_disp, preds = model(batch["left"], batch["right"], iters=self.iters,
                                     test_mode=False, train=self.train_flag)
            per_sample, metrics = self.composite_loss(init_disp, preds, batch["disparity"],
                                                      batch["mask"], batch["label_idx"])
            loss = per_sample.mean()
            loss.backward()
        return loss.detach(), {k: v.detach().mean() for k, v in metrics.items()}

    # -- steps --------------------------------------------------------------

    def _average_over_ranks(self, state: TrainState, loss, metrics) -> tuple:
        """The gradients (in place) summed over ``spatial`` and averaged over
        ``data``, the loss and the metrics averaged over the ranks: two
        all-reduces (nothing without a process group)."""
        mesh = self.rank_mesh()
        if mesh is None:
            return loss, metrics
        distributed.all_reduce_mean([p.grad for p in state.model.parameters()
                                     if p.grad is not None], divisor=mesh.shape["data"])
        keys = list(metrics)
        values = torch.stack([loss] + [metrics[k] for k in keys])
        distributed.all_reduce_mean([values])
        return values[0], dict(zip(keys, values[1:]))

    def _apply_grads(self, state: TrainState, loss, metrics) -> tuple[TrainState, dict]:
        model, opt = state.model, state.optimizer
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        gnorm = global_norm(grads) if grads else torch.zeros((), device=loss.device)
        ok = torch.isfinite(gnorm) & torch.isfinite(loss)
        if bool(ok):
            clip_by_global_norm(grads, gnorm)
            opt.step()
        for p in model.parameters():        # pattern-frozen parameters hold grads too
            p.grad = None
        if state.ema is not None:
            ema_update(state.ema, model, 0.999)
        state.step += 1
        metrics = dict(metrics, loss=loss, grad_norm=gnorm, skipped_nonfinite=1.0 - ok.float())
        return state, metrics

    def train_step(self, state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        """One optimisation step on batch: left/right (B, H, W, 3) float
        0-255, disparity (B, H, W), mask (B, H, W) bool, label_idx (B,),
        rng (2,) uint32 (the same on every rank: it keys the global batch's
        dropout masks). Updates the state in place and returns it with the
        step's metrics (0-d tensors on the device; over the ranks, their
        means)."""
        loss, metrics = self.loss_and_grads(state, batch)
        return self._apply_grads(state, *self._average_over_ranks(state, loss, metrics))

    def train_step_accum(self, state: TrainState, batches: list[dict]) -> tuple[TrainState, dict]:
        """One optimisation step over K micro-batches: the mean of their
        gradients and losses, the batch stats carried from one to the next."""
        k = len(batches)
        losses, stacked = [], {}
        for micro in batches:
            loss, metrics = self.loss_and_grads(state, micro)
            losses.append(loss)
            for key, v in metrics.items():
                stacked.setdefault(key, []).append(v)
        with torch.no_grad():
            for p in state.model.parameters():
                if p.grad is not None:
                    p.grad.div_(k)
        metrics = {key: torch.stack(v).mean() for key, v in stacked.items()}
        loss, metrics = self._average_over_ranks(state, torch.stack(losses).sum() / k, metrics)
        return self._apply_grads(state, loss, metrics)

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: dict, use_ema: bool = False):
        """Test-mode forward (``valid_iters``) and its metrics; ``use_ema``
        serves the EMA weights."""
        model = state.model
        was_training = model.training
        model.eval()
        params = state.ema if use_ema and state.ema is not None else {}
        try:
            disp = functional_call(model, params, (batch["left"], batch["right"]),
                                   {"iters": self.model_cfg.valid_iters, "test_mode": True})
        finally:
            model.train(was_training)
        return disp, L.compute_stereo_metrics(disp, batch["disparity"], batch["mask"])
