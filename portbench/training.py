"""Cells of training: the program's ``Trainer.train_step`` on a pool of
batches cycled from the seed, each step ended by a synchronize.

Set-up builds one train state from the benchmark's weights and drives it
through its first two steps with the window's own call, on two different
batches; the window continues the same state. ``correct``: the fp32
reference follows those two steps from the same weights and batches (once
the window has closed and the program is freed), and the numbers compared
are each step's loss, the first step's gradient as the optimizer received
it (read back from AdamW's first moment after one step), and the change of
the parameters and of their EMA over the two steps, leaf by leaf. Leaves
whose reference gradient is under a thousandth of the median leaf's (a bias
before a normalisation: zero but for rounding) are left out.
"""

from __future__ import annotations

import gc

import torch

from portbench import compare, traffic
from portbench.reference import model as reference
from portbench.reference.train import Step, dropout_seed

# The steps of set-up that the reference follows: two, so that the fp32
# reference (about 20 s a step on the H100) stays shorter than the window.
FIRST_STEPS = 2


class Training:
    def __init__(self, cell: dict, seed: int, device, overrides: dict | None = None):
        body = cell["configuration"]["body"]
        self.recipe = dict(body, model=dict(body["model"], **(overrides or {}).get("model", {})))
        self.mix = dict(cell["mix"], **(overrides or {}).get("mix", {}))
        self.details, self.seed, self.device = cell["details"], seed, torch.device(device)
        self.weights_seed = traffic.substream(seed, "weights")
        self.trainer = self.state = None
        self.first: dict = {"loss": []}

    def setup(self, parts) -> None:
        from foundationstereo_torch.train.trainer import Trainer

        with parts("weights"):
            ref = reference.build(self.recipe["model"], self.device, self.weights_seed)
            self.trainer = Trainer(self.recipe, seed=0, device=self.device)
            self.state = self.trainer.init_state()
            self.state.model.load_state_dict(ref.state_dict())
            del ref
            with torch.no_grad():
                for n, p in self.state.model.named_parameters():
                    self.state.ema[n].copy_(p)
            self._free()
        with parts("traffic"):
            self.pool = traffic.train_batches(self.mix, self.seed, self.device,
                                              list(self.recipe["loss"]))
        opt = self.state.optimizer.optimizer
        beta1 = opt.param_groups[0]["betas"][0]
        trained = {n: p for n, p in self.state.model.named_parameters() if p.requires_grad}
        for k in range(FIRST_STEPS):
            with parts(f"warm-up step {k + 1}"):
                self.call(k - FIRST_STEPS)
                self.first["loss"].append(float(self.metrics["loss"]))
                if k == 0:      # AdamW's first moment after one step is (1 - beta1) g
                    self.first["grad"] = {
                        n: (opt.state[p]["exp_avg"] / (1.0 - beta1) if "exp_avg" in opt.state.get(p, {})
                            else torch.zeros_like(p)).to("cpu", copy=True)
                        for n, p in trained.items()}
        self.first["params"] = {n: p.detach().to("cpu", copy=True) for n, p in trained.items()}
        self.first["ema"] = {n: self.state.ema[n].to("cpu", copy=True) for n in trained}

    def _free(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def call(self, i: int) -> int:
        """Step on batch ``i + 2`` of the pool (the warm-up's two steps take
        batches 0 and 1); returns the samples stepped."""
        batch = self.pool[(i + FIRST_STEPS) % len(self.pool)]
        self.state, self.metrics = self.trainer.train_step(self.state, batch)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return self.mix["batch"]

    def hooked_module(self):
        return self.state.model

    def items_per_call(self) -> int:
        return self.mix["batch"]

    def shape(self) -> dict:
        w, h = self.mix["crop_wh"]
        return {"batch": self.mix["batch"], "height": h, "width": w,
                "iters": self.recipe["model"]["train_iters"]}

    def flops_per_item(self) -> float:
        from portbench.counting import train_step_flops

        s = self.shape()
        return train_step_flops(self.recipe, s["height"], s["width"], s["batch"]) / s["batch"]

    def release(self) -> None:
        self.trainer = self.state = self.metrics = None
        self._free()

    def check(self, log) -> tuple[dict, dict]:
        ref = reference_steps(self.recipe, self.pool, self.device, self.weights_seed)
        p0 = ref.pop("p0")
        prog = {"loss": self.first["loss"], "grad": self.first["grad"],
                "change": {n: self.first["params"][n] - p0[n] for n in ref["grad"]},
                "ema": {n: self.first["ema"][n] - p0[n] for n in ref["grad"]}}
        return step_numbers(prog, ref, log), {"leaves": len(ref["grad"])}


def reference_steps(recipe: dict, pool: list[dict], device, weights_seed: int,
                    cdt: torch.dtype = torch.float32, half_batch: bool = False) -> dict:
    """The reference's first ``FIRST_STEPS`` steps on the pool's first
    batches: their losses, the first step's clipped gradient, and the
    change of the parameters and of the EMA from the start (``p0``)."""
    model = reference.build(recipe["model"], device, weights_seed, cdt=cdt)
    p0 = {n: p.detach().to("cpu", copy=True) for n, p in model.named_parameters()}
    step = Step(model, recipe)
    losses, grad = [], None
    for k in range(FIRST_STEPS):
        batch = pool[k]
        if half_batch:
            n = batch["left"].shape[0] // 2
            batch = {key: (v if key == "rng" else v[:n]) for key, v in batch.items()}
        out = step(batch, recipe["model"]["train_iters"], dropout_seed(batch["rng"]))
        losses.append(out["loss"])
        if k == 0:
            grad = {n: g.to("cpu", copy=True) for n, g in out["grads"].items()}
    change = {n: p.detach().to("cpu", copy=True) - p0[n] for n, p in model.named_parameters()
              if n in grad}
    ema = {n: step.ema[n].to("cpu", copy=True) - p0[n] for n in grad}
    del model, step
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return {"loss": losses, "grad": grad, "change": change, "ema": ema, "p0": p0}


def step_numbers(prog: dict, ref: dict, log) -> dict:
    """The numbers: the first step's relative loss gap and the largest over
    the steps, and for the first gradient, the change and the EMA's change
    the worst leaf's gap (``compare.worst_leaf_gap``), the median leaf's and
    the whole vector's, over the leaves whose reference gradient is at least
    a thousandth of the median leaf's. The cell's details say which are held."""
    gnorm = {n: float(torch.linalg.vector_norm(g.double())) for n, g in ref["grad"].items()}
    med = sorted(gnorm.values())[len(gnorm) // 2]
    moving = {n for n, v in gnorm.items() if v >= 1e-3 * med}
    rel = [abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])]
    numbers = {"loss1_rel": rel[0], "loss_rel": max(rel)}
    for key in ("grad", "change", "ema"):
        worst, leaf = compare.worst_leaf_gap(prog[key], ref[key], moving)
        numbers[f"{key}_gap"] = worst
        numbers[f"{key}_median_gap"] = compare.median_leaf_gap(prog[key], ref[key], moving)
        numbers[f"{key}_total_rel"] = compare.total_gap(prog[key], ref[key], moving)
        diffs = sorted(compare.leaf_diffs(prog[key], ref[key], moving).values())
        numbers[f"{key}_diff_median"] = diffs[len(diffs) // 2]
        numbers[f"{key}_diff_worst"] = diffs[-1]
        log(f"{key}: worst leaf {leaf}")
    log(f"losses: program {prog['loss']} reference {ref['loss']}; {len(gnorm) - len(moving)} "
        f"of {len(gnorm)} leaves left out (reference gradient under 1e-3 of the median leaf's)")
    return numbers
