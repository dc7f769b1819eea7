"""The kind ``train_batches``: the program's ``Trainer.train_step`` on a
pool of batches cycled from the seed, each step ended by a synchronize.

On N > 1 ranks (a cell of N chips) the mix's batch is the global batch:
each rank steps on its rows of it, as ``distributed.local_slice`` of the
program cuts them (rank r: rows [r b, (r + 1) b), b = batch / N), under the
trainer's data-parallel step (no mesh set: every rank on ``data``), with
the same dropout key on every rank. A call counts the global batch's
samples.

Set-up builds one train state from the benchmark's weights and drives it
through its first two steps with the window's own call, on two different
batches; the window continues the same state. During the first step only,
forward hooks copy to the host what the train-mode forward's stages put
out, each from its first call (the backward's recompute calls them again):
the filter stack's input volume (the output of ``corr_stem``), the context
network's outputs, and the input and output of each judged block
(``judged``: the filter stack's conv-norm blocks, the classifier, the
refinement's first update). ``correct``: the fp32 reference follows those
two steps from the same weights and batches (once the window has closed and
the program is freed), and the numbers compared are the volume and the
context sample by sample (``forward_numbers``), each judged block against
the reference's block on the program's own input (``block_numbers``, so
that rounding does not compound from block to block), each step's loss, the
first step's gradient as the optimizer received it (read back from AdamW's
first moment after one step), and the change of the parameters and of
their EMA over the two steps, leaf by leaf. Leaves whose reference gradient
is under a thousandth of the median leaf's (a bias before a normalisation:
zero but for rounding) are left out. On N ranks each rank's numbers are
its own rows' against the data-parallel reference's
(``reference/data_parallel.py``), with ``replica_gap`` besides: the largest
relative gap of a rank's parameters, EMA and running statistics from rank
0's after the two steps. The cell's details say which numbers are held.
"""

from __future__ import annotations

import contextlib
import gc

import torch

from portbench import compare, ranks, traffic
from portbench.reference import data_parallel
from portbench.reference import model as reference
from portbench.reference.ops import CONTROL_DTYPE
from portbench.reference.train import Step, dropout_seed

# The steps of set-up that the reference follows: two, so that the fp32
# reference (about 20 s a step on the H100) stays shorter than the window.
FIRST_STEPS = 2
# The calls ``--trace 1`` profiles.
traced_calls = 2
# The faults ``control`` knows, each in the program's place.
FAULTS = ("fp8", "half_batch", "own_gradient")


class Training:
    def __init__(self, cell: dict, seed: int, device, overrides: dict | None = None):
        body = cell["configuration"]["body"]
        self.recipe = dict(body, model=dict(body["model"], **(overrides or {}).get("model", {})))
        self.mix = dict(cell["mix"], **(overrides or {}).get("mix", {}))
        self.details, self.seed, self.device = cell["details"], seed, torch.device(device)
        self.weights_seed = traffic.substream(seed, "weights")
        self.world = ranks.world()
        if self.mix["batch"] % self.world:
            raise ValueError(f"a global batch of {self.mix['batch']} does not split over "
                             f"{self.world} ranks")
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
            self.pool = self._global_pool()
            if self.world > 1:      # this rank's rows, as the program cuts them
                from foundationstereo_torch.parallel import distributed

                self.pool = [{k: v if k == "rng" else v.clone() for k, v in
                              distributed.local_slice(batch).items()} for batch in self.pool]
                self._free()
        opt = self.state.optimizer.optimizer
        beta1 = opt.param_groups[0]["betas"][0]
        trained = {n: p for n, p in self.state.model.named_parameters() if p.requires_grad}
        for k in range(FIRST_STEPS):
            with parts(f"warm-up step {k + 1}"), (catching(self.state.model) if k == 0
                                                   else contextlib.nullcontext()) as caught:
                self.call(k - FIRST_STEPS)
                self.first["loss"].append(float(self.metrics["loss"]))
                if k == 0:      # AdamW's first moment after one step is (1 - beta1) g
                    self.first["outputs"] = caught
                    self.first["grad"] = {
                        n: (opt.state[p]["exp_avg"] / (1.0 - beta1) if "exp_avg" in opt.state.get(p, {})
                            else torch.zeros_like(p)).to("cpu", copy=True)
                        for n, p in trained.items()}
        self.first["params"] = {n: p.detach().to("cpu", copy=True) for n, p in trained.items()}
        self.first["ema"] = {n: self.state.ema[n].to("cpu", copy=True) for n in trained}
        if self.world > 1:
            self.first["replica_gap"] = ranks.replica_gap(
                replicated(self.state.model, self.state.ema, trained), self.device)

    def _global_pool(self) -> list[dict]:
        return traffic.train_batches(self.mix, self.seed, self.device, list(self.recipe["loss"]))

    def _free(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def call(self, i: int) -> int:
        """Step on batch ``i + 2`` of the pool (the warm-up's two steps take
        batches 0 and 1); returns the samples stepped (the global batch's)."""
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
        """A rank's step: its batch, the crop and the refinement steps."""
        w, h = self.mix["crop_wh"]
        return {"batch": self.mix["batch"] // self.world, "height": h, "width": w,
                "iters": self.recipe["model"]["train_iters"]}

    def flops_per_item(self) -> float:
        from portbench.counting import train_step_flops

        s = self.shape()
        return train_step_flops(self.recipe, s["height"], s["width"], s["batch"]) / s["batch"]

    def release(self) -> None:
        self.trainer = self.state = self.metrics = None
        self._free()

    def check(self, log) -> tuple[dict, dict]:
        pool = self._global_pool() if self.world > 1 else self.pool
        ref = reference_steps(self.recipe, pool, self.device, self.weights_seed,
                              judge=(self.first["outputs"],), log=log)
        p0 = ref.pop("p0")
        prog = {"loss": self.first["loss"], "grad": self.first["grad"],
                "change": {n: self.first["params"][n] - p0[n] for n in ref["grad"]},
                "ema": {n: self.first["ema"][n] - p0[n] for n in ref["grad"]}}
        numbers = dict(forward_numbers(self.first["outputs"], ref["outputs"], log),
                       **ref["blocks"][0], **step_numbers(prog, ref, log))
        if self.world > 1:
            numbers["replica_gap"] = self.first["replica_gap"]
        return numbers, {"leaves": len(ref["grad"])}


Kind = Training


def replicated(model, ema: dict, trained) -> dict[str, torch.Tensor]:
    """What every rank holds alike after a data-parallel step: the trained
    parameters, their EMA and the batch norms' running statistics."""
    out = {n: p for n, p in model.named_parameters() if n in trained}
    out.update({f"ema.{n}": ema[n] for n in trained})
    out.update({n: b for n, b in model.named_buffers()
                if n.endswith(("running_mean", "running_var"))})
    return out


def judged(model) -> dict[str, str]:
    """The blocks judged one by one, by module name (the program and the
    reference name their modules alike), each with the number it goes
    into: each conv-norm block of the filter stack (``cost_agg``'s
    ``BasicConv``s and the conv-batch-norm ``Sequential``s of its
    axial-planar convs and patch conv; ``filter_block_rel``), the classifier
    (``classifier_rel``) and the refinement's update block (``update_rel``)."""
    stack = [f"cost_agg.{n}" for n, m in model.cost_agg.named_modules()
             if type(m).__name__ == "BasicConv"
             or (isinstance(m, torch.nn.Sequential)
                 and any(type(c).__name__.endswith("BatchNorm") for c in m.children()))]
    return dict({n: "filter_block_rel" for n in stack},
                classifier="classifier_rel", update_block="update_rel")


@contextlib.contextmanager
def catching(model):
    """Forward hooks on ``model`` while open; the dict it yields receives,
    each from the module's first call and copied to the host, ``volume``
    (``corr_stem``'s output), ``context`` (``cnet``'s outputs, flat) and,
    under ``blocks``, each judged block's (inputs, output)."""
    out: dict = {"blocks": {}}

    def first(key):
        def hook(_m, _args, o):
            if key not in out:          # not the backward's recompute
                out[key] = host([t for pair in o for t in pair] if key == "context" else o)
        return hook

    def block(name):
        def hook(_m, args, o):
            if name not in out["blocks"]:
                out["blocks"][name] = (host(args), host(o))
        return hook

    hooks = [model.get_submodule(name).register_forward_hook(first(key))
             for name, key in (("corr_stem", "volume"), ("cnet", "context"))]
    hooks += [model.get_submodule(name).register_forward_hook(block(name))
              for name in judged(model)]
    try:
        yield out
    finally:
        for h in hooks:
            h.remove()


def reference_steps(recipe: dict, pool: list[dict], device, weights_seed: int,
                    cdt: torch.dtype = torch.float32, half_batch: bool = False,
                    average: bool = True, judge: tuple[dict, ...] = (), catch: bool = False,
                    log=lambda msg: None) -> dict:
    """The reference's first ``FIRST_STEPS`` steps on the pool's first
    batches: their losses, the first step's clipped gradient and forward
    outputs (``outputs``, on the host; with ``catch`` also its judged
    blocks, as ``catching`` gives them), and the change of the parameters
    and of the EMA from the start (``p0``). Before the first step, each set
    of caught blocks in ``judge`` is judged on the reference's weights
    (``blocks``, one dict of numbers each). Each refinement step is
    recomputed in the backward, which changes no number and keeps the fp32
    steps within the card's memory. On N > 1 ranks it is the data-parallel
    reference on this rank's rows of the pool's global batches (with
    ``average`` False, the gradients are not averaged: a fault), and
    ``replica_gap`` its states' gap from rank 0's after the steps."""
    world, rank = ranks.world(), ranks.rank()
    model = reference.build(recipe["model"], device, weights_seed, cdt=cdt)
    model.remat = True
    if world > 1:
        data_parallel.convert(model)
    p0 = {n: p.detach().to("cpu", copy=True) for n, p in model.named_parameters()}
    blocks = [block_numbers(model, caught["blocks"], device, log) for caught in judge]
    step = data_parallel.Step(model, recipe, average) if world > 1 else Step(model, recipe)
    losses, grad, outputs = [], None, None
    for k in range(FIRST_STEPS):
        batch = pool[k]
        if world > 1:
            b = batch["left"].shape[0] // world
            batch = {key: (v if key == "rng" else v[rank * b:(rank + 1) * b])
                     for key, v in batch.items()}
        if half_batch:
            n = batch["left"].shape[0] // 2
            batch = {key: (v if key == "rng" else v[:n]) for key, v in batch.items()}
        with (catching(model) if catch and k == 0 else contextlib.nullcontext()) as caught:
            out = step(batch, recipe["model"]["train_iters"], dropout_seed(batch["rng"]))
        losses.append(out["loss"])
        if k == 0:
            grad = {n: g.to("cpu", copy=True) for n, g in out["grads"].items()}
            outputs = caught if catch else {n: host(t) for n, t in out["outputs"].items()}
    change = {n: p.detach().to("cpu", copy=True) - p0[n] for n, p in model.named_parameters()
              if n in grad}
    ema = {n: step.ema[n].to("cpu", copy=True) - p0[n] for n in grad}
    out = {"loss": losses, "grad": grad, "change": change, "ema": ema, "p0": p0,
           "outputs": outputs, "blocks": blocks}
    if world > 1:
        out["replica_gap"] = ranks.replica_gap(replicated(model, step.ema, grad), device)
    del model, step
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def host(x):
    """A tensor, or a (nested) list of them, detached and copied to the host
    in its own dtype."""
    if isinstance(x, (list, tuple)):
        return [host(t) for t in x]
    return x.detach().to("cpu", copy=True)


def _flat(x) -> list[torch.Tensor]:
    return [t for y in x for t in _flat(y)] if isinstance(x, (list, tuple)) else [x]


@torch.no_grad()
def block_numbers(model, caught: dict, device, log=lambda msg: None) -> dict:
    """Each caught block's output against the same block of ``model`` (the
    fp32 reference, in train mode: batch statistics) run on that block's
    caught input: the relative L2, the largest over the block's outputs;
    each of ``judged``'s numbers is the largest over its blocks. The
    model's running statistics are left as they were."""
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    model.train()
    gaps, numbers = {}, {}
    for name in judged(model):      # in one order on every rank: their batch norms meet
        args, out = caught[name]
        ref = model.get_submodule(name)(*[_to(a, device) for a in args])
        gaps[name] = [compare.rel_l2(p, r.cpu()) for p, r in zip(_flat(out), _flat(ref))]
    for n, b in model.named_buffers():
        b.copy_(buffers[n])
    for name, number in judged(model).items():
        numbers[number] = max(numbers.get(number, 0.0), *gaps[name])
    log("blocks: " + ", ".join(f"{n} " + "/".join(f"{v:.4g}" for v in g) for n, g in gaps.items()))
    return numbers


def _to(x, device):
    return [_to(t, device) for t in x] if isinstance(x, (list, tuple)) else x.to(device)


def forward_numbers(prog: dict, ref: dict, log) -> dict:
    """The first step's train-mode forward against the reference's, sample
    by sample over the reference's batch, the largest: the relative L2 of
    the filter stack's input volume (``volume_rel``) and the largest over
    the context network's outputs (``context_rel``). A sample the program
    did not put out reads 1, as an output of zeros would."""
    rows = []
    for b in range(ref["volume"].shape[0]):
        if b >= prog["volume"].shape[0]:
            rows.append({"volume_rel": 1.0, "context_rel": 1.0})
        else:
            rows.append({"volume_rel": compare.rel_l2(prog["volume"][b], ref["volume"][b]),
                         "context_rel": max(compare.rel_l2(p[b], r[b])
                                            for p, r in zip(prog["context"], ref["context"]))})
        log(f"sample {b}: " + ", ".join(f"{n} {v:.6g}" for n, v in rows[-1].items()))
    return {n: max(r[n] for r in rows) for n in rows[0]}


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


def control(cell: dict, seed: int, device, faults: list[str], overrides: dict | None = None,
            log=lambda msg: None) -> dict:
    """The cell's numbers for a faulty reference in the program's place
    against the fp32 reference over the steps set-up takes (the first
    step's forward outputs, its judged blocks and the steps' numbers), by
    fault: ``fp8`` (the reference in fp8), ``half_batch`` (each step on the
    first half of its batch, the mean taken over it) or, on N > 1 ranks,
    ``own_gradient`` (each rank's update from its own gradient, with
    ``replica_gap``). ``log`` receives each judged block's gap."""
    kind = Training(cell, seed, device, overrides)
    pool = kind._global_pool()
    bad = {fault: reference_steps(kind.recipe, pool, device, kind.weights_seed,
                                  cdt=CONTROL_DTYPE if fault == "fp8" else torch.float32,
                                  half_batch=fault == "half_batch",
                                  average=fault != "own_gradient", catch=True)
           for fault in faults}
    ref = reference_steps(kind.recipe, pool, device, kind.weights_seed,
                          judge=tuple(bad[f]["outputs"] for f in faults), log=log)
    quiet = lambda msg: None  # noqa: E731
    out = {}
    for i, fault in enumerate(faults):
        out[fault] = dict(forward_numbers(bad[fault]["outputs"], ref["outputs"], quiet),
                          **ref["blocks"][i], **step_numbers(bad[fault], ref, quiet))
        if "replica_gap" in bad[fault]:
            out[fault]["replica_gap"] = bad[fault]["replica_gap"]
    return out
