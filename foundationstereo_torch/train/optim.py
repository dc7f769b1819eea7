"""Optimizer, LR schedules, gradient clipping and EMA.

The port of the JAX package's ``train/optim.py`` (optax there):

* the optimizer type by name (AdamW, Adam, SGD; ``torch.optim``, whose
  updates are optax's) over param groups chosen by fnmatch
  ``include``/``exclude`` patterns matched against each parameter's flax
  path, so that one config trains the same parameters in both packages.
  The path is the one ``convert/name_map.py`` gives the parameter: a JAX
  wrapper module's single inner ``Conv_0``/``BatchNorm_0``/``GroupNorm_0``
  is left out of it (``name_map.canonical_path``), which matters only to a
  pattern that names such an inner module. The frozen DepthAnything model
  (``feature/dino/*``) and unmatched parameters are not in the optimizer;
* LR lambdas parsed from sympy expressions in ``epoch`` (e.g.
  ``"Piecewise((1.0, epoch < 160000), (0.1, True))"``), tabulated every
  1000 steps and interpolated between, as the JAX package evaluates them;
  and optax's join, warmup-cosine and polynomial schedules. The schedule is
  read at the count of applied updates (``ScheduledOptimizer.count``),
  which a skipped step does not advance;
* optax's ``clip_by_global_norm`` (g / |g| * max where |g| >= max, no
  epsilon; ``clip_grad_norm_`` adds one);
* the EMA of the parameters, kept as copies (decay 0.999).
"""

from __future__ import annotations

import fnmatch
import math
from typing import Callable

import numpy as np
import torch

from foundationstereo_torch.convert.name_map import build_name_map

FROZEN_PATTERNS = ("feature/dino/*", "feature/dino")
DEFAULT_GROUPS = [{"params": {"include": ["*"]}, "lr": 1e-4}]


def flax_paths(model: torch.nn.Module) -> dict[str, str]:
    """{parameter name: its flax path} from the name map."""
    inv = {tk: fp for fp, (tk, _) in build_name_map(model.cfg).rules.items()
           if not fp.startswith("batch_stats::")}
    missing = [n for n, _ in model.named_parameters() if n not in inv]
    if missing:
        raise ValueError(f"parameters without a flax path: {missing[:5]}")
    return {n: inv[n] for n, _ in model.named_parameters()}


def _match(name: str, patterns) -> bool:
    return any(fnmatch.fnmatch(name, p) for p in patterns)


def label_of(path: str, group_specs: list[dict]) -> str:
    """"frozen" (the DepthAnything subtree, or no group matches) or
    "group{i}", the first group whose include matches and exclude does not."""
    if _match(path, FROZEN_PATTERNS) or path.startswith("feature/dino/"):
        return "frozen"
    for gi, spec in enumerate(group_specs):
        inc = spec.get("params", {}).get("include", ["*"])
        exc = spec.get("params", {}).get("exclude", [])
        if _match(path, inc) and not _match(path, exc):
            return f"group{gi}"
    return "frozen"


def label_params(model: torch.nn.Module, group_specs: list[dict]) -> dict[str, str]:
    """{parameter name: its label} (see ``label_of``)."""
    return {n: label_of(p, group_specs) for n, p in flax_paths(model).items()}


def parse_lr_lambda(expr: str) -> Callable[[int], float]:
    """A sympy LR-lambda expression in the variable ``epoch``."""
    import sympy

    epoch = sympy.Symbol("epoch")
    fn = sympy.lambdify(epoch, sympy.sympify(expr), modules=["numpy"])
    return lambda step: float(fn(step))


def tabulate(lam: Callable[[int], float], horizon: int = 1_000_001,
             stride: int = 1000) -> Callable[[int], float]:
    """``lam`` sampled every ``stride`` steps in float32 and interpolated
    linearly between (held at the last sample past the horizon)."""
    xs = np.arange(0, horizon, stride).astype(np.float32)
    ys = np.array([lam(int(x)) for x in xs], np.float32)
    return lambda step: float(np.float32(np.interp(np.float32(step), xs, ys)))


def _polynomial(init: float, end: float, power: float, steps: int) -> Callable[[int], float]:
    def fn(step):
        frac = 1.0 - min(max(step, 0), steps) / steps
        return (init - end) * frac ** power + end
    return fn


def _cosine(init: float, decay_steps: int, alpha: float) -> Callable[[int], float]:
    def fn(step):
        count = min(step, decay_steps)
        return init * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * count / decay_steps)) + alpha)
    return fn


def _join(schedules: list, boundaries: list[int]) -> Callable[[int], float]:
    def fn(step):
        out = schedules[0](step)
        for b, s in zip(boundaries, schedules[1:]):
            if step >= b:
                out = s(step - b)
        return out
    return fn


def build_schedule(lr_scheduler_cfg: dict | None, base_lr: float) -> Callable[[int], float]:
    """step -> LR from the reference's ``lr_scheduler`` config section."""
    if not lr_scheduler_cfg:
        return lambda step: base_lr
    typ = lr_scheduler_cfg.get("type", "LambdaLR")
    params = lr_scheduler_cfg.get("params", {})
    if typ == "LambdaLR":
        table = tabulate(parse_lr_lambda(params["lr_lambda"]))
        return lambda step: float(np.float32(base_lr) * np.float32(table(step)))
    if typ == "SequentialLR":
        return _join([build_schedule(s, base_lr) for s in params["schedulers"]],
                     params["milestones"])
    if typ == "warmup_cosine":
        warmup = params.get("warmup_steps", 1000)
        end = params.get("end_lr", 0.0)
        return _join([_polynomial(0.0, base_lr, 1.0, warmup),
                      _cosine(base_lr, params.get("total_steps", 100000) - warmup,
                              0.0 if base_lr == 0.0 else end / base_lr)], [warmup])
    if typ == "poly":
        return _polynomial(base_lr, params.get("end_lr", 0.0), params.get("power", 0.9),
                           params.get("total_steps", 100000))
    raise ValueError(f"unknown scheduler {typ}")


class ScheduledOptimizer:
    """A ``torch.optim`` optimizer with one LR schedule per param group,
    read at ``count``, the number of updates applied so far (optax's count:
    a skipped step applies none)."""

    def __init__(self, optimizer: torch.optim.Optimizer, schedules: list):
        self.optimizer, self.schedules, self.count = optimizer, schedules, 0

    def lrs(self) -> list[float]:
        return [s(self.count) for s in self.schedules]

    def step(self) -> None:
        for group, lr in zip(self.optimizer.param_groups, self.lrs()):
            group["lr"] = lr
        self.optimizer.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"optimizer": self.optimizer.state_dict(), "count": self.count}

    def load_state_dict(self, sd: dict) -> None:
        self.optimizer.load_state_dict(sd["optimizer"])
        self.count = int(sd["count"])


def build_optimizer(model: torch.nn.Module, optimizer_cfg: dict,
                    lr_scheduler_cfg: dict | None = None
                    ) -> tuple[ScheduledOptimizer, dict[str, str]]:
    """The optimizer over the model's labelled parameters, and the labels."""
    typ = optimizer_cfg.get("type", "AdamW")
    group_specs = optimizer_cfg.get("params", DEFAULT_GROUPS)
    labels = label_params(model, group_specs)
    named = dict(model.named_parameters())
    groups, schedules = [], []
    for gi, spec in enumerate(group_specs):
        params = [named[n] for n, lab in labels.items() if lab == f"group{gi}"]
        if not params:
            continue
        lr = spec.get("lr", 1e-4)
        group = {"params": params, "lr": lr}
        if typ in ("AdamW", "Adam"):
            group.update(betas=tuple(spec.get("betas", (0.9, 0.999))), eps=spec.get("eps", 1e-8),
                         weight_decay=spec.get("weight_decay", 0.0) if typ == "AdamW" else 0.0)
        elif typ == "SGD":
            group.update(momentum=spec.get("momentum", 0.0))
        else:
            raise ValueError(f"unknown optimizer {typ}")
        groups.append(group)
        schedules.append(build_schedule(lr_scheduler_cfg, lr))
    cls = {"AdamW": torch.optim.AdamW, "Adam": torch.optim.Adam, "SGD": torch.optim.SGD}[typ]
    return ScheduledOptimizer(cls(groups), schedules), labels


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum |g|^2) over the tensors, in fp32."""
    return torch.sqrt(sum((g.float() * g.float()).sum() for g in grads))


@torch.no_grad()
def clip_by_global_norm(grads: list[torch.Tensor], norm: torch.Tensor,
                        max_norm: float = 1.0) -> None:
    """optax's ``clip_by_global_norm`` in place: g -> g / |g| * max_norm where
    |g| >= max_norm, unchanged below (g / 1 * 1). Decided on the device: no
    synchronisation."""
    if grads:
        below = norm < max_norm
        torch._foreach_div_(grads, torch.where(below, 1.0, norm))
        torch._foreach_mul_(grads, torch.where(below, 1.0, max_norm).to(norm))


def ema_init(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """Copies of every parameter (never aliases of the live ones)."""
    return {n: p.detach().clone() for n, p in model.named_parameters()}


@torch.no_grad()
def ema_update(ema: dict[str, torch.Tensor], model: torch.nn.Module, decay: float = 0.999) -> None:
    """ema <- decay * ema + (1 - decay) * p, in place."""
    named = dict(model.named_parameters())
    vals = list(ema.values())
    torch._foreach_mul_(vals, decay)
    torch._foreach_add_(vals, [named[n].detach() for n in ema], alpha=1.0 - decay)
