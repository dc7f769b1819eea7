"""The numbers that decide ``correct``: each compared with its limit from the
cell's details file (``workloads/<cell>.json``, ``checks``). A number above
its limit, not finite, or without a limit fails the run."""

from __future__ import annotations

import math

import torch


def rel_l2(x: torch.Tensor, ref: torch.Tensor) -> float:
    """|x - ref| / |ref| in fp64."""
    x, ref = x.double(), ref.double()
    return float(torch.linalg.vector_norm(x - ref) / torch.linalg.vector_norm(ref))


def mean_abs(x: torch.Tensor, ref: torch.Tensor) -> float:
    return float((x.double() - ref.double()).abs().mean())


def init_disparity(logits: torch.Tensor) -> torch.Tensor:
    """The soft-argmin of (B, D, H, W) logits in full-resolution pixels (4x
    the 1/4-resolution index): the filter stack's output as the refinement
    starts from it."""
    p = torch.softmax(logits.double(), dim=1)
    d = torch.arange(p.shape[1], dtype=p.dtype, device=p.device).reshape(1, -1, 1, 1)
    return 4.0 * (p * d).sum(dim=1)


def filter_numbers(logits: torch.Tensor, ref: torch.Tensor) -> dict[str, float]:
    """The classifier's logits against the reference's: relative L2, the same
    with each pixel's mean over D taken out (softmax ignores it), and the
    mean |Δ| of the soft-argmin disparity."""
    centre = lambda x: x.double() - x.double().mean(dim=1, keepdim=True)  # noqa: E731
    return {"logits_rel": rel_l2(logits, ref),
            "logits_centered_rel": rel_l2(centre(logits), centre(ref)),
            "init_mae_px": mean_abs(init_disparity(logits), init_disparity(ref))}


def worst_leaf_gap(prog: dict[str, torch.Tensor], ref: dict[str, torch.Tensor],
                   keep: set[str] | None = None) -> tuple[float, str]:
    """max over leaves of | |prog_leaf| - |ref_leaf| |, each over the larger
    of |ref_leaf| and the median leaf's |ref|; and the worst leaf's name."""
    gaps = _leaf_gaps(prog, ref, keep)
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def _leaf_gaps(prog, ref, keep):
    names = [n for n in ref if keep is None or n in keep]
    rnorm = {n: float(torch.linalg.vector_norm(ref[n].double())) for n in names}
    pnorm = {n: float(torch.linalg.vector_norm(prog[n].double())) for n in names}
    med = sorted(rnorm.values())[len(names) // 2]
    return {n: abs(pnorm[n] - rnorm[n]) / max(rnorm[n], med, 1e-30) for n in names}


def leaf_diffs(prog, ref, keep=None) -> dict[str, float]:
    """Per leaf, |prog_leaf - ref_leaf| over the larger of |ref_leaf| and the
    median leaf's |ref|: what rounding moves at first order, which a gap of
    norms sees only at second."""
    names = [n for n in ref if keep is None or n in keep]
    rnorm = {n: float(torch.linalg.vector_norm(ref[n].double())) for n in names}
    med = sorted(rnorm.values())[len(names) // 2]
    return {n: float(torch.linalg.vector_norm(prog[n].double() - ref[n].double()))
            / max(rnorm[n], med, 1e-30) for n in names}


def median_leaf_gap(prog, ref, keep=None) -> float:
    """The median over leaves of ``worst_leaf_gap``'s per-leaf gap."""
    gaps = sorted(_leaf_gaps(prog, ref, keep).values())
    return gaps[len(gaps) // 2]


def total_gap(prog, ref, keep=None) -> float:
    """| |prog| - |ref| | / |ref| over all the leaves kept, as one vector."""
    names = [n for n in ref if keep is None or n in keep]
    p = sum(float(prog[n].double().square().sum()) for n in names) ** 0.5
    r = sum(float(ref[n].double().square().sum()) for n in names) ** 0.5
    return abs(p - r) / r


def judge(numbers: dict[str, float], limits: dict[str, float | None]) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}}) for the
    numbers the cell holds."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, math.nan)
        checks[name] = {"value": value, "limit": limit}
        if limit is None or not math.isfinite(value) or value > limit:
            ok = False
    return ok, checks
