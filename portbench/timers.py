"""Device-clock timers around the program's modules: CUDA events recorded at
forward pre- and post-hooks on the model's top-level children (host gaps
between launches included), and a train step's split into forward, loss and
backward up to the last gradient accumulated, and the update after it."""

from __future__ import annotations

import torch


def _event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class ModuleTimes:
    """While open, every forward call of each top-level child of ``model``
    is timed; with ``forward_only`` a call made while the model's own
    forward is not running (a checkpointed region's recompute in the
    backward) is not. ``ms()`` (after a synchronize) gives the summed
    milliseconds per child."""

    def __init__(self, model: torch.nn.Module, forward_only: bool = False):
        self.model, self.forward_only = model, forward_only
        self.spans: dict[str, list] = {}
        self.in_forward = [not forward_only]
        self.handles = []

    def __enter__(self):
        if self.forward_only:
            self.handles += [
                self.model.register_forward_pre_hook(lambda m, a: self.in_forward.__setitem__(0, True)),
                self.model.register_forward_hook(lambda m, a, o: self.in_forward.__setitem__(0, False))]
        for name, child in self.model.named_children():
            self.handles += [child.register_forward_pre_hook(self._pre(name)),
                             child.register_forward_hook(self._post(name))]
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()

    def _pre(self, name):
        def hook(_m, _a):
            if self.in_forward[0]:
                self.spans.setdefault(name, []).append([_event(), None])
        return hook

    def _post(self, name):
        def hook(_m, _a, _o):
            if self.in_forward[0]:
                self.spans[name][-1][1] = _event()
        return hook

    def ms(self) -> dict[str, float]:
        return {n: sum(a.elapsed_time(b) for a, b in evs) for n, evs in self.spans.items()}


class StepSplit:
    """While open, each train step is split on the card's clock: from the
    model's forward returning (the loss starts) to the last gradient
    accumulated (``backward``), as lists of ms per step."""

    def __init__(self, model: torch.nn.Module):
        self.model, self.marks, self.handles = model, [], []

    def __enter__(self):
        self.handles.append(self.model.register_forward_hook(self._forward_done))
        self.handles += [p.register_post_accumulate_grad_hook(self._grad)
                         for p in self.model.parameters() if p.requires_grad]
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()

    def _forward_done(self, _m, _a, _o):
        self.marks.append([_event(), None])

    def _grad(self, _p):
        if self.marks:
            self.marks[-1][1] = _event()

    def backward_ms(self) -> list[float]:
        return [a.elapsed_time(b) for a, b in self.marks if b is not None]
