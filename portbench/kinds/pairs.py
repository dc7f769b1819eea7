"""The kind ``pairs``: cells of served stereo pairs, one closed-loop client
that hands host uint8 arrays to the program's ``run_pair`` and waits for the
disparity on the host before it sends the next request.

``correct``: a sample of the pool's requests, drawn from the seed, is
caught where the window serves it first: the disparity the client received,
and the filter stack's output (the classifier's logits, through a forward
hook that copies them to pinned host memory). Once the window has closed
and the program is freed, the fp32 reference runs each sampled pair from the
same weights and inputs, one pair at a time.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from portbench import compare, traffic
from portbench.reference import model as reference
from portbench.reference.ops import CONTROL_DTYPE, pad_to

# The calls ``--trace 1`` profiles.
traced_calls = 3
# The faults ``control`` knows, each in the program's place.
FAULTS = ("fp8",)


class Pairs:
    def __init__(self, cell: dict, seed: int, device, overrides: dict | None = None):
        body = cell["configuration"]["body"]
        self.model_cfg = dict(body["model"], **(overrides or {}).get("model", {}))
        self.iters = (overrides or {}).get("iters", body["serve"]["iters"])
        self.mix = dict(cell["mix"], **(overrides or {}).get("mix", {}))
        self.details, self.seed, self.device = cell["details"], seed, torch.device(device)
        self.weights_seed = traffic.substream(seed, "weights")
        rng = np.random.default_rng(traffic.substream(seed, "sample"))
        self.sample = sorted(int(k) for k in rng.choice(self.mix["pool"], self.details["sample"], replace=False))
        self.caught: dict[int, dict] = {}
        self.buffers: dict[int, torch.Tensor] = {}
        self.model = None

    # -- set-up ---------------------------------------------------------------

    def setup(self, parts) -> None:
        from foundationstereo_torch.config import ModelConfig
        from foundationstereo_torch.models.foundation_stereo import FoundationStereo

        with parts("weights"):
            ref = reference.build(self.model_cfg, self.device, self.weights_seed)
            self.model = FoundationStereo(ModelConfig.from_dict(self.model_cfg), device=self.device)
            self.model.load_state_dict(ref.state_dict())
            del ref
            self._free()
        with parts("traffic"):
            self.pool = traffic.pairs(self.mix, self.seed, self.device)
        for k in range(2):
            with parts(f"warm-up call {k + 1}"):
                self.call(k, probe=k == 1)

    def _free(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the timed call -----------------------------------------------------------

    def call(self, i: int, probe: bool = False) -> int:
        """Serve request ``i`` (pool entry ``i % pool``); returns the pairs served."""
        from foundationstereo_torch.inference.demo import run_pair

        k = i % len(self.pool)
        catch = not probe and k in self.sample and k not in self.caught and bool(self.buffers)
        hook = None
        if probe or catch:
            hook = self.model.classifier.register_forward_hook(
                self._probe if probe else lambda m, a, out: self._keep(k, out))
        left, right = self.pool[k]
        disp = run_pair(self.model, left, right, iters=self.iters).cpu()
        if hook is not None:
            hook.remove()
        if catch:
            self.caught[k] = {"disp": disp, "logits": self.buffers[k]}
        return left.shape[0]

    def _keep(self, k: int, out: torch.Tensor) -> None:
        """The forward hook of a sampled request: the logits into its pinned
        buffer, queued on the stream (returns None: the output is unchanged)."""
        self.buffers[k].copy_(out, non_blocking=True)

    def _probe(self, _m, _a, out) -> None:
        """At set-up: the logits' shape and dtype, and one pinned host buffer
        per sampled request."""
        pin = self.device.type == "cuda"
        for k in self.sample:
            self.buffers[k] = torch.empty(out.shape, dtype=out.dtype, pin_memory=pin)

    def hooked_module(self):
        return self.model

    def items_per_call(self) -> int:
        return self.mix["batch"]

    def shape(self) -> dict:
        return {"batch": self.mix["batch"], "height": self.mix["height"],
                "width": self.mix["width"], "iters": self.iters}

    def flops_per_item(self) -> float:
        from portbench.counting import forward_flops

        return forward_flops(self.model_cfg, self.mix["height"], self.mix["width"], self.iters, 1)

    # -- after the window ---------------------------------------------------------------

    def release(self) -> None:
        self.model = None
        self._free()

    def check(self, log) -> tuple[dict, dict]:
        """The reference on each caught request, pair by pair: (numbers, diagnostics)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        missing = [k for k in self.sample if k not in self.caught]
        if missing:
            return {"requests_missing": float(len(missing))}, {}
        ref = reference.build(self.model_cfg, self.device, self.weights_seed)
        rows = []
        with torch.no_grad():
            for k in self.sample:
                left, right = self.pool[k]
                for b in range(left.shape[0]):
                    pair = [torch.as_tensor(x[b:b + 1], device=self.device).float() for x in (left, right)]
                    (lp, pads), (rp, _) = pad_to(pair[0]), pad_to(pair[1])
                    taps = {}
                    d = ref(lp, rp, self.iters, test_mode=True, taps=taps)
                    l, r, t, bt = pads
                    d = d[:, t:d.shape[1] - bt, l:d.shape[2] - r].cpu()
                    got = self.caught[k]
                    dp, lg = got["disp"][b:b + 1].float(), got["logits"][b:b + 1].float()
                    diff = (dp - d).abs()
                    rows.append({"disp_mae_px": float(diff.mean()),
                                 "disp_p99_px": float(torch.quantile(diff.flatten()[::7], 0.99)),
                                 "disp_max_px": float(diff.max()),
                                 **compare.filter_numbers(lg, taps["classifier"].cpu()),
                                 "ref_disp_mean_px": float(d.mean())})
                    log(f"request {k} pair {b}: " + ", ".join(f"{n} {v:.6g}" for n, v in rows[-1].items()))
        del ref
        self._free()
        numbers = {n: max(r[n] for r in rows) for n in rows[0]}
        return numbers, {"pairs_compared": len(rows)}


Kind = Pairs


def control(cell: dict, seed: int, device, faults: list[str], overrides: dict | None = None,
            log=lambda msg: None) -> dict:
    """The cell's numbers for the fp8 reference against the fp32 one, on the
    requests a run with ``seed`` samples (``faults``: ``fp8`` alone)."""
    kind = Pairs(cell, seed, device, overrides)
    pool = traffic.pairs(kind.mix, seed, device)
    ref = reference.build(kind.model_cfg, device, kind.weights_seed)
    low = reference.build(kind.model_cfg, device, kind.weights_seed, cdt=CONTROL_DTYPE)
    rows = []
    with torch.no_grad():
        for k in kind.sample:
            for b in range(pool[k][0].shape[0]):
                pair = [pad_to(torch.as_tensor(x[b:b + 1], device=device).float())[0]
                        for x in pool[k]]
                t32, t8 = {}, {}
                d32 = ref(*pair, kind.iters, test_mode=True, taps=t32)
                d8 = low(*pair, kind.iters, test_mode=True, taps=t8)
                rows.append({"disp_mae_px": compare.mean_abs(d8, d32),
                             **compare.filter_numbers(t8["classifier"], t32["classifier"])})
    return {"fp8": {n: max(r[n] for r in rows) for n in rows[0]}}
