"""Checkpoint save and restore with ``torch.save``, in the reference's layout.

A step's checkpoint is a family of files in one directory, as the reference
trainer writes them: ``{step}.pt`` (``{"model": state_dict,
"global_step": step}``, the model under the reference's parameter names, so
an inference loader of reference checkpoints reads it), ``{step}_ema.pt``
(the same with the EMA weights in place of the parameters; the batch stats
are the model's), ``{step}_optimizer.pt`` (the optimizer's state and update
count, and the trainer's step) and ``latest.pt`` (``{"step": step}``,
written once the step's files are complete); ``config.json`` sits beside.

Saves copy the tensors to the host at the call and write on a thread; each
file is written under a temporary name and renamed, so a file present is
complete. The newest ``max_to_keep`` steps are kept. The JAX package's orbax
checkpoints are not read: a directory holding one is refused.
"""

from __future__ import annotations

import json
import os
import re
import threading
from pathlib import Path

import torch

_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def _to_host(obj):
    """Copies on the host of every tensor in a nest of dicts and lists."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_host(v) for v in obj]
    return obj


def _atomic_save(obj, path: Path) -> None:
    tmp = path.with_name(f".{path.name}.tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _is_orbax(directory: Path) -> bool:
    """Orbax keeps a checkpoint per step as a numbered subdirectory."""
    return any(p.is_dir() and p.name.isdigit() for p in directory.iterdir())


class CheckpointManager:
    def __init__(self, directory: str | Path, max_to_keep: int = 5):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._threads: list[threading.Thread] = []
        self._errors: list[BaseException] = []

    def _check_format(self) -> None:
        if not any(self.directory.glob("*.pt")) and _is_orbax(self.directory):
            raise ValueError(f"{self.directory} holds orbax checkpoints of the JAX package; "
                             "the PyTorch port reads only its own torch.save checkpoints")

    def save(self, step: int, state, config: dict | None = None) -> None:
        """Asynchronous save of a ``TrainState`` at ``step``."""
        model_sd = _to_host(state.model.state_dict())
        ema_sd = None
        if state.ema is not None:
            ema_sd = dict(model_sd)
            ema_sd.update(_to_host(state.ema))
        opt_sd = {"optimizer": _to_host(state.optimizer.state_dict()), "step": int(state.step)}
        if config is not None:
            cfg_path = self.directory / "config.json"
            if not cfg_path.exists():
                cfg_path.write_text(json.dumps(config, indent=2))

        def write():
            try:
                d = self.directory
                _atomic_save({"model": model_sd, "global_step": step}, d / f"{step}.pt")
                if ema_sd is not None:
                    _atomic_save({"model": ema_sd, "global_step": step}, d / f"{step}_ema.pt")
                _atomic_save(opt_sd, d / f"{step}_optimizer.pt")
                _atomic_save({"step": step}, d / "latest.pt")
                self._prune()
            except BaseException as e:  # noqa: BLE001 -- raised again by wait()
                self._errors.append(e)

        self.wait()          # one save at a time: steps land in order
        t = threading.Thread(target=write, name=f"checkpoint-{step}", daemon=True)
        t.start()
        self._threads.append(t)

    def save_model(self, step: int, model: torch.nn.Module, config: dict) -> None:
        """Write a model alone (no optimizer, no EMA) at ``step``, with its
        ``config.json``, and wait for the files."""
        self.wait()
        (self.directory / "config.json").write_text(json.dumps(config, indent=2))
        _atomic_save({"model": _to_host(model.state_dict()), "global_step": step},
                     self.directory / f"{step}.pt")
        _atomic_save({"step": step}, self.directory / "latest.pt")

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for p in self.directory.iterdir()
                      if (m := _STEP_FILE.match(p.name)))

    def _prune(self) -> None:
        for step in self.steps()[:-self.max_to_keep]:
            for suffix in (".pt", "_ema.pt", "_optimizer.pt"):
                (self.directory / f"{step}{suffix}").unlink(missing_ok=True)

    def latest_step(self) -> int | None:
        latest = self.directory / "latest.pt"
        if latest.exists():
            return int(torch.load(latest, weights_only=True)["step"])
        self._check_format()
        return None

    def _resolve(self, step) -> int | None:
        if step in (None, "latest"):
            return self.latest_step()
        self._check_format()
        return int(step)

    def restore(self, step, target):
        """Load ``step`` (an int, "latest" or None) into the ``TrainState``
        ``target``; returns (state, step), or (target, 0) when the directory
        holds no checkpoint."""
        step = self._resolve(step)
        if step is None:
            return target, 0
        d = self.directory
        target.model.load_state_dict(torch.load(d / f"{step}.pt", weights_only=True)["model"])
        opt = torch.load(d / f"{step}_optimizer.pt", weights_only=True)
        target.optimizer.load_state_dict(opt["optimizer"])
        target.step = int(opt["step"])
        if target.ema is not None:
            ema = torch.load(d / f"{step}_ema.pt", weights_only=True)["model"]
            for k, v in target.ema.items():
                v.copy_(ema[k])
        return target, step

    def restore_inference(self, step="latest", use_ema: bool = False) -> tuple[dict, int]:
        """The model's state_dict at ``step`` (parameters and batch stats),
        with the EMA weights in place of the parameters under ``use_ema``."""
        resolved = self._resolve(step)
        if resolved is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        path = self.directory / f"{resolved}{'_ema' if use_ema else ''}.pt"
        if not path.exists():
            raise ValueError(f"no {path.name}: the checkpoint has no EMA weights "
                             "(trained with --ema 0)" if use_ema else f"no {path}")
        return torch.load(path, weights_only=True)["model"], resolved

    def wait(self) -> None:
        for t in self._threads:
            t.join()
        self._threads = []
        if self._errors:
            err, self._errors = self._errors[0], []
            raise RuntimeError("checkpoint save failed") from err

    def close(self) -> None:
        self.wait()
