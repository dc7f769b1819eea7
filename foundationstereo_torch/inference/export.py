"""Model export: the test-mode forward frozen into a ``torch.export`` program.

The port of the JAX package's ``inference/export.py`` (which lowers the
forward to StableHLO; the reference exports ONNX for TensorRT). The
forward is traced at a fixed H x W and iteration count into an
``ExportedProgram`` and saved with ``torch.export.save``; a manifest with
the JAX package's keys is written beside it (``<out_path>.json``).

The kernels stay in the program: each is a ``torch.ops.fs`` operator
(``ops/kernels.py``), one opaque node whose CUDA kernel the loaded program
launches on CUDA tensors, as the eager forward does, and whose plain twin it
runs on CPU tensors. Their launch grids are computed at each call, so a
program with a symbolic batch keeps them too (the JAX package turns its
Pallas kernels off for a symbolic batch, whose grids are fixed at trace
time). The artifact's contract (inputs, output, manifest) is the JAX one.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from foundationstereo_torch.ops import kernels  # noqa: F401 -- registers the fs:: operators


class _TestMode(torch.nn.Module):
    """The test-mode forward at a fixed iteration count: (left, right) ->
    the (B, H, W) disparity."""

    def __init__(self, model: torch.nn.Module, iters: int):
        super().__init__()
        self.model, self.iters = model, iters

    def forward(self, left, right):
        return self.model(left, right, iters=self.iters, test_mode=True)


def export_program(model: torch.nn.Module, height: int, width: int, iters: int,
                   out_path: str | Path, batch: int = 1, dynamic_batch: bool = False) -> dict:
    """Trace ``model``'s test-mode forward on (B, height, width, 3) images
    (H and W multiples of 32) on the model's device and save the program.

    ``dynamic_batch=True`` makes the batch of both images one symbolic
    dimension (the reference's ONNX ``dynamic_axes`` on the batch); the
    example batch is then 2, since an example of size 1 would be
    specialised. H, W and the iteration count stay fixed, as in the JAX and
    reference exports. Returns the manifest (also written beside the
    artifact).
    """
    device = next(model.parameters()).device
    b = 2 if dynamic_batch else batch
    left = torch.zeros((b, height, width, 3), device=device)
    shapes = None
    if dynamic_batch:
        dim = torch.export.Dim("b", min=1, max=1024)
        shapes = {"left": {0: dim}, "right": {0: dim}}
    model.eval()
    with torch.no_grad():
        program = torch.export.export(_TestMode(model, iters), (left, left.clone()),
                                      dynamic_shapes=shapes)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(program, out_path)
    bdim = "b (symbolic)" if dynamic_batch else batch
    manifest = {
        "format": "torch.export ExportedProgram (torch.export.save)",
        "input_shapes": {"left": [bdim, height, width, 3], "right": [bdim, height, width, 3]},
        "output": f"disparity ({bdim}, {height}, {width})",
        "iters": iters,
    }
    Path(str(out_path) + ".json").write_text(json.dumps(manifest, indent=2))
    return manifest


def load_exported(path: str | Path) -> torch.nn.Module:
    """The saved program as a module: ``module(left, right)`` -> disparity.
    Its parameters are frozen (``requires_grad=False``): the kernels have no
    backward."""
    module = torch.export.load(path).module()
    module.requires_grad_(False)
    return module
