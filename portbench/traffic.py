"""The one traffic generator. A mix file (``traffic/<mix>.json``) gives its
``kind`` and parameters; the generator makes the mix's pool from the seed,
on the card in a few large calls, and the cell's calls cycle through it.

- ``pairs``: ``pool`` stereo requests of ``batch`` pairs of ``height`` x
  ``width`` RGB uint8 noise, handed to the program as host arrays.
- ``train_batches``: ``pool`` batches with the keys and shapes the
  training pipeline yields: ``batch`` crops of ``crop_wh`` (width, height)
  float RGB in 0-255, a smooth ground-truth disparity in (0,
  ``max_disparity``) with its mask, every sample of ``label_type``, and a
  two-word dropout key per batch.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def substream(seed: int, name: str) -> int:
    """A 63-bit seed for one use of the run's seed."""
    words = [seed % 2 ** 32, (seed // 2 ** 32) % 2 ** 32] + [ord(c) for c in name]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] % 2 ** 63)


def pairs(mix: dict, seed: int, device) -> list[tuple[np.ndarray, np.ndarray]]:
    gen = torch.Generator(device=device).manual_seed(substream(seed, "pairs"))
    shape = (mix["pool"], 2, mix["batch"], mix["height"], mix["width"], 3)
    host = torch.randint(0, 256, shape, generator=gen, device=device, dtype=torch.uint8).cpu().numpy()
    return [(host[i, 0], host[i, 1]) for i in range(mix["pool"])]


def train_batches(mix: dict, seed: int, device, label_types: list[str]) -> list[dict]:
    gen = torch.Generator(device=device).manual_seed(substream(seed, "train"))
    n, b = mix["pool"], mix["batch"]
    w, h = mix["crop_wh"]
    top = float(mix["max_disparity"])
    images = torch.rand((n, 2, b, h, w, 3), generator=gen, device=device) * 255.0
    coarse = torch.rand((n * b, 1, h // 32 + 1, w // 32 + 1), generator=gen, device=device)
    disp = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=True)
    disp = (0.02 + 0.96 * disp.reshape(n, b, h, w)) * top
    keys = np.random.default_rng(substream(seed, "rng")).integers(0, 2 ** 31, size=(n, 2))
    label = sorted(label_types).index(mix["label_type"])
    return [{"left": images[i, 0], "right": images[i, 1], "disparity": disp[i],
             "mask": (disp[i] > 0) & (disp[i] < top),
             "label_idx": torch.full((b,), label, dtype=torch.int64, device=device),
             "rng": keys[i].astype(np.uint32)} for i in range(n)]
