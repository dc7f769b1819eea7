"""Stereo training data pipeline (host-side, PIL + numpy, threaded prefetch).

The port's copy of the JAX package's ``train/dataloader.py``, the same code
over the same on-disk contract (``left/rgb/*.jpg``, ``right/rgb/*.jpg``,
``left/disparity/*.png`` with 3-channel base-255 uint8 disparity) and the
same sampling and augmentation pipeline: weighted dataset choice, a
per-batch target size (a fixed list, or aspect/area sampling snapped to /32
buckets), aspect-keeping resize with width-ratio disparity scaling, centre
crop or pad, stereo-consistent flips, shared colour jitter, a 30%-likely
rectification perturbation of the right image, disparity stretching, the
max-disparity clamp and the invalid-instance fallback for a bad sample.
Loading and processing run in a thread pool with a bounded prefetch queue;
batches are numpy, and the train CLI moves them to the card.
"""

from __future__ import annotations

import queue
import random
import threading
from pathlib import Path
from typing import Any, Dict, List

import numpy as np
from PIL import Image

from foundationstereo_torch import native
from foundationstereo_torch.utils.misc import depth_uint8_decoding, get_resize_keep_aspect_ratio


# ---------------------------------------------------------------------------
# numpy image ops (cv2/torchvision equivalents)
# ---------------------------------------------------------------------------


def _resize(img: np.ndarray, wh: tuple[int, int], nearest: bool = False) -> np.ndarray:
    """Resize HxW(xC) array: native C++ kernels when built, else PIL/numpy."""
    w, h = wh
    if nearest:
        if native.available():
            out = native.resize_nearest(img.astype(np.float32), wh)
            return out.astype(img.dtype) if img.dtype != np.float32 else out
        H, W = img.shape[:2]
        ys = np.minimum((np.arange(h) * H / h).astype(np.int64), H - 1)
        xs = np.minimum((np.arange(w) * W / w).astype(np.int64), W - 1)
        return img[ys][:, xs]
    if native.available():
        return native.resize_bilinear(img.astype(np.float32), wh)
    pil = Image.fromarray(img.astype(np.uint8) if img.dtype != np.uint8 else img)
    return np.asarray(pil.resize((w, h), Image.BILINEAR))


def _rgb_to_gray(img: np.ndarray) -> np.ndarray:
    return img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114


def adjust_brightness(img, f):
    return np.clip(img * f, 0, 255)


def adjust_contrast(img, f):
    mean = _rgb_to_gray(img).mean()
    return np.clip(img * f + mean * (1 - f), 0, 255)


def adjust_saturation(img, f):
    gray = _rgb_to_gray(img)[..., None]
    return np.clip(img * f + gray * (1 - f), 0, 255)


def adjust_hue(img, f):
    """Shift hue by f (in turns, [-0.5, 0.5]) via HSV round-trip."""
    import colorsys  # noqa: F401  (documentation only; vectorized below)
    x = img / 255.0
    maxc = x.max(-1)
    minc = x.min(-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    with np.errstate(invalid="ignore", divide="ignore"):
        rc = (maxc - r) / np.maximum(delta, 1e-12)
        gc = (maxc - g) / np.maximum(delta, 1e-12)
        bc = (maxc - b) / np.maximum(delta, 1e-12)
    h = np.where(r == maxc, bc - gc, np.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    h = np.where(delta == 0, 0.0, h)
    h = (h + f) % 1.0
    i = np.floor(h * 6.0)
    frac = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * frac)
    t = v * (1.0 - s * (1.0 - frac))
    i = i.astype(np.int64) % 6
    r2 = np.choose(i, [v, q, p, p, t, v])
    g2 = np.choose(i, [t, v, v, q, p, p])
    b2 = np.choose(i, [p, p, t, v, v, q])
    return np.clip(np.stack([r2, g2, b2], -1) * 255.0, 0, 255)


def adjust_gamma(img, gamma):
    return np.clip(((img / 255.0) ** gamma) * 255.0, 0, 255)


def warp_affine_reflect(img: np.ndarray, tx: float, ty: float, angle_deg: float) -> np.ndarray:
    """Rotate-about-center + translate with bilinear sampling and reflect
    border (cv2.warpAffine equivalent for the rectification perturbation,
    train/dataloader.py:264-280)."""
    h, w = img.shape[:2]
    cy, cx = h // 2, w // 2
    a = np.deg2rad(angle_deg)
    cos, sin = np.cos(a), np.sin(a)
    # Inverse map of M = R(center, angle) + t: src = R^-1 @ (dst - t - c) + c
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float64),
                         np.arange(w, dtype=np.float64), indexing="ij")
    dx = xs - tx - cx
    dy = ys - ty - cy
    sx = cos * dx - sin * dy + cx
    sy = sin * dx + cos * dy + cy

    def reflect(v, n):
        # OpenCV BORDER_REFLECT_101 style
        v = np.abs(v)
        period = 2 * (n - 1)
        v = v % period
        return np.where(v >= n, period - v, v)

    x0 = np.floor(sx)
    y0 = np.floor(sy)
    wx = sx - x0
    wy = sy - y0

    def at(yi, xi):
        yi = reflect(yi, h).astype(np.int64)
        xi = reflect(xi, w).astype(np.int64)
        return img[yi, xi]

    out = (at(y0, x0) * ((1 - wy) * (1 - wx))[..., None]
           + at(y0, x0 + 1) * ((1 - wy) * wx)[..., None]
           + at(y0 + 1, x0) * (wy * (1 - wx))[..., None]
           + at(y0 + 1, x0 + 1) * (wy * wx)[..., None])
    return np.clip(out, 0, 255)


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------


class StereoTrainDataLoaderPipeline:
    """Weighted-sampled, augmented stereo batches with async prefetch."""

    def __init__(self, config: dict, batch_size: int, num_load_workers: int = 4,
                 num_process_workers: int = 8, buffer_size: int = 8):
        self.config = config
        self.batch_size = batch_size
        self.max_disparity = config.get("max_disparity", 192)
        self.image_augmentation = config.get("image_augmentation", [])
        self.stereo_augmentation = config.get("stereo_augmentation", True)
        self.num_workers = max(1, num_load_workers)
        self.buffer_size = buffer_size

        if "image_sizes" in config:
            self.image_size_strategy = "fixed"
            self.image_sizes = config["image_sizes"]
        elif "aspect_ratio_range" in config and "area_range" in config:
            self.image_size_strategy = "aspect_area"
            self.aspect_ratio_range = config["aspect_ratio_range"]
            self.area_range = config["area_range"]
        else:
            raise ValueError("Invalid image size configuration")

        self.datasets: Dict[str, dict] = {}
        for dataset in config["datasets"]:
            name = dataset["name"]
            dataset_path = Path(dataset["path"])
            left_rgb = dataset_path / "left" / "rgb"
            right_rgb = dataset_path / "right" / "rgb"
            left_disp = dataset_path / "left" / "disparity"
            if not all(p.exists() for p in (left_rgb, right_rgb, left_disp)):
                raise ValueError(f"Dataset {name} missing required directories")
            left = {f.stem for f in left_rgb.glob("*.jpg")}
            right = {f.stem for f in right_rgb.glob("*.jpg")}
            disp = {f.stem for f in left_disp.glob("*.png")}
            files = sorted(left & right & disp)
            if not files:
                raise ValueError(f"No matching stereo pairs found in dataset {name}")
            self.datasets[name] = {**dataset, "path": dataset_path, "filenames": files}

        self.dataset_names = [d["name"] for d in config["datasets"]]
        self.dataset_weights = [d["weight"] for d in config["datasets"]]

        self.invalid_instance = {
            "left_image": np.zeros((256, 256, 3), np.float32),
            "right_image": np.zeros((256, 256, 3), np.float32),
            "disparity": np.ones((256, 256), np.float32),
            "disparity_mask": np.zeros((256, 256), bool),
            "label_type": "invalid",
        }

        self._queue: queue.Queue = queue.Queue(maxsize=buffer_size)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._batch_lock = threading.Lock()
        self._batch_id = 0

    # -- sampling -----------------------------------------------------------

    def _sample_batch(self) -> List[dict]:
        with self._batch_lock:
            self._batch_id += 1
            batch_id = self._batch_id
        batch = []
        for _ in range(self.batch_size):
            name = random.choices(self.dataset_names, weights=self.dataset_weights)[0]
            filename = random.choice(self.datasets[name]["filenames"])
            batch.append({
                "batch_id": batch_id,
                "seed": random.randint(0, 2 ** 32 - 1),
                "dataset": name,
                "filename": filename,
                "label_type": self.datasets[name]["label_type"],
            })
        if self.image_size_strategy == "fixed":
            width, height = random.choice(self.config["image_sizes"])
        else:
            area = random.uniform(*self.area_range)
            ranges = [self.datasets[i["dataset"]].get("aspect_ratio_range",
                                                      self.aspect_ratio_range)
                      for i in batch]
            lo = min(r[0] for r in ranges)
            hi = max(r[1] for r in ranges)
            ar = random.uniform(lo, hi)
            # Snap sampled sizes to /32 buckets so each bucket compiles one
            # device program (the reference samples arbitrary sizes and eats
            # a fresh CUDA graph per batch; XLA would recompile instead).
            # Area-preserving snap: width from area*aspect, then height from
            # the SNAPPED width — keeps the sampled-area distribution close
            # to the reference's (independent snapping shifts both area and
            # aspect, most strongly at small sizes). Documented deviation in
            # docs/COVERAGE.md (T2).
            width = max(32, int(round((area * ar) ** 0.5 / 32)) * 32)
            height = max(32, int(round(area / width / 32)) * 32)
        for inst in batch:
            inst["width"], inst["height"] = width, height
        return batch

    # -- IO -----------------------------------------------------------------

    def _load_instance(self, instance: dict) -> dict:
        try:
            root = self.datasets[instance["dataset"]]["path"]
            fn = instance["filename"]
            left = np.asarray(Image.open(root / "left" / "rgb" / f"{fn}.jpg").convert("RGB"))
            right = np.asarray(Image.open(root / "right" / "rgb" / f"{fn}.jpg").convert("RGB"))
            disp_u8 = np.asarray(Image.open(root / "left" / "disparity" / f"{fn}.png"))
            if disp_u8.ndim == 3:
                if native.available():
                    disparity = native.decode_disparity(disp_u8)
                else:
                    disparity = depth_uint8_decoding(disp_u8).astype(np.float32)
            else:
                disparity = disp_u8.astype(np.float32)
            mask = disparity > 0
            if left.shape[:2] != right.shape[:2]:
                raise ValueError("left/right size mismatch")
            if left.shape[:2] != disparity.shape[:2]:
                raise ValueError("image/disparity size mismatch")
            instance.update(left_image=left, right_image=right,
                            disparity=disparity, disparity_mask=mask)
        except Exception as e:  # noqa: BLE001 — any bad sample becomes invalid
            print(f"Failed to load {instance['dataset']}/{instance['filename']}: {e}")
            instance.update(self.invalid_instance)
        return instance

    # -- processing ----------------------------------------------------------

    def _process_instance(self, instance: dict) -> dict:
        if instance["label_type"] == "invalid":
            # Emit the batch's target shape so collation can stack (the
            # reference keeps a fixed 256x256 invalid instance, which breaks
            # whenever the batch target differs).
            h, w = instance["height"], instance["width"]
            instance.update({
                "left_image": np.zeros((h, w, 3), np.float32),
                "right_image": np.zeros((h, w, 3), np.float32),
                "disparity": np.ones((h, w), np.float32),
                "disparity_mask": np.zeros((h, w), bool),
            })
            return instance
        # Aug math in float32: the reference's augmentation semantics are
        # statistical (random jitter), and float64 doubled every pass over
        # the images — t_data was the train-step bottleneck (round-4 phase
        # split, docs/NOTES_ROUND4.md).
        left = instance["left_image"].astype(np.float32)
        right = instance["right_image"].astype(np.float32)
        disparity = instance["disparity"]
        mask = instance["disparity_mask"]
        raw_h, raw_w = left.shape[:2]
        tgt_w, tgt_h = instance["width"], instance["height"]
        rng = np.random.default_rng(instance["seed"])

        # 1. aspect-keeping resize (disparity scaled by width ratio). The
        # divisibility caps must be multiples of 16; aspect/area-sampled
        # targets are arbitrary, so round the caps up — the crop/pad step
        # below lands exactly on (tgt_h, tgt_w) either way.
        cap_h = ((tgt_h + 15) // 16) * 16
        cap_w = ((tgt_w + 15) // 16) * 16
        rh, rw = get_resize_keep_aspect_ratio(raw_h, raw_w, max_H=cap_h, max_W=cap_w)
        left = _resize(left, (rw, rh)).astype(np.float32)
        right = _resize(right, (rw, rh)).astype(np.float32)
        ratio = rw / raw_w
        disparity = _resize(disparity, (rw, rh), nearest=True) * ratio
        mask = _resize(mask.astype(np.uint8), (rw, rh), nearest=True) > 0

        # 2. center crop / zero pad to target
        if rh > tgt_h or rw > tgt_w:
            sy = (rh - tgt_h) // 2
            sx = (rw - tgt_w) // 2
            left = left[sy:sy + tgt_h, sx:sx + tgt_w]
            right = right[sy:sy + tgt_h, sx:sx + tgt_w]
            disparity = disparity[sy:sy + tgt_h, sx:sx + tgt_w]
            mask = mask[sy:sy + tgt_h, sx:sx + tgt_w]
        elif rh < tgt_h or rw < tgt_w:
            py, px = max(0, tgt_h - rh), max(0, tgt_w - rw)
            pt, pb = py // 2, py - py // 2
            pl, pr = px // 2, px - px // 2
            left = np.pad(left, ((pt, pb), (pl, pr), (0, 0)))
            right = np.pad(right, ((pt, pb), (pl, pr), (0, 0)))
            disparity = np.pad(disparity, ((pt, pb), (pl, pr)))
            mask = np.pad(mask, ((pt, pb), (pl, pr)))

        # 3. stereo-consistent flips
        if self.stereo_augmentation:
            if rng.choice([True, False]):
                lf = np.flip(left, axis=1).copy()
                rf = np.flip(right, axis=1).copy()
                left, right = rf, lf
                disparity = np.flip(disparity, axis=1).copy()
                mask = np.flip(mask, axis=1).copy()
            if rng.choice([True, False]):
                left = np.flip(left, axis=0).copy()
                right = np.flip(right, axis=0).copy()
                disparity = np.flip(disparity, axis=0).copy()
                mask = np.flip(mask, axis=0).copy()

        # 4. shared color jitter + rectification-error perturbation
        aug = self.datasets[instance["dataset"]].get("image_augmentation",
                                                     self.image_augmentation)
        if "jittering" in aug:
            bf = rng.uniform(0.8, 1.2)
            cf = rng.uniform(0.8, 1.2)
            sf = rng.uniform(0.0, 1.4)
            hf = rng.uniform(-0.05, 0.05)
            gf = rng.uniform(0.8, 1.2)
            for img_name in ("left", "right"):
                img = left if img_name == "left" else right
                img = adjust_brightness(img, bf)
                img = adjust_contrast(img, cf)
                img = adjust_saturation(img, sf)
                img = adjust_hue(img, hf)
                img = adjust_gamma(img, gf)
                if img_name == "left":
                    left = img
                else:
                    right = img
            if rng.choice([True, False], p=[0.3, 0.7]):
                tx = rng.uniform(-2.0, 2.0)
                ty = rng.uniform(-1.0, 1.0)
                angle = rng.uniform(-0.5, 0.5)
                if native.available():
                    right = native.warp_affine_reflect(
                        right.astype(np.float32), tx, ty, angle)
                else:
                    # numpy fallback builds float64 meshgrids — keep the
                    # pipeline float32 (native path already is).
                    right = warp_affine_reflect(right, tx, ty, angle).astype(
                        np.float32)

        # 5. disparity stretching
        if "disparity_stretching" in aug and rng.choice([True, False], p=[0.5, 0.5]):
            factor = rng.uniform(2.02, 2.04)
            h, w = left.shape[:2]
            nw = int(w * factor)
            left = _resize(left, (nw, h)).astype(np.float32)
            right = _resize(right, (nw, h)).astype(np.float32)
            disparity = _resize(disparity, (nw, h), nearest=True) * factor
            mask = _resize(mask.astype(np.uint8), (nw, h), nearest=True).astype(bool)
            sx = (nw - w) // 2
            left = left[:, sx:sx + w]
            right = right[:, sx:sx + w]
            disparity = disparity[:, sx:sx + w]
            mask = mask[:, sx:sx + w]

        # 6. clamp + empty-mask fallback
        disparity = np.clip(disparity, 0, self.max_disparity)
        if mask.sum() / mask.size < 0.001:
            mask = np.ones_like(mask)
            disparity = np.ones_like(disparity)
            instance["label_type"] = "invalid"

        instance.update({
            "left_image": (left / 255.0).astype(np.float32),
            "right_image": (right / 255.0).astype(np.float32),
            "disparity": disparity.astype(np.float32),
            "disparity_mask": mask.astype(bool),
        })
        return instance

    # -- batching ------------------------------------------------------------

    def _collate_batch(self, instances: List[dict]) -> Dict[str, Any]:
        batch = {k: np.stack([inst[k] for inst in instances], axis=0)
                 for k in ("left_image", "right_image", "disparity", "disparity_mask")}
        batch["label_type"] = [inst["label_type"] for inst in instances]
        batch["info"] = [{"dataset": i["dataset"], "filename": i["filename"]}
                         for i in instances]
        return batch

    def _produce_one(self) -> Dict[str, Any]:
        insts = self._sample_batch()
        insts = [self._process_instance(self._load_instance(i)) for i in insts]
        return self._collate_batch(insts)

    def get(self) -> Dict[str, Any]:
        if self._threads:
            return self._queue.get()
        return self._produce_one()

    # -- worker lifecycle ----------------------------------------------------

    def _worker(self):
        while not self._stop.is_set():
            batch = self._produce_one()
            while not self._stop.is_set():
                try:
                    self._queue.put(batch, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def start(self):
        if self._threads:
            return
        self._stop.clear()
        for i in range(self.num_workers):
            t = threading.Thread(target=self._worker, name=f"dataloader-{i}", daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self):
        self._stop.set()
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads = []

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        self.stop()
        return False


# Utility functions mirrored from train/dataloader.py:363-398.


def stereo_consistent_crop(left, right, disparity, mask, crop_h, crop_w, random_crop=True):
    h, w = left.shape[:2]
    if random_crop:
        sy = np.random.randint(0, max(1, h - crop_h + 1))
        sx = np.random.randint(0, max(1, w - crop_w + 1))
    else:
        sy = (h - crop_h) // 2
        sx = (w - crop_w) // 2
    sl = np.s_[sy:sy + crop_h, sx:sx + crop_w]
    return left[sl], right[sl], disparity[sl], mask[sl]


def stereo_consistent_resize(left, right, disparity, mask, th, tw):
    w = left.shape[1]
    ratio = tw / w
    left = _resize(left, (tw, th))
    right = _resize(right, (tw, th))
    disparity = _resize(disparity, (tw, th), nearest=True) * ratio
    mask = _resize(mask.astype(np.uint8), (tw, th), nearest=True) > 0
    return left, right, disparity, mask
