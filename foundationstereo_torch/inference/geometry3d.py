"""3D geometry + point-cloud output (open3d-free), numpy only.

The port's own copy of the JAX package's ``inference/geometry3d.py``
(the port imports nothing of that package). Covers the demo's postprocessing (scripts/run_demo.py:174-276):
occlusion removal, pinhole depth/xyz (Utils.py:56-75), equirectangular (ERP)
spherical triangulation, PLY export, and radius-outlier denoising (a numpy
voxel-hash neighbor count replacing open3d's remove_radius_outlier).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def remove_invisible(disp: np.ndarray) -> np.ndarray:
    """Mark pixels whose right-image correspondence x-d < 0 as inf
    (scripts/run_demo.py:174-178)."""
    disp = disp.copy()
    H, W = disp.shape
    xx = np.arange(W)[None, :].repeat(H, 0)
    disp[(xx - disp) < 0] = np.inf
    return disp


def depth_from_disparity(disp: np.ndarray, K: np.ndarray, baseline: float) -> np.ndarray:
    """Pinhole: depth = fx * B / disparity."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return K[0, 0] * baseline / disp


def depth2xyzmap(depth: np.ndarray, K: np.ndarray, zmin: float = 0.1) -> np.ndarray:
    """(H, W) depth -> (H, W, 3) camera-frame points (Utils.py:56-75)."""
    invalid = depth < zmin
    H, W = depth.shape[:2]
    vs, us = np.meshgrid(np.arange(H), np.arange(W), sparse=False, indexing="ij")
    zs = depth
    xs = (us - K[0, 2]) * zs / K[0, 0]
    ys = (vs - K[1, 2]) * zs / K[1, 1]
    xyz = np.stack([xs, ys, zs], axis=-1).astype(np.float32)
    xyz[invalid] = 0
    return xyz


def erp_pointcloud(disp: np.ndarray, baseline: float,
                   half_fov_lat_deg: float = 90.0,
                   half_fov_lon_deg: float = 180.0) -> np.ndarray:
    """Equirectangular (up/down) stereo triangulation
    (scripts/run_demo.py:181-219). Returns (H, W, 3) points."""
    H, W = disp.shape
    half_fov_lat = np.pi * half_fov_lat_deg / 180.0
    half_fov_lon = np.pi * half_fov_lon_deg / 180.0
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")

    sx_up = yy * 2 / H - 1
    sy_up = xx * 2 / W - 1
    lon_up = sx_up * half_fov_lon
    lat_up = sy_up * half_fov_lat

    us_right = xx - disp
    sy_down = us_right * 2 / W - 1
    lat_down = sy_down * half_fov_lat

    ang_disp = disp * 2 * half_fov_lon / W
    with np.errstate(divide="ignore", invalid="ignore"):
        tr = baseline * np.cos(lat_down) / np.sin(ang_disp)

    tx = np.sin(lat_up)
    tz = np.cos(lat_up) * np.sin(lon_up)
    ty = -np.cos(lat_up) * np.cos(lon_up)
    return np.stack([tx * tr, ty * tr, tz * tr], axis=-1)


def read_intrinsics(path: str | Path) -> tuple[np.ndarray, float]:
    """Parse the K.txt format: row-major 3x3 K, then baseline
    (assets/K.txt; scripts/run_demo.py:226-229)."""
    lines = Path(path).read_text().strip().splitlines()
    K = np.array(list(map(float, lines[0].split())), np.float32).reshape(3, 3)
    baseline = float(lines[1])
    return K, baseline


def write_ply(path: str | Path, points: np.ndarray, colors: np.ndarray | None = None):
    """Binary little-endian PLY writer (open3d write_point_cloud analog)."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    n = len(points)
    has_color = colors is not None
    if has_color:
        colors = np.asarray(colors).reshape(-1, 3)
        if colors.dtype != np.uint8:
            colors = (np.clip(colors, 0, 1) * 255).astype(np.uint8) \
                if colors.max() <= 1.0 else colors.astype(np.uint8)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if has_color:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if has_color:
            rec = np.zeros(n, dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
            rec["xyz"] = points
            rec["rgb"] = colors
            f.write(rec.tobytes())
        else:
            f.write(points.tobytes())


def read_ply(path: str | Path) -> tuple[np.ndarray, np.ndarray | None]:
    """Reader for the subset of PLY written by :func:`write_ply`."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode().strip()
            header.append(line)
            if line == "end_header":
                break
        n = int(next(l for l in header if l.startswith("element vertex")).split()[-1])
        has_color = any("uchar red" in l for l in header)
        if has_color:
            rec = np.frombuffer(f.read(), dtype=[("xyz", np.float32, 3),
                                                 ("rgb", np.uint8, 3)], count=n)
            return rec["xyz"].copy(), rec["rgb"].copy()
        pts = np.frombuffer(f.read(), dtype=np.float32, count=n * 3).reshape(n, 3)
        return pts.copy(), None


def radius_outlier_removal(points: np.ndarray, nb_points: int = 30,
                           radius: float = 0.03) -> np.ndarray:
    """Keep points with >= nb_points neighbors within `radius`.

    Voxel-hash approximation of open3d remove_radius_outlier
    (scripts/run_demo.py:270-275): counts neighbors in the 27 surrounding
    voxels of edge `radius`, an upper-bounded but tight approximation that
    avoids an O(N^2) search. Returns a boolean keep-mask.
    """
    pts = np.asarray(points)
    n = len(pts)
    if n == 0:
        return np.zeros(0, bool)
    keys = np.floor(pts / radius).astype(np.int64)
    # pack voxel coords into a single int key
    packed = (keys[:, 0] * 73856093) ^ (keys[:, 1] * 19349663) ^ (keys[:, 2] * 83492791)
    order = np.argsort(packed)
    sorted_keys = packed[order]
    uniq, start, counts = np.unique(sorted_keys, return_index=True, return_counts=True)
    cell_count = dict(zip(uniq.tolist(), counts.tolist()))

    neighbor_counts = np.zeros(n, np.int64)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                nk = ((keys[:, 0] + dx) * 73856093) ^ ((keys[:, 1] + dy) * 19349663) \
                    ^ ((keys[:, 2] + dz) * 83492791)
                idx = np.searchsorted(uniq, nk)
                idx_c = np.clip(idx, 0, len(uniq) - 1)
                hit = uniq[idx_c] == nk
                neighbor_counts += np.where(hit, counts[idx_c], 0)
    return neighbor_counts >= nb_points
