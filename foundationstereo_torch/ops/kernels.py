"""The port's hand-written CUDA kernels: build, load, wrappers, launch counts.

Five CUDA C++ sources under ``foundationstereo_torch/csrc``, eight wrappers:

=========================  =======================  ====================================================
wrapper                    source                   TPU kernel it replaces
=========================  =======================  ====================================================
cost_volume_parts          csrc/cost_volume.cu      ops/pallas_kernels.py:build_cost_volume_pallas (K1)
cost_volume_parts_haloed   csrc/cost_volume.cu      ops/pallas_kernels.py:build_cost_volume_pallas_sharded
                                                    (_cost_volume_row_kernel_haloed, K5 build)
disparity_lookup           csrc/lookup.cu           ops/pallas_kernels.py:lookup_level_pallas (K2)
disparity_lookup_shard     csrc/lookup.cu           ops/pallas_kernels.py:disparity_lookup_pallas_sharded
                                                    (K5 lookup)
flash_attention            csrc/flash_attention.cu  models/dinov2.py:flash_vit_attention (K3)
flash_attention_heads      csrc/flash_attention.cu  models/dinov2.py:flash_vit_attention_sharded (K3s)
conv3x3                    csrc/conv3x3.cu          ops/conv3x3.py:conv3x3_pallas (K4)
conv3d_1out                csrc/conv3d_1out.cu      none: the JAX package leaves the classifier's last
                                                    conv (C -> 1, 7x7x7) to XLA (K6)
=========================  =======================  ====================================================

The ``_haloed``, ``_shard`` and ``_heads`` wrappers each run one shard of
the multi-device path (``ops/sharded.py`` runs them over a mesh).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface and loaded with ``ctypes``. The build runs at the first
CUDA call (all sources at once, one ``nvcc`` each, in parallel) into
``foundationstereo_torch/_build/``; a library's file name carries the hash of
its source, so an edited source is rebuilt. A failed build or load raises.

Each wrapper is an operator of the ``fs`` namespace (``torch.ops.fs.<name>``,
defined with ``torch.library.Library``; the module's names are their
``.default`` overloads), so the dispatcher picks the kernel by the tensors'
device and ``torch.export`` keeps each call as one opaque node. Its CPU
kernel runs the plain PyTorch twin; its CUDA kernel launches the
hand-written kernel on the tensors' device, under its device guard and on
its current stream (and adds one to ``LAUNCHES[name]``), or raises; its
shape function gives the outputs' shapes and dtypes from the inputs'
(the batch stays symbolic under export). The operators have no backward
(nor do the JAX package's Pallas kernels: its training takes the XLA
forms): given a tensor that requires grad while grad is enabled, each
raises, on either device; the model's differentiable route calls the
twins directly (``models/foundation_stereo.py:kernel_mode``).

Each C entry point reports the grid it launched (``COST_VOLUME_LAUNCHED``,
``LOOKUP_LAUNCHED``, ``FLASH_ATTENTION_LAUNCHED``, ``CONV3X3_LAUNCHED``,
``CONV3D_1OUT_LAUNCHED``); ``cost_volume_grid``, ``lookup_grid``,
``flash_attention_blocks``, ``conv3x3_blocks`` and ``conv3d_1out_grid`` give
the same from the shapes, for the checks.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch
import torch.nn.functional as F

from foundationstereo_torch.ops.cost_volume import cost_volume_parts as cost_volume_parts_plain
from foundationstereo_torch.ops.cost_volume import (
    cost_volume_parts_haloed as cost_volume_parts_haloed_plain,
)
from foundationstereo_torch.ops.sampler import disparity_lookup as disparity_lookup_plain

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = {
    "cost_volume_parts": "cost_volume.cu",
    "disparity_lookup": "lookup.cu",
    "flash_attention": "flash_attention.cu",
    "conv3x3": "conv3x3.cu",
    "conv3d_1out": "conv3d_1out.cu",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry point fs_<name> -> (the source whose library holds it, its argument types)
ENTRY_POINTS = {
    "cost_volume_parts_haloed": ("cost_volume_parts", [_P] * 5 + [_I] * 12 + [_P, _P]),
    "disparity_lookup": ("disparity_lookup", [_P] * 4 + [_I, _P, _P] + [_I] * 8 + [_P, _P]),
    "flash_attention": ("flash_attention", [_P, _P] + [_I] * 5 + [ctypes.c_float, _I, _P, _P]),
    "conv3x3": ("conv3x3", [_P, _P, _P, _P, _I, _I] + [_L] * 6 + [_I] * 9 + [_P, _P]),
    "conv3d_1out": ("conv3d_1out", [_P] * 4 + [_I] * 5 + [_L] * 4 + [_I] * 5 + [_P, _P]),
}

# Launches per wrapper since the last reset_launches(); counted only where a
# wrapper launches its kernel.
LAUNCHES = {name: 0 for name in ("cost_volume_parts", "cost_volume_parts_haloed",
                                 "disparity_lookup", "disparity_lookup_shard",
                                 "flash_attention", "flash_attention_heads", "conv3x3",
                                 "conv3d_1out")}

# The last cost-volume launch (K1 or K5's build) as its C entry point made
# it: the grid (x, y, z) and a block's tile (threads, columns, disparities).
COST_VOLUME_LAUNCHED: dict = {}
# The last lookup launch (K2 or K5's lookup) as its C entry point made it:
# the grid (x, y, z) and a block's tile (threads, pixels per thread, radius).
LOOKUP_LAUNCHED: dict = {}
# The last conv3x3 launch as its C entry point made it: the grid (x, y, z)
# and a block's tile (output rows, columns, channels).
CONV3X3_LAUNCHED: dict = {}
# The last flash-attention launch (K3 or K3s) as its C entry point made it:
# the grid (x, y, z) and a block's tile (query rows, keys per tile, threads).
FLASH_ATTENTION_LAUNCHED: dict = {}
# The last conv3d_1out launch as its C entry point made it: the grid (x, y,
# z), the threads per block and a block's output tile (depths, rows, columns).
CONV3D_1OUT_LAUNCHED: dict = {}

_fns: dict = {}   # name -> the loaded C entry point fs_<name>
_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(source: str) -> Path:
    """The library's path, named by the hash of its source, the headers
    beside it and the flags."""
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256((CSRC / source).read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build_all(verbose: bool = False) -> dict[str, Path]:
    """Compile every kernel source whose library is missing, one ``nvcc``
    process per source, all started together. Returns {name: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(src) for name, src in SOURCES.items()}
    procs = []
    for name, src in SOURCES.items():
        if paths[name].exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, str(CSRC / src)]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        if verbose and log:
            print(f"[nvcc {SOURCES[name]}]\n{log}", flush=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{SOURCES[name]}:\n{log}")
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def _lib(name: str):
    """The C entry point ``fs_<name>``, building and loading every library
    at the first call."""
    with _lock:
        if name not in _fns:
            libs = {n: ctypes.CDLL(str(p)) for n, p in build_all().items()}
            for entry, (src, argtypes) in ENTRY_POINTS.items():
                fn = getattr(libs[src], f"fs_{entry}")
                fn.restype = ctypes.c_int
                fn.argtypes = argtypes
                _fns[entry] = fn
        return _fns[name]


def _check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _launch(name: str, entry: str, device: torch.device, *args) -> None:
    """Call ``fs_<entry>(*args, stream)`` on ``device``: under its device
    guard, on its current stream. Counts one launch of ``name`` or raises."""
    fn = _lib(entry)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    _check(name, err)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _forward_only(name: str, *tensors: torch.Tensor | None) -> None:
    """The kernels have no backward: refuse a tensor that requires grad
    while grad is enabled, rather than return an output with no
    ``grad_fn``."""
    _require(not (torch.is_grad_enabled()
                  and any(t is not None and t.requires_grad for t in tensors)),
             f"{name} has no backward: call it under torch.no_grad() or on tensors "
             "that do not require grad")


def _one_device(*tensors: torch.Tensor) -> None:
    devs = {t.device for t in tensors}
    _require(len(devs) == 1, f"tensors on mixed devices {devs}")


_FLOATS = (torch.float32, torch.bfloat16)


# ---------------------------------------------------------------------------
# K1: cost-volume parts
# ---------------------------------------------------------------------------


def _cost_volume_parts_cuda(left, right, right_proj, maxdisp, num_groups,
                            out_dtype=torch.float32):
    """left/right (B, C, H, W), right_proj (B, P, H, W) -> gwc (B, G, D, H, W),
    rps (B, P, D, H, W) in ``out_dtype``; see ``ops.cost_volume.cost_volume_parts``."""
    return _cost_volume(left, right, right_proj, maxdisp, num_groups, out_dtype, None)


def _cost_volume_parts_haloed_cuda(left, right, right_proj, maxdisp, num_groups, x_offset,
                                   out_dtype=torch.float32):
    """One width shard (K5's build): left (B, C, H, W_local), the global
    columns [x_offset, x_offset + W_local); right (B, C, H, W) and
    right_proj (B, P, H, W) full width -> gwc (B, G, D, H, W_local), rps
    (B, P, D, H, W_local); see ``ops.cost_volume.cost_volume_parts_haloed``."""
    return _cost_volume(left, right, right_proj, maxdisp, num_groups, out_dtype, x_offset)


def _cost_volume_parts_fake(left, right, right_proj, maxdisp, num_groups,
                            out_dtype=torch.float32):
    b, _, h, w = left.shape
    return (left.new_empty((b, num_groups, maxdisp, h, w), dtype=out_dtype),
            left.new_empty((b, right_proj.shape[1], maxdisp, h, w), dtype=out_dtype))


# The cost-volume kernel's thread tile (output columns x disparities), the
# widest block tile it aims at (columns) and its most threads per block.
CV_TILE_W, CV_TILE_D, CV_MAX_COLUMNS, CV_MAX_THREADS = 8, 8, 80, 160


def cost_volume_tile(w: int, d: int) -> int:
    """nwt, the cost-volume kernel's block tile in 8-column thread tiles:
    W cut into the fewest tiles of at most CV_MAX_COLUMNS columns, each
    rounded up to a multiple of 8 (4 x 80 at W = 320, 1 x 80 at a shard's
    80; 80 ran faster than 40 and 160 at W = 320 on the H100), narrowed
    while nwt x ceil(D / 8) thread tiles exceed a block."""
    ndt = -(-d // CV_TILE_D)
    tiles = -(-w // CV_MAX_COLUMNS)
    while True:
        nwt = -(-(-(-w // tiles)) // CV_TILE_W)
        if nwt * ndt <= CV_MAX_THREADS or nwt == 1:
            return nwt
        tiles += 1


def cost_volume_grid(b: int, h: int, w: int, d: int, groups: int, p: int) -> tuple:
    """The cost-volume kernel's launch: ((w tiles, G + P, B * H), threads).
    Block (x, y, z) serves row z's columns [x * 8 nwt, (x + 1) * 8 nwt) of
    group y (y < G) or projection channel y - G; in a group block, thread t
    < nwt * ceil(D / 8) owns the 8 columns 8 (t % nwt) + [0, 8) of the tile
    and the 8 disparities 8 (t // nwt) + [0, 8), those inside W and D."""
    nwt = cost_volume_tile(w, d)
    items = nwt * -(-d // CV_TILE_D)
    return (-(-w // (CV_TILE_W * nwt)), groups + p, b * h), -(-items // 32) * 32


def _cost_volume(left, right, right_proj, maxdisp, num_groups, out_dtype, x_offset):
    _forward_only("the cost-volume kernel", left, right, right_proj)
    _one_device(left, right, right_proj)
    b, c, h, w = left.shape
    wr = right.shape[-1]
    p = right_proj.shape[1]
    x0 = 0 if x_offset is None else int(x_offset)
    _require(right.shape == (b, c, h, wr) and right_proj.shape == (b, p, h, wr)
             and (wr == w if x_offset is None else 0 <= x0 and x0 + w <= wr),
             f"shapes {tuple(left.shape)} {tuple(right.shape)} {tuple(right_proj.shape)}, "
             f"x_offset {x_offset}")
    _require(left.dtype == right.dtype == right_proj.dtype and left.dtype in _FLOATS,
             "inputs must share one dtype, float32 or bfloat16")
    _require(out_dtype in _FLOATS, f"out_dtype {out_dtype}")
    _require(c % num_groups == 0 and c // num_groups <= 32, f"C={c}, groups={num_groups}")
    _require(maxdisp >= 1 and b * h <= 65535, f"maxdisp {maxdisp}, {b * h} rows")
    nwt = cost_volume_tile(w, maxdisp)
    ndt = -(-maxdisp // CV_TILE_D)
    _require(nwt * ndt <= CV_MAX_THREADS, f"maxdisp {maxdisp}: too many disparity tiles")
    smem = c // num_groups * (CV_TILE_D * ndt + 2 * CV_TILE_W * nwt) * 4
    _require(smem <= 232448, f"a block's rows ({smem} bytes) exceed shared memory")
    _require(all(t.is_contiguous() for t in (left, right, right_proj)),
             "inputs must be contiguous")
    gwc = torch.empty((b, num_groups, maxdisp, h, w), device=left.device, dtype=out_dtype)
    rps = torch.empty((b, p, maxdisp, h, w), device=left.device, dtype=out_dtype)
    name = "cost_volume_parts" if x_offset is None else "cost_volume_parts_haloed"
    launched = (ctypes.c_int * 6)()
    _launch(name, "cost_volume_parts_haloed", left.device,
            left.data_ptr(), right.data_ptr(), right_proj.data_ptr(), gwc.data_ptr(),
            rps.data_ptr(), b, c, h, w, wr, x0, num_groups, p, maxdisp, nwt,
            int(left.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16), launched)
    COST_VOLUME_LAUNCHED.update(grid=tuple(launched[:3]), tile=tuple(launched[3:]))
    return gwc, rps


# ---------------------------------------------------------------------------
# K2: disparity lookup, all levels in one launch
# ---------------------------------------------------------------------------


def _disparity_lookup_cuda(geo_pyramid, corr_pyramid, disp, radius, out_dtype=torch.float32):
    """geo levels (B, H, W, C, D_l), corr levels (B, H, W, W_l), disp (B, H, W)
    -> (B, L*(C+1)*(2r+1), H, W); see ``ops.sampler.disparity_lookup``."""
    return _lookup("disparity_lookup", geo_pyramid, corr_pyramid, disp, radius, out_dtype, 0)


def _disparity_lookup_shard_cuda(geo_pyramid, corr_pyramid, disp, radius, x_offset,
                                 out_dtype=torch.float32):
    """One width shard (K5's lookup): the W_local left columns from global
    column ``x_offset`` on -- geo levels (B, H, W_local, C, D_l), corr levels
    (B, H, W_local, W_l) with the full right axis, disp (B, H, W_local) ->
    (B, F, H, W_local); see ``ops.sampler.disparity_lookup``."""
    return _lookup("disparity_lookup_shard", geo_pyramid, corr_pyramid, disp, radius, out_dtype,
                   x_offset)


def _disparity_lookup_fake(geo_pyramid, corr_pyramid, disp, radius, out_dtype=torch.float32):
    b, h, w = disp.shape
    f = len(geo_pyramid) * (geo_pyramid[0].shape[3] + 1) * (2 * radius + 1)
    return disp.new_empty((b, f, h, w), dtype=out_dtype)


# The lookup kernel's block: threads, each serving this many adjacent
# pixels (flattened over H x W) of one (level, channel) item. Radius 4 has
# an instantiation of its own; any other radius runs the generic one.
LOOKUP_THREADS, LOOKUP_PIXELS = 128, 2


def lookup_grid(b: int, h: int, w: int, levels: int, c: int) -> tuple[int, int, int]:
    """The lookup kernel's grid: (levels x (C + 1) items, pixel pairs /
    threads, B). Thread t of block (item, y, b) serves the pixels q0 and
    q0 + 1 (those below H * W) of image b, q0 = (y * LOOKUP_THREADS + t) *
    LOOKUP_PIXELS, flattened over (H, W), and stores the 2r + 1 taps of its
    item at each."""
    pairs = -(-(h * w) // LOOKUP_PIXELS)
    return levels * (c + 1), -(-pairs // LOOKUP_THREADS), b


def _lookup(name, geo_pyramid, corr_pyramid, disp, radius, out_dtype, x_offset):
    _forward_only(name, disp, *geo_pyramid, *corr_pyramid)
    _one_device(disp, *geo_pyramid, *corr_pyramid)
    b, h, w = disp.shape
    n = len(geo_pyramid)
    c = geo_pyramid[0].shape[3]
    in_dtype = geo_pyramid[0].dtype
    _require(1 <= n <= 8 and len(corr_pyramid) == n,
             f"{n} geometry / {len(corr_pyramid)} corr levels")
    _require(radius >= 0, f"radius {radius}")
    _require(disp.dtype == torch.float32 and disp.is_contiguous(),
             "disp must be contiguous float32")
    _require(in_dtype in _FLOATS and out_dtype in _FLOATS, f"dtypes {in_dtype} -> {out_dtype}")
    for g, cr in zip(geo_pyramid, corr_pyramid):
        _require(g.shape[:4] == (b, h, w, c) and cr.shape[:3] == (b, h, w)
                 and g.ndim == 5 and cr.ndim == 4,
                 f"pyramid level shapes {tuple(g.shape)} {tuple(cr.shape)}")
        _require(g.dtype == cr.dtype == in_dtype and g.is_contiguous() and cr.is_contiguous(),
                 "pyramid levels must be contiguous and share one dtype")
    f = n * (c + 1) * (2 * radius + 1)
    out = torch.empty((b, f, h, w), device=disp.device, dtype=out_dtype)
    ptrs = (ctypes.c_void_p * n)
    lens = (ctypes.c_int * n)
    launched = (ctypes.c_int * 6)()
    _launch(name, "disparity_lookup", disp.device,
            ptrs(*[g.data_ptr() for g in geo_pyramid]), ptrs(*[cr.data_ptr() for cr in corr_pyramid]),
            lens(*[g.shape[4] for g in geo_pyramid]), lens(*[cr.shape[3] for cr in corr_pyramid]),
            n, disp.data_ptr(), out.data_ptr(), b, h, w, c, radius, int(x_offset),
            int(in_dtype == torch.bfloat16), int(out_dtype == torch.bfloat16), launched)
    LOOKUP_LAUNCHED.update(grid=tuple(launched[:3]), tile=tuple(launched[3:]))
    return out


# ---------------------------------------------------------------------------
# K3: ViT flash attention
# ---------------------------------------------------------------------------


def flash_attention_plain(qkv: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain twin of the flash-attention kernel: qkv (B, N, 3, H, Dh) ->
    (B, N, H, Dh) in qkv's dtype, dense softmax in fp32."""
    q, k, v = qkv.unbind(2)
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", w, v.float()).to(qkv.dtype)


def _flash_attention_cuda(qkv, scale):
    """Softmax attention from the packed projection qkv (B, N, 3, H, 64) ->
    (B, N, H, 64) in qkv's dtype: bfloat16 products in one tensor-core pass,
    float32 in three TF32 passes. Forward only, as the JAX package runs it
    (the frozen ViT)."""
    return _attention("flash_attention", qkv, scale, 0, qkv.shape[3])


def _flash_attention_heads_cuda(qkv, scale, h0, n_heads):
    """One head shard (K3s): attention over the heads [h0, h0 + n_heads) of
    qkv (B, N, 3, H, 64), read in place -> (B, N, n_heads, 64)."""
    return _attention("flash_attention_heads", qkv, scale, h0, n_heads)


def _flash_attention_heads_plain(qkv, scale, h0, n_heads):
    return flash_attention_plain(qkv[:, :, :, h0:h0 + n_heads], scale)


def _flash_attention_heads_fake(qkv, scale, h0, n_heads):
    b, n, _, _, hd = qkv.shape
    return qkv.new_empty((b, n, n_heads, hd))


# Query rows per block: 3 consumer warpgroups of 64 (bf16), 2 (fp32).
FLASH_QUERY_ROWS = 192
FLASH_QUERY_ROWS_FP32 = 128


def flash_attention_blocks(n: int, pairs: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """The kernel's grid size for N tokens of ``pairs`` (batch, head) pairs:
    query tiles of ``FLASH_QUERY_ROWS`` (bf16) or ``FLASH_QUERY_ROWS_FP32``
    (fp32) rows x pairs."""
    rows = FLASH_QUERY_ROWS if dtype == torch.bfloat16 else FLASH_QUERY_ROWS_FP32
    return -(-n // rows) * pairs


def _attention(name, qkv, scale, h0, n_heads):
    _forward_only(name, qkv)
    b, n, three, heads, hd = qkv.shape
    _require(three == 3 and hd == 64, f"qkv shape {tuple(qkv.shape)}: want (B, N, 3, H, 64)")
    _require(qkv.dtype in _FLOATS and qkv.is_contiguous() and qkv.data_ptr() % 16 == 0,
             "qkv must be contiguous, 16-byte aligned float32 or bfloat16")
    _require(0 <= h0 and 1 <= n_heads and h0 + n_heads <= heads,
             f"heads [{h0}, {h0 + n_heads}) of {heads}")
    bf16 = qkv.dtype == torch.bfloat16
    _require(scale > 0 or not bf16, f"scale {scale}: the bf16 kernel takes a positive scale")
    out = torch.empty((b, n, n_heads, hd), device=qkv.device, dtype=qkv.dtype)
    launched = (ctypes.c_int * 6)()
    _launch(name, "flash_attention", qkv.device, qkv.data_ptr(), out.data_ptr(), b, n, n_heads,
            heads, h0, float(scale), int(bf16), launched)
    FLASH_ATTENTION_LAUNCHED.update(grid=tuple(launched[:3]), tile=tuple(launched[3:]))
    return out


# ---------------------------------------------------------------------------
# K4: 3x3 convolution, stride 1, zero padding 1
# ---------------------------------------------------------------------------


def conv3x3_plain(x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain twin of the 3x3 conv kernel, the TPU kernel's own math: the sum
    of 9 shifted (C -> F) contractions with fp32 accumulation (the weight
    taken in x's dtype, products exact in fp32), ``bias`` added in fp32, one
    rounding to x's dtype. x (N, C, H, W) or (B, C, D, H, W)."""
    h, w = x.shape[-2:]
    xp = F.pad(x, (1, 1, 1, 1)).float()
    wf = weight.to(x.dtype).float()
    acc = None
    for dy in range(3):
        for dx in range(3):
            term = torch.einsum("nc...,fc->nf...", xp[..., dy:dy + h, dx:dx + w], wf[:, :, dy, dx])
            acc = term if acc is None else acc + term
    if bias is not None:
        acc = acc + bias.float().reshape((-1,) + (1,) * (x.ndim - 2))
    return acc.to(x.dtype)


def _pack_rows(f: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Output channels per packed weight tile: 64 where F <= 64, else 128;
    float32 also 64 where 64-channel tiles pad F to fewer channels (F = 168:
    192 against 256; on the H100 the fp32 hourglass conv ran 0.116 ms
    against 0.160 with 128, ``tools/k4_timing.py``)."""
    if f <= 64 or (dtype != torch.bfloat16 and -(-f // 64) * 64 < -(-f // 128) * 128):
        return 64
    return 128


def _packed_shape(f: int, c: int, dtype: torch.dtype) -> tuple[int, ...]:
    t = _pack_rows(f, dtype)
    if dtype == torch.bfloat16:
        return (-(-f // t), -(-c // 64), 9, t, 64)
    return (-(-f // t), -(-c // 16), 9, 2, 4, t, 4)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 x -> (hi, lo), fp32 tensors holding TF32 values: hi = tf32(x),
    lo = tf32(x - hi), each rounded to nearest with ties away from zero
    (``cvt.rna.tf32.f32``), by bit arithmetic on the int32 view."""
    def rna(v):
        return ((v.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(x.float())
    return hi, rna(x.float() - hi)


def pack_conv3x3_weight(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(F, C, 3, 3) -> the kernel's weight layout in ``dtype``, zero-padded.
    Callers cache it (a parameter is packed once). T = ``_pack_rows(F,
    dtype)`` output channels per tile (64 or 128); Fp is F padded to a
    multiple of T.

    bfloat16: (Fp / T, Cp / 64, 9, T, 64), Cp = C padded to a multiple of
    64. Entry [m, k, tap] is the tile of output channels m*T..m*T+T-1,
    input channels k*64..k*64+63 and tap dy*3+dx, contiguous (16 KB at T =
    128), in the exact shared-memory image wgmma's B descriptor reads:
    K-major (row n holds the tile's 64 input channels, 128 bytes) with the
    128-byte swizzle (the 16-byte group of channels 8q..8q+7 of row n sits at
    group position q ^ (n % 8)).

    float32: (Fp / T, Cp / 16, 9, 2, 4, T, 4), Cp = C padded to a multiple of
    16. Entry [m, k, tap, h] is the (chunk, tap) tile's hi (h = 0) or lo (h =
    1) part (``tf32_split``) as the B descriptor of the three-pass TF32 wgmma
    reads it, K-major without swizzle: [4-channel group q][row n][4
    channels], element [q, n, e] the weight of output channel m*T + n and
    input channel k*16 + 4q + e; hi and lo together (16 KB at T = 128) are
    one bulk copy.
    """
    f, c = weight.shape[:2]
    shape = _packed_shape(f, c, dtype)
    nf, nc, t = shape[0], shape[1], _pack_rows(f, dtype)
    kc = 64 if dtype == torch.bfloat16 else 16
    padded = torch.zeros((nf * t, nc * kc, 3, 3), device=weight.device, dtype=dtype)
    padded[:f, :c] = weight.detach().to(dtype)
    if dtype != torch.bfloat16:
        # (Fp/T, T, Cp/16, 4 groups, 4, 9 taps) -> (Fp/T, Cp/16, 9, 4 groups, T, 4)
        tiles = padded.reshape(nf, t, nc, 4, 4, 9).permute(0, 2, 5, 3, 1, 4)
        return torch.stack(tf32_split(tiles), dim=3).contiguous()
    # (Fp/T, T, Cp/64, 8 groups, 8, 9 taps) -> (Fp/T, Cp/64, 9, T, 8 groups, 8)
    tiles = padded.reshape(nf, t, nc, 8, 8, 9).permute(0, 2, 5, 1, 3, 4)
    n = torch.arange(t, device=weight.device)[:, None]
    q = torch.arange(8, device=weight.device)[None, :]
    return tiles[:, :, :, n, q ^ (n % 8)].reshape(shape).contiguous()


def conv3x3_rows(f: int, h: int, w: int, images: int, sms: int,
                 dtype: torch.dtype = torch.bfloat16) -> int:
    """R, the output rows per consumer warpgroup (a block is 2R rows x 64
    columns x BN output channels, BN the packed tile's rows), for F output
    channels of ``images`` HxW images on a card with ``sms`` SMs (one block
    per SM at a time).

    float32: R = 128 / BN, fixed: a warpgroup's total and partial
    accumulators (64 pixels x 128 channels, 128 registers) fill its
    registers. bfloat16: the R with the fewer waves x (BN x R + 96), a
    wave's time in units of one 64-pixel row of one channel plus a block's
    fixed cost (the first patch load, the pipeline's fill, the epilogue).
    The 96 is fitted to the card: R = 2 won at 92x160 (3 waves against 5)
    and R = 1 at 13 x 23x40 (3 against 2); ``tools/k4_timing.py`` times
    both R at the main path's shapes. Ties go to R = 2, which reads fewer
    bytes per FLOP."""
    bn = _pack_rows(f, dtype)
    if dtype != torch.bfloat16:
        return 128 // bn

    def cost(rows):
        return -(-conv3x3_blocks(f, h, w, images, rows) // sms) * (bn * rows + 96)

    return 2 if cost(2) <= cost(1) else 1


def conv3x3_blocks(f: int, h: int, w: int, images: int, rows: int,
                   dtype: torch.dtype = torch.bfloat16) -> int:
    """The kernel's grid size: N blocks x pixel tiles (2R rows x 64 columns)
    x images."""
    return -(-f // _pack_rows(f, dtype)) * -(-h // (2 * rows)) * -(-w // 64) * images


_sms: dict = {}


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sms[index]


def _conv3x3_cuda(x, weight, bias=None, packed=None):
    """3x3 / stride 1 / zero padding 1 convolution with fp32 accumulation.

    x (N, C, H, W), or (B, C, D, H, W) with D taken as a batch axis (read
    in place through its strides); weight (F, C, 3, 3); bias (F,) or None,
    added in fp32 before the one rounding. Returns (N, F, H, W) or (B, F, D,
    H, W) in x's dtype, float32 or bfloat16. ``packed`` is
    ``pack_conv3x3_weight(weight, x.dtype)``, made here when not given.
    Both types run a wgmma kernel with the rows ``conv3x3_rows`` picks:
    bfloat16 products in one pass, float32 in three TF32 passes.
    """
    _forward_only("conv3x3", x, weight, bias)
    _one_device(x, weight)
    _require(x.ndim in (4, 5), f"x shape {tuple(x.shape)}: want (N, C, H, W) or (B, C, D, H, W)")
    _require(x.dtype in _FLOATS, "x must be float32 or bfloat16")
    f, c = weight.shape[:2]
    h, w = x.shape[-2:]
    _require(tuple(weight.shape) == (f, x.shape[1], 3, 3),
             f"weight {tuple(weight.shape)} for x {tuple(x.shape)}")
    _require(x.stride(-1) == 1 and x.stride(-2) == w, "x's (H, W) plane must be contiguous")
    if x.ndim == 4:
        n_outer, n_inner, xsi = x.shape[0], 1, 0
        out = torch.empty((n_outer, f, h, w), device=x.device, dtype=x.dtype)
        osi = 0
    else:
        n_outer, n_inner, xsi = x.shape[0], x.shape[2], x.stride(2)
        out = torch.empty((n_outer, f, n_inner, h, w), device=x.device, dtype=x.dtype)
        osi = out.stride(2)
    _require(0 < n_outer * n_inner <= 65535, f"{n_outer * n_inner} images: at most 65535")
    if packed is None:
        packed = pack_conv3x3_weight(weight, x.dtype)
    _require(tuple(packed.shape) == _packed_shape(f, c, x.dtype)
             and packed.dtype == x.dtype and packed.is_contiguous()
             and packed.data_ptr() % 16 == 0 and packed.device == x.device,
             "packed must be pack_conv3x3_weight(weight, x.dtype) on x's device")
    if bias is not None:
        _require(bias.shape == (f,) and bias.device == x.device, f"bias {tuple(bias.shape)}")
        bias = bias.float().contiguous()
    bf16 = x.dtype == torch.bfloat16
    pack_n = packed.shape[3] if bf16 else packed.shape[5]
    fp, cp = packed.shape[0] * pack_n, packed.shape[1] * (64 if bf16 else 16)
    rows = conv3x3_rows(f, h, w, n_outer * n_inner, _sm_count(x.device), x.dtype)
    launched = (ctypes.c_int * 6)()
    _launch("conv3x3", "conv3x3", x.device,
            x.data_ptr(), packed.data_ptr(), 0 if bias is None else bias.data_ptr(), out.data_ptr(),
            n_outer, n_inner, x.stride(0), xsi, x.stride(1), out.stride(0), osi, out.stride(1),
            c, h, w, f, cp, fp, pack_n, rows, int(bf16), launched)
    CONV3X3_LAUNCHED.update(grid=tuple(launched[:3]), tile=tuple(launched[3:]))
    return out


def _conv3x3_plain_op(x, weight, bias=None, packed=None):
    return conv3x3_plain(x, weight, bias)


def _conv3x3_fake(x, weight, bias=None, packed=None):
    return x.new_empty((x.shape[0], weight.shape[0]) + tuple(x.shape[2:]))


# ---------------------------------------------------------------------------
# K6: 3D convolution to one output channel, stride 1
# ---------------------------------------------------------------------------


def conv3d_1out_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                      padding) -> torch.Tensor:
    """Plain twin of the one-channel 3D conv kernel: ``F.conv3d`` in fp32 on
    the operands rounded to the weight's dtype (the compute dtype), rounded
    once to it. x (B, C, D, H, W), weight (1, C, K, K, K), bias (1,) or None
    -> (B, D_out, H_out, W_out)."""
    dt = weight.dtype
    b = None if bias is None else bias.float()
    return F.conv3d(x.to(dt).float(), weight.float(), b, padding=tuple(padding))[:, 0].to(dt)


def _conv3d_1out_shape(x, weight, padding) -> tuple:
    k = weight.shape[-1]
    return (x.shape[0],) + tuple(n + 2 * p - k + 1 for n, p in zip(x.shape[2:], padding))


def _conv3d_1out_fake(x, weight, bias, padding):
    return x.new_empty(_conv3d_1out_shape(x, weight, padding), dtype=weight.dtype)


# The kernel's output tile per block (depths, rows, columns), and the kernel
# sizes it has an instantiation for.
CONV3D_1OUT_TILE, CONV3D_1OUT_SIZES = (8, 16, 64), (3, 5, 7)


def conv3d_1out_grid(b: int, d: int, h: int, w: int) -> tuple[int, int, int]:
    """The kernel's grid for (B, D, H, W) outputs: (column tiles, row tiles,
    depth tiles x B)."""
    td, th, tw = CONV3D_1OUT_TILE
    return -(-w // tw), -(-h // th), -(-d // td) * b


def _conv3d_1out_cuda(x, weight, bias, padding):
    """Stride-1 3D convolution to one output channel with fp32 products and
    sums: x (B, C, D, H, W) in float32 with unit stride along W (read in
    place through its other strides, rounded to the weight's dtype as it is
    loaded); weight (1, C, K, K, K) with K 3, 5 or 7 and bias (1,)
    or None in the compute dtype, float32 or bfloat16; zero padding (pd, ph,
    pw). Returns (B, D_out, H_out, W_out) in the weight's dtype, the
    classifier's ``conv(x)[:, 0]``."""
    _forward_only("conv3d_1out", x, weight, bias)
    _one_device(x, weight, *([] if bias is None else [bias]))
    _require(x.ndim == 5 and x.dtype == torch.float32 and x.stride(-1) == 1,
             f"x {tuple(x.shape)} {x.dtype}: want (B, C, D, H, W), float32, unit stride along W")
    c, k = x.shape[1], weight.shape[-1]
    _require(tuple(weight.shape) == (1, c, k, k, k) and k in CONV3D_1OUT_SIZES
             and weight.dtype in _FLOATS,
             f"weight {tuple(weight.shape)} {weight.dtype}: want (1, {c}, K, K, K), K in "
             f"{CONV3D_1OUT_SIZES}, float32 or bfloat16")
    _require(bias is None or (tuple(bias.shape) == (1,) and bias.dtype == weight.dtype),
             "bias must be (1,) in the weight's dtype")
    _require(len(padding) == 3 and all(0 <= p < k for p in padding), f"padding {padding}")
    shape = _conv3d_1out_shape(x, weight, padding)
    _require(min(shape) >= 1, f"no output: {shape}")
    gx, gy, gz = conv3d_1out_grid(*shape)
    _require(gy <= 65535 and gz <= 65535, f"grid {(gx, gy, gz)}: at most 65535 along y and z")
    weight = weight.contiguous()
    out = torch.empty(shape, device=x.device, dtype=weight.dtype)
    launched = (ctypes.c_int * 7)()
    _launch("conv3d_1out", "conv3d_1out", x.device,
            x.data_ptr(), weight.data_ptr(), 0 if bias is None else bias.data_ptr(),
            out.data_ptr(), x.shape[0], c, *x.shape[2:], *x.stride()[:4], k, *padding,
            int(weight.dtype == torch.bfloat16), launched)
    CONV3D_1OUT_LAUNCHED.update(grid=tuple(launched[:3]), threads=launched[3],
                                tile=tuple(launched[4:]))
    return out


# ---------------------------------------------------------------------------
# The operators: one path in eager mode and under torch.export
# ---------------------------------------------------------------------------

# The operators' namespace. A second copy of this module (another
# checkout's, loaded by path to be timed beside this one, as
# ``tools/k4_timing.py:load_kernels`` does) is given another.
NAMESPACE = "fs"
_LIB = torch.library.Library(NAMESPACE, "DEF")


def _tensors(args) -> list[torch.Tensor]:
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out += [t for t in a if isinstance(t, torch.Tensor)]
    return out


def _twin(name: str, plain):
    """The CPU kernel of operator ``name``: its plain twin, refusing tensors
    that need a backward (the operators have none) and returning contiguous
    outputs, the strides the shape function gives."""
    def run(*args):
        _forward_only(name, *_tensors(args))
        out = plain(*args)
        return tuple(o.contiguous() for o in out) if isinstance(out, tuple) else out.contiguous()
    return run


def _define(schema: str, plain, cuda, fake):
    """Define ``fs::<name>`` with ``plain`` as its CPU kernel, ``cuda`` as its
    CUDA kernel and ``fake`` as its shape function; returns the operator."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, _twin(name, plain), "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


_CV = "Tensor left, Tensor right, Tensor right_proj, int maxdisp, int num_groups"
_LK = "Tensor[] geo_pyramid, Tensor[] corr_pyramid, Tensor disp, int radius"
cost_volume_parts = _define(
    f"cost_volume_parts({_CV}, ScalarType out_dtype=float) -> (Tensor, Tensor)",
    cost_volume_parts_plain, _cost_volume_parts_cuda, _cost_volume_parts_fake)
cost_volume_parts_haloed = _define(
    f"cost_volume_parts_haloed({_CV}, int x_offset, ScalarType out_dtype=float) -> (Tensor, Tensor)",
    cost_volume_parts_haloed_plain, _cost_volume_parts_haloed_cuda,
    lambda l, r, rp, d, g, x0, dt=torch.float32: _cost_volume_parts_fake(l, r, rp, d, g, dt))
disparity_lookup = _define(
    f"disparity_lookup({_LK}, ScalarType out_dtype=float) -> Tensor",
    disparity_lookup_plain, _disparity_lookup_cuda, _disparity_lookup_fake)
disparity_lookup_shard = _define(
    f"disparity_lookup_shard({_LK}, int x_offset, ScalarType out_dtype=float) -> Tensor",
    lambda g, c, d, r, x0, dt=torch.float32: disparity_lookup_plain(g, c, d, r, dt, x0),
    _disparity_lookup_shard_cuda,
    lambda g, c, d, r, x0, dt=torch.float32: _disparity_lookup_fake(g, c, d, r, dt))
flash_attention = _define(
    "flash_attention(Tensor qkv, float scale) -> Tensor",
    lambda qkv, scale: flash_attention_plain(qkv, scale), _flash_attention_cuda,
    lambda qkv, scale: _flash_attention_heads_fake(qkv, scale, 0, qkv.shape[3]))
flash_attention_heads = _define(
    "flash_attention_heads(Tensor qkv, float scale, int h0, int n_heads) -> Tensor",
    _flash_attention_heads_plain, _flash_attention_heads_cuda, _flash_attention_heads_fake)
conv3x3 = _define(
    "conv3x3(Tensor x, Tensor weight, Tensor? bias=None, Tensor? packed=None) -> Tensor",
    _conv3x3_plain_op, _conv3x3_cuda, _conv3x3_fake)
conv3d_1out = _define(
    "conv3d_1out(Tensor x, Tensor weight, Tensor? bias, int[] padding) -> Tensor",
    conv3d_1out_plain, _conv3d_1out_cuda, _conv3d_1out_fake)
