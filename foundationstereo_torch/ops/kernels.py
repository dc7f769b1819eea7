"""The port's hand-written CUDA kernels: build, load, wrappers, launch counts.

Three kernels, one CUDA C++ source each under ``foundationstereo_torch/csrc``:

=====================  ==========================  ==========================================
wrapper                source                      TPU kernel it replaces
=====================  ==========================  ==========================================
cost_volume_parts      csrc/cost_volume.cu         ops/pallas_kernels.py:build_cost_volume_pallas
disparity_lookup       csrc/lookup.cu              ops/pallas_kernels.py:lookup_level_pallas
flash_attention        csrc/flash_attention.cu     models/dinov2.py:flash_vit_attention
=====================  ==========================  ==========================================

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface and loaded with ``ctypes``. The build runs at the first
CUDA call (all sources at once, one ``nvcc`` each, in parallel) into
``foundationstereo_torch/_build/``; a library's file name carries the hash of
its source, so an edited source is rebuilt. A failed build or load raises.

On a CPU tensor a wrapper runs its kernel's plain PyTorch twin; on a CUDA
tensor it launches the kernel (and adds one to ``LAUNCHES[name]``) or raises.
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

from foundationstereo_torch.ops.cost_volume import cost_volume_parts as cost_volume_parts_plain
from foundationstereo_torch.ops.sampler import disparity_lookup as disparity_lookup_plain

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = {
    "cost_volume_parts": "cost_volume.cu",
    "disparity_lookup": "lookup.cu",
    "flash_attention": "flash_attention.cu",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# Launches per kernel since the last reset_launches(); counted only where a
# wrapper launches its kernel.
LAUNCHES = {name: 0 for name in SOURCES}

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
    digest = hashlib.sha256((CSRC / source).read_bytes()
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
            for n, p in build_all().items():
                fn = getattr(ctypes.CDLL(str(p)), f"fs_{n}")
                fn.restype = ctypes.c_int
                fn.argtypes = _ARGTYPES[n]
                _fns[n] = fn
        return _fns[name]


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "cost_volume_parts": [_P, _P, _P, _P, _P] + [_I] * 9 + [_P],
    "disparity_lookup": [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "flash_attention": [_P, _P, _I, _I, _I, ctypes.c_float, _I, _P],
}


def _check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _on_cuda(*tensors: torch.Tensor) -> bool:
    devs = {t.device.type for t in tensors}
    _require(len(devs) == 1, f"tensors on mixed devices {devs}")
    dev = devs.pop()
    _require(dev in ("cpu", "cuda"), f"unsupported device {dev}")
    return dev == "cuda"


_FLOATS = (torch.float32, torch.bfloat16)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# K1: cost-volume parts
# ---------------------------------------------------------------------------


def cost_volume_parts(left: torch.Tensor, right: torch.Tensor, right_proj: torch.Tensor,
                      maxdisp: int, num_groups: int,
                      out_dtype: torch.dtype = torch.float32):
    """left/right (B, C, H, W), right_proj (B, P, H, W) -> gwc (B, G, D, H, W),
    rps (B, P, D, H, W) in ``out_dtype``; see ``ops.cost_volume.cost_volume_parts``."""
    if not _on_cuda(left, right, right_proj):
        return cost_volume_parts_plain(left, right, right_proj, maxdisp, num_groups, out_dtype)
    b, c, h, w = left.shape
    p = right_proj.shape[1]
    _require(right.shape == left.shape and right_proj.shape == (b, p, h, w),
             f"shapes {tuple(left.shape)} {tuple(right.shape)} {tuple(right_proj.shape)}")
    _require(left.dtype == right.dtype == right_proj.dtype and left.dtype in _FLOATS,
             "inputs must share one dtype, float32 or bfloat16")
    _require(out_dtype in _FLOATS, f"out_dtype {out_dtype}")
    _require(c % num_groups == 0 and c // num_groups <= 32, f"C={c}, groups={num_groups}")
    _require(c // num_groups * w * 4 <= 232448, f"row of width {w} exceeds shared memory")
    _require(all(t.is_contiguous() for t in (left, right, right_proj)),
             "inputs must be contiguous")
    gwc = torch.empty((b, num_groups, maxdisp, h, w), device=left.device, dtype=out_dtype)
    rps = torch.empty((b, p, maxdisp, h, w), device=left.device, dtype=out_dtype)
    err = _lib("cost_volume_parts")(
        left.data_ptr(), right.data_ptr(), right_proj.data_ptr(), gwc.data_ptr(),
        rps.data_ptr(), b, c, h, w, num_groups, p, maxdisp,
        int(left.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16), _stream())
    _check("cost_volume_parts", err)
    return gwc, rps


# ---------------------------------------------------------------------------
# K2: disparity lookup, all levels in one launch
# ---------------------------------------------------------------------------


def disparity_lookup(geo_pyramid: list[torch.Tensor], corr_pyramid: list[torch.Tensor],
                     disp: torch.Tensor, radius: int,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """geo levels (B, H, W, C, D_l), corr levels (B, H, W, W_l), disp (B, H, W)
    -> (B, L*(C+1)*(2r+1), H, W); see ``ops.sampler.disparity_lookup``."""
    if not _on_cuda(disp, *geo_pyramid, *corr_pyramid):
        return disparity_lookup_plain(geo_pyramid, corr_pyramid, disp, radius, out_dtype)
    b, h, w = disp.shape
    n = len(geo_pyramid)
    c = geo_pyramid[0].shape[3]
    in_dtype = geo_pyramid[0].dtype
    _require(1 <= n <= 8 and len(corr_pyramid) == n,
             f"{n} geometry / {len(corr_pyramid)} corr levels")
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
    err = _lib("disparity_lookup")(
        ptrs(*[g.data_ptr() for g in geo_pyramid]), ptrs(*[cr.data_ptr() for cr in corr_pyramid]),
        lens(*[g.shape[4] for g in geo_pyramid]), lens(*[cr.shape[3] for cr in corr_pyramid]),
        n, disp.data_ptr(), out.data_ptr(), b, h, w, c, radius,
        int(in_dtype == torch.bfloat16), int(out_dtype == torch.bfloat16), _stream())
    _check("disparity_lookup", err)
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


def flash_attention(qkv: torch.Tensor, scale: float) -> torch.Tensor:
    """Softmax attention from the packed projection qkv (B, N, 3, H, 64) ->
    (B, N, H, 64) in qkv's dtype, bfloat16 (tensor cores) or float32."""
    if not _on_cuda(qkv):
        return flash_attention_plain(qkv, scale)
    b, n, three, heads, hd = qkv.shape
    _require(three == 3 and hd == 64, f"qkv shape {tuple(qkv.shape)}: want (B, N, 3, H, 64)")
    _require(qkv.dtype in _FLOATS and qkv.is_contiguous() and qkv.data_ptr() % 16 == 0,
             "qkv must be contiguous, 16-byte aligned float32 or bfloat16")
    out = torch.empty((b, n, heads, hd), device=qkv.device, dtype=qkv.dtype)
    err = _lib("flash_attention")(qkv.data_ptr(), out.data_ptr(), b, n, heads, float(scale),
                                  int(qkv.dtype == torch.bfloat16), _stream())
    _check("flash_attention", err)
    return out
