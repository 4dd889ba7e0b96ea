"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled for Hopper (``sm_90a``) by its own
``nvcc`` process, all started together, and the objects are linked into
``build/colorvideovdp_tpu_torch/libcvvdp_kernels.so`` beside the package, at
first use (never at import); the library is rebuilt when the hash of the
sources or flags changes. It has a plain C interface and is loaded with
ctypes; no PyTorch headers are compiled, so a build takes seconds. Nothing
is downloaded.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "colorvideovdp_tpu_torch")
LIB_NAME = "libcvvdp_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# argtypes of every C entry point, in declaration order.
SIGNATURES = {
    "cvvdp_csf_lut": [_P, _P, _L, _I, _I, _P, _F, _F, _P],
    "cvvdp_csf_lut_bwd": [_P, _P, _P, _L, _I, _I, _P, _F, _F, _P],
    "cvvdp_blur": [_P, _P, _I, _I, _I, _P, _I, _I, _P],
    "cvvdp_pyramid_reduce": [_P, _P, _I, _I, _I, _P, _P],
    "cvvdp_pyramid_reduce_slab": [_P, _P, _I, _I, _I, _I, _P, _P],
    "cvvdp_ingest": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _I, _I, _P,
                     _P, _I, _P, _P, _P, _P],
    "cvvdp_interleave": [_P, _P, _P, _L, _P],
    "cvvdp_deinterleave": [_P, _P, _P, _L, _P],
    "cvvdp_concat": [_P, _P, _P, _L, _I, _P],
    "cvvdp_band_pooled": [_I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _F, _F, _P, _F, _I, _F,
                          _F, _P, _P, _F, _P, _F, _F, _P, _I, _F, _P, _P, _P],
    "cvvdp_band_pooled_occupancy": [_I, _I, _I],
}

# Seconds the last build() took (0.0 when the cached library was current).
last_build_seconds = 0.0


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def build() -> str:
    """Compile the kernels unless the cached library matches the sources.
    Returns the library path; raises with nvcc's output on failure."""
    global last_build_seconds
    lib_path = os.path.join(BUILD_DIR, LIB_NAME)
    stamp = lib_path + ".sha256"
    digest = _digest()
    if os.path.isfile(lib_path) and os.path.isfile(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                last_build_seconds = 0.0
                return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    tmp = f"{lib_path}.{tag}"
    t0 = time.time()
    jobs = []
    for src in (s for s in _sources() if s.endswith(".cu")):
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
    logs, failed = [], []
    for cmd, _, proc in jobs:
        out, err = proc.communicate()
        logs.append(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{err}")
    if not failed:
        cmd = [nvcc, "-shared", "-o", tmp, *[obj for _, obj, _ in jobs]]
        res = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(f"link ({res.returncode}):\n{res.stderr}")
    for _, obj, _ in jobs:
        if os.path.exists(obj):
            os.remove(obj)
    last_build_seconds = time.time() - t0
    with open(os.path.join(BUILD_DIR, "nvcc.log"), "w") as f:
        f.write("\n".join(logs))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, lib_path)
    with open(stamp, "w") as f:
        f.write(digest)
    return lib_path


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library with argtypes set (built on first call)."""
    lib = ctypes.CDLL(build())
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
    return lib


def check_cuda(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor, dtype=torch.float32, contiguous=True):
    """Raise unless every tensor is a CUDA tensor of ``dtype`` on one device,
    and a contiguous one unless ``contiguous`` is False."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expected CUDA tensors on one device, got {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
