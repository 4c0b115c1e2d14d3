"""Hand-written Hopper kernels: build, ctypes binding, wrappers, launch counts.

The CUDA C++ sources live in ``symmer_torch/csrc``.  On first use they are
compiled with ``nvcc`` for ``sm_90a`` into one shared library with a plain C
interface under ``build/symmer_torch/`` (beside the package; the file name
carries a digest of the sources and flags, so an edited source rebuilds) and
loaded with ctypes.

Each wrapper takes the kernel's plain torch version (kernels/torch_core.py)
only for CPU tensors.  For CUDA tensors it checks device, dtype, shape and
contiguity, allocates its outputs with ``torch.empty``, launches on
``torch.cuda.current_stream()`` and raises if the launch reports an error.
There is no fallback: a CUDA tensor gets the kernel or an exception.

``launches`` counts kernel launches per wrapper; a wrapper adds one where it
launches its kernel and nowhere else (an empty input launches nothing).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import uuid

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "symmer_torch")
SOURCES = ("anticommutes.cu", "clifford_scan.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

launches = {"anticommutes": 0, "clifford_scan": 0}
# nvcc's stderr of the last build (ptxas register / shared-memory report)
build_log = ""


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set NVCC or put the CUDA toolkit on PATH)")


def library_path() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libsymmer_torch_kernels-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels (once per source digest); returns the library path."""
    global build_log
    lib = library_path()
    if os.path.exists(lib):
        return lib
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    # unique temp name + atomic rename: concurrent builders never load a
    # partially written library
    tmp = f"{lib}.{uuid.uuid4().hex}"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp] + [os.path.join(CSRC, s) for s in SOURCES]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{res.stderr}")
    build_log = res.stderr
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.symmer_anticommutes.argtypes = [p, p, i64, p, p, i64, i64, p, p]
    lib.symmer_anticommutes.restype = ctypes.c_int
    lib.symmer_clifford_scan.argtypes = [
        p, p, p, p, i64, i64, p, p, p, i64, p, p, p, p, p,
    ]
    lib.symmer_clifford_scan.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()}-D, expected {ndim}-D")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def anticommutes(x1, z1, x2, z2) -> torch.Tensor:
    """bool[M1, M2]: parity(popc(x1_i & z2_j) + popc(z1_i & x2_j)).

    Planes are int64[M, W].  CUDA kernel: csrc/anticommutes.cu."""
    if x1.device.type == "cpu":
        from . import torch_core

        return torch_core.anticommutes(x1, z1, x2, z2)
    dev = x1.device
    if dev.type != "cuda":
        raise ValueError(f"anticommutes: unsupported device {dev}")
    for name, t in (("x1", x1), ("z1", z1), ("x2", x2), ("z2", z2)):
        _check(name, t, torch.int64, 2, dev)
    M1, W = x1.shape
    M2 = x2.shape[0]
    if z1.shape != x1.shape or x2.shape != (M2, W) or z2.shape != (M2, W):
        raise ValueError(
            f"anticommutes: plane shapes {tuple(x1.shape)}, {tuple(z1.shape)}, "
            f"{tuple(x2.shape)}, {tuple(z2.shape)} disagree"
        )
    out = torch.empty((M1, M2), dtype=torch.uint8, device=dev)
    if M1 and M2:
        _launch("anticommutes", _lib().symmer_anticommutes(
            x1.data_ptr(), z1.data_ptr(), M1, x2.data_ptr(), z2.data_ptr(),
            M2, W, out.data_ptr(), _stream(),
        ))
    return out.view(torch.bool)


def clifford_scan(x, z, cr, ci, rx, rz, rm):
    """Apply D Clifford rotations (pi/2 multiples ``rm``) in one launch.

    x, z: int64[T, W]; cr, ci: float64[T]; rx, rz: int64[D, W]; rm: int64[D].
    Returns new (x, z, cr, ci).  CUDA kernel: csrc/clifford_scan.cu."""
    if x.device.type == "cpu":
        from . import torch_core

        return torch_core.clifford_scan(x, z, cr, ci, rx, rz, rm)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"clifford_scan: unsupported device {dev}")
    for name, t, dt, nd in (
        ("x", x, torch.int64, 2), ("z", z, torch.int64, 2),
        ("cr", cr, torch.float64, 1), ("ci", ci, torch.float64, 1),
        ("rx", rx, torch.int64, 2), ("rz", rz, torch.int64, 2),
        ("rm", rm, torch.int64, 1),
    ):
        _check(name, t, dt, nd, dev)
    T, W = x.shape
    D = rx.shape[0]
    if (z.shape != (T, W) or cr.shape != (T,) or ci.shape != (T,)
            or rx.shape != (D, W) or rz.shape != (D, W) or rm.shape != (D,)):
        raise ValueError("clifford_scan: operand shapes disagree")
    if T == 0 or D == 0:
        return x.clone(), z.clone(), cr.clone(), ci.clone()
    ox, oz = torch.empty_like(x), torch.empty_like(z)
    ocr, oci = torch.empty_like(cr), torch.empty_like(ci)
    _launch("clifford_scan", _lib().symmer_clifford_scan(
        x.data_ptr(), z.data_ptr(), cr.data_ptr(), ci.data_ptr(), T, W,
        rx.data_ptr(), rz.data_ptr(), rm.data_ptr(), D,
        ox.data_ptr(), oz.data_ptr(), ocr.data_ptr(), oci.data_ptr(), _stream(),
    ))
    return ox, oz, ocr, oci
