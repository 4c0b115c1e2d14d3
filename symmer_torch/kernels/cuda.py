"""Hand-written Hopper kernels: build, ctypes binding, wrappers, launch counts.

The CUDA C++ sources live in ``symmer_torch/csrc``.  On first use they are
compiled with ``nvcc`` for ``sm_90a`` (one process per source, in parallel)
and linked into one shared library with a plain C interface under
``build/symmer_torch/`` (beside the package; the file name
carries a digest of the sources and flags, so an edited source rebuilds) and
loaded with ctypes.

Each wrapper takes the kernel's plain torch version (kernels/torch_core.py,
torch_state.py, torch_noncon.py, torch_lanczos.py, torch_vqe.py,
torch_gf2.py) only for CPU tensors.  For CUDA tensors it checks device, dtype, shape and
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
import re
import shutil
import subprocess
import uuid

import numpy as np
import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "symmer_torch")
SOURCES = ("anticommutes.cu", "clifford_scan.cu", "state_expval.cu", "noncon_brute.cu",
           "lanczos_matvec.cu", "group_diag.cu", "lanczos_step.cu", "vqe_rotate.cu",
           "pauli_overlaps.cu", "gf2_rref.cu", "route_rows.cu", "row_signature.cu",
           "pair_products.cu", "merge_groups.cu", "rotation_rows.cu", "project_rows.cu",
           "sort_keys.cu", "merge_small.cu")
# headers the sources include (part of the library's digest)
HEADERS = ("pairwise_sum.cuh", "row_signature.cuh", "look_back.cuh", "merge_rows.cuh",
           "pair_phase.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")

launches = {"anticommutes": 0, "clifford_scan": 0, "expval": 0, "brute_force_minimise": 0,
            "group_matvec": 0, "build_group_diagonals": 0, "lanczos_step": 0,
            "lanczos_replay": 0, "lanczos_ritz": 0, "vqe_rotate": 0, "vqe_adjoint": 0,
            "pauli_overlaps": 0, "gf2_rref": 0, "route_rows": 0, "row_signature": 0,
            "pair_products": 0, "merge_groups": 0, "rotation_rows": 0, "project_rows": 0,
            "sort_keys": 0, "merge_small": 0, "sign_merge_small": 0}
# wrapper calls that launched, per launch key (one call may launch several times)
calls = dict.fromkeys(launches, 0)
# cleanups whose sort by ka alone split a group (K3's split report), so that
# their merge ran again after a sort by (ka, kb) (torch_core._merge_sorted)
sort_repairs = 0


def _source_constant(name: str, source: str) -> int:
    """The value of `constexpr int <name> = <value>;` in csrc/<source>."""
    with open(os.path.join(CSRC, source)) as f:
        m = re.search(rf"constexpr int {name} = (\d+);", f.read())
    if m is None:
        raise RuntimeError(f"{source} defines no constexpr int {name}")
    return int(m.group(1))


# K3's one-block route (merge_small): the cleanup of at most this many slots,
# as csrc/merge_small.cu's kMaxSlots sets it (the same count as K17's one
# block)
SMALL_ROWS = _source_constant("kMaxSlots", "merge_small.cu")
# its fused route (cleanup_small, product_small): a cleanup or product of at
# most SMALL_ROWS slots and this many slot-words, as csrc/merge_small.cu's
# kFusedWords sets it (small_fused)
FUSED_WORDS = _source_constant("kFusedWords", "merge_small.cu")
# block partials of the two-pass reductions (expval, brute_force_minimise)
MAX_BLOCKS = 4096
# nvcc's stderr of the last build (ptxas register / shared-memory report)
build_log = ""


def reset_launches() -> None:
    global sort_repairs
    for name in launches:
        launches[name] = calls[name] = 0
    sort_repairs = 0


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set NVCC or put the CUDA toolkit on PATH)")


def library_path() -> str:
    h = hashlib.sha1(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libsymmer_torch_kernels-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels (once per source digest); returns the library path.

    One nvcc per source, all started together, then one link."""
    global build_log
    lib = library_path()
    if os.path.exists(lib):
        return lib
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    # unique temp names + atomic rename: concurrent builds never load a
    # partially written library
    tag = uuid.uuid4().hex
    objs = [os.path.join(BUILD_DIR, f"{name}.{tag}.o") for name in SOURCES]
    jobs = []
    for name, obj in zip(SOURCES, objs):
        cmd = [nvcc, *COMPILE_FLAGS, "-c", "-o", obj, os.path.join(CSRC, name)]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True)))
    logs = []
    for cmd, proc in jobs:
        _, err = proc.communicate()
        logs.append((cmd, proc.returncode, err))
    for cmd, rc, err in logs:
        if rc != 0:
            for obj in objs:
                if os.path.exists(obj):
                    os.remove(obj)
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{err}")
    tmp = f"{lib}.{tag}"
    cmd = [nvcc, *LINK_FLAGS, "-o", tmp, *objs]
    res = subprocess.run(cmd, capture_output=True, text=True)
    for obj in objs:
        os.remove(obj)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{res.stderr}")
    build_log = "".join(err for _, _, err in logs)
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
    lib.symmer_state_hash.argtypes = [p, i64, i64, p, p, p]
    lib.symmer_state_hash.restype = ctypes.c_int
    lib.symmer_state_expval_scratch.argtypes = [i64, i64, i64, i64, i64]
    lib.symmer_state_expval_scratch.restype = i64
    lib.symmer_state_expval.argtypes = [
        p, p, p, i64, i64, p, p, p, p, i64, p, p, p, p, i64, i64, p, p,
    ]
    lib.symmer_state_expval.restype = ctypes.c_int
    lib.symmer_noncon_brute.argtypes = [p, p, p, i64, i64, i64, i64, i64, i64, p, p, p, p, i64,
                                        p, p, p]
    lib.symmer_noncon_brute.restype = ctypes.c_int
    lib.symmer_group_matvec.argtypes = [p, p, p, p, p, p, p, i64, i64, i64, i64, i64, i64, p]
    lib.symmer_group_matvec_slices.argtypes = [i64, i64]
    lib.symmer_group_matvec_slices.restype = i64
    lib.symmer_group_matvec.restype = ctypes.c_int
    lib.symmer_group_diag_pass.argtypes = [p, i64, i64, i64, i64, p, p, i64, i64, p]
    lib.symmer_group_diag_pass.restype = ctypes.c_int
    lib.symmer_lanczos_step_cluster.argtypes = [ctypes.POINTER(i64), ctypes.POINTER(i64)]
    lib.symmer_lanczos_step_cluster.restype = ctypes.c_int
    lib.symmer_lanczos_step.argtypes = [p, p, p, p, p, p, i64, p, i64, ctypes.c_int,
                                        ctypes.c_int, p]
    lib.symmer_lanczos_step.restype = ctypes.c_int
    lib.symmer_lanczos_replay.argtypes = [p, p, p, p, p, i64, p, p, i64, i64, p]
    lib.symmer_lanczos_replay.restype = ctypes.c_int
    lib.symmer_lanczos_ritz.argtypes = [p, p, p, i64, i64, i64, p]
    lib.symmer_lanczos_ritz.restype = ctypes.c_int
    i32, sec = ctypes.c_int, ctypes.POINTER(ctypes.c_int64)
    lib.symmer_vqe_runs.argtypes = [p, p, i64, i32, i32, p, sec, p, p, p]
    lib.symmer_vqe_runs.restype = ctypes.c_int
    lib.symmer_vqe_adjoint.argtypes = [p, p, i64, i32, i32, p, sec, p, p, i64, p, p, p]
    lib.symmer_vqe_adjoint.restype = ctypes.c_int
    lib.symmer_pauli_overlaps_chunks.argtypes = [i64, i64]
    lib.symmer_pauli_overlaps_chunks.restype = i64
    lib.symmer_pauli_overlaps.argtypes = [p, p, i64, p, p, p, i64, p, p, i64, p, p, p]
    lib.symmer_pauli_overlaps.restype = ctypes.c_int
    lib.symmer_gf2_rref_scratch.argtypes = [i64, i64]
    lib.symmer_gf2_rref_scratch.restype = i64
    lib.symmer_gf2_rref.argtypes = [p, i64, i64, p, p]
    lib.symmer_gf2_rref.restype = ctypes.c_int
    lib.symmer_route_rows_tiles.argtypes = [i64]
    lib.symmer_route_rows_tiles.restype = i64
    lib.symmer_route_rows.argtypes = [p, p, p, p, p, i64, i64, i64, i64, i64, p, p, p, p, p, p,
                                      p, p, p, p, p]
    lib.symmer_route_rows.restype = ctypes.c_int
    lib.symmer_row_signature.argtypes = [p, p, i64, i64, p, p, p]
    lib.symmer_row_signature.restype = ctypes.c_int
    lib.symmer_pair_products.argtypes = [p, p, p, p, i64, p, p, p, p, i64, i64, p, p, p, p, p]
    lib.symmer_pair_products.restype = ctypes.c_int
    lib.symmer_merge_groups_sums.argtypes = [p, p, p, p, p, p, i64, i64, i64, ctypes.c_double,
                                             p, p, p, p]
    lib.symmer_merge_groups_sums.restype = ctypes.c_int
    lib.symmer_merge_groups_tiles.argtypes = [i64]
    lib.symmer_merge_groups_tiles.restype = i64
    lib.symmer_merge_groups_gather.argtypes = [p, p, p, i64, i64, i64, p, p, p, p, i64, i64, p, p,
                                               p, p, p, p, p]
    lib.symmer_merge_groups_gather.restype = ctypes.c_int
    f64 = ctypes.c_double
    lib.symmer_rotation_rows.argtypes = [p, p, p, p, i64, i64, p, p, f64, f64, p, p, p, p, p, p]
    lib.symmer_rotation_rows.restype = ctypes.c_int
    lib.symmer_project_rows.argtypes = [p, p, p, p, i64, i64, p, i64, p, p, p, p, p, p, p, p, p]
    lib.symmer_project_rows.restype = ctypes.c_int
    lib.symmer_sort_keys_scratch.argtypes = [i64]
    lib.symmer_sort_keys_scratch.restype = i64
    lib.symmer_sort_keys_launches.argtypes = [i64]
    lib.symmer_sort_keys_launches.restype = i64
    lib.symmer_sort_keys.argtypes = [p, i64, p, p, p, p, p, p]
    lib.symmer_sort_keys.restype = ctypes.c_int
    lib.symmer_merge_small.argtypes = [p, p, p, p, p, i64, i64, f64, i64, i64, p, p, p, p, i64,
                                       p, p, p, p, p, p, p]
    lib.symmer_merge_small.restype = ctypes.c_int
    lib.symmer_sign_merge_small.argtypes = [i64, p, p, p, p, p, p, p, p, i64, i64, i64, i64, f64,
                                            p, p, p, p, p, p, p, p]
    lib.symmer_sign_merge_small.restype = ctypes.c_int
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


def _raise(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _launch(name: str, err: int, n: int = 1, call: bool = True) -> None:
    """Count n launches (and one wrapper call, unless `call` is False) of a
    kernel whose launch returned `err`."""
    _raise(name, err)
    launches[name] += n
    calls[name] += int(call)


def _stream(dev: torch.device = None) -> int:
    """The raw handle of torch's current stream on `dev` (the current device
    by default); the public torch.cuda.current_stream() costs ~4 us a call."""
    idx = dev.index if dev is not None and dev.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(idx)


def anticommutes(x1, z1, x2, z2) -> torch.Tensor:
    """bool[M1, M2]: parity(popc(x1_i & z2_j) + popc(z1_i & x2_j)).

    Planes are int64[M, W].  CUDA kernel: csrc/anticommutes.cu (chosen by
    shape: a memory-streaming kernel for M2 <= 16, W <= 64 and 16-byte
    aligned op1 planes, the binary tensor-core product otherwise)."""
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


def row_signature(x, z):
    """The 128-bit signature of each packed row as two int64 sort keys (ka,
    kb), on the rows' device: what every cleanup sorts and groups by.

    x, z: int64[T, W].  Bit for bit torch_core.row_signature.  One launch.
    CUDA kernel: csrc/row_signature.cu."""
    if x.device.type == "cpu":
        from . import torch_core

        return torch_core.row_signature(x, z)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"row_signature: unsupported device {dev}")
    _check("x", x, torch.int64, 2, dev)
    _check("z", z, torch.int64, 2, dev)
    if z.shape != x.shape:
        raise ValueError(f"row_signature: plane shapes {tuple(x.shape)}, {tuple(z.shape)} "
                         "disagree")
    T, W = x.shape
    out = torch.empty((2, T), dtype=torch.int64, device=dev)
    if T:
        a = out.data_ptr()
        _launch("row_signature", _lib().symmer_row_signature(
            x.data_ptr(), z.data_ptr(), T, W, a, a + 8 * T, _stream(dev)))
    return out[0], out[1]


def pair_products(x1, z1, cr1, ci1, x2, z2, cr2, ci2):
    """(ka, kb, pr, pi) of every product row r = i * M2 + j of operand 1's
    row i and operand 2's row j, without the product rows: the row
    signature of (x1[i] ^ x2[j], z1[i] ^ z2[j]) as row_signature gives it,
    and the product's coefficient (cr1 + i ci1)(cr2 + i ci2) (-1)^popc(x1 &
    z2) i^(3 (y1 + y2) + y_out).

    x1, z1: int64[M1, W]; cr1, ci1: float64[M1]; the same for operand 2.
    Bit for bit torch_core.pair_products.  One launch (none for an empty
    operand).  CUDA kernel: csrc/pair_products.cu."""
    if x1.device.type == "cpu":
        from . import torch_core

        return torch_core.pair_products(x1, z1, cr1, ci1, x2, z2, cr2, ci2)
    dev = x1.device
    if dev.type != "cuda":
        raise ValueError(f"pair_products: unsupported device {dev}")
    for name, t, dt, nd in (
        ("x1", x1, torch.int64, 2), ("z1", z1, torch.int64, 2),
        ("cr1", cr1, torch.float64, 1), ("ci1", ci1, torch.float64, 1),
        ("x2", x2, torch.int64, 2), ("z2", z2, torch.int64, 2),
        ("cr2", cr2, torch.float64, 1), ("ci2", ci2, torch.float64, 1),
    ):
        _check(name, t, dt, nd, dev)
    M1, W = x1.shape
    M2 = x2.shape[0]
    if (z1.shape != (M1, W) or x2.shape != (M2, W) or z2.shape != (M2, W)
            or cr1.shape != (M1,) or ci1.shape != (M1,) or cr2.shape != (M2,)
            or ci2.shape != (M2,)):
        raise ValueError("pair_products: operand shapes disagree")
    keys = torch.empty((2, M1 * M2), dtype=torch.int64, device=dev)
    coeffs = torch.empty((2, M1 * M2), dtype=torch.float64, device=dev)
    if M1 and M2:
        k, c = keys.data_ptr(), coeffs.data_ptr()
        _launch("pair_products", _lib().symmer_pair_products(
            x1.data_ptr(), z1.data_ptr(), cr1.data_ptr(), ci1.data_ptr(), M1, x2.data_ptr(),
            z2.data_ptr(), cr2.data_ptr(), ci2.data_ptr(), M2, W, k, k + 8 * M1 * M2, c,
            c + 8 * M1 * M2, _stream(dev)))
    return keys[0], keys[1], coeffs[0], coeffs[1]


# K3's row sources (csrc/merge_groups.cu): planes (x, z), a product's
# operands (x1, z1, x2, z2), a rotation's (x, z, xr, zr), masked (x, z, col_keep)
PLANES, PAIRS, ROTATION, MASKED = 0, 1, 2, 3


def row_source(rows) -> int:
    """The kind of a row source of merge_groups: (x, z) planes, (x1, z1, x2,
    z2) a product's operands (x2 2-D), (x, z, xr, zr) a rotation's rows and
    their P Q twins (xr 1-D), (x, z, col_keep) masked rows."""
    if len(rows) == 2:
        return PLANES
    if len(rows) == 3:
        return MASKED
    if len(rows) == 4:
        return PAIRS if rows[2].dim() == 2 else ROTATION
    raise ValueError("merge_groups: rows must be (x, z), (x1, z1, x2, z2), (x, z, xr, zr) "
                     "or (x, z, col_keep)")


def source_args(rows) -> tuple:
    """A row source as pass B's C arguments (source, x, z, x2, z2, M2): x2,
    z2 null for planes, col_keep twice for masked rows; M2 a product's
    operand-2 rows, else 0."""
    kind = row_source(rows)
    p = [t.data_ptr() for t in rows]
    x2z2 = [0, 0] if kind == PLANES else [p[2], p[2]] if kind == MASKED else p[2:]
    return (kind, p[0], p[1], *x2z2, rows[2].shape[0] if kind == PAIRS else 0)


def sort_keys(keys):
    """(perm, sorted): the stable ascending argsort of int64 keys in signed
    order, perm: int32[T], bit for bit torch.argsort(keys, stable=True), and
    keys[perm].

    keys: int64[T].  One launch up to 4,096 keys (one block sorts them in
    shared memory); above, a memset and three launches whatever the keys:
    the digit histograms, a stable partition on the highest digit on which
    the keys differ, and one block a bucket of that digit sorting it by the
    bits below (on chip, or through global memory where a bucket passes the
    block's shared memory); none for T <= 1.  No host synchronisation.  Bit
    for bit torch_core.sort_keys.  CUDA kernel: csrc/sort_keys.cu (K17)."""
    if keys.device.type == "cpu":
        from . import torch_core

        return torch_core.sort_keys(keys)
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError(f"sort_keys: unsupported device {dev}")
    _check("keys", keys, torch.int64, 1, dev)
    T = keys.shape[0]
    if T >= 1 << 31:
        raise ValueError(f"sort_keys: {T} keys, at most 2^31 - 1")
    if T <= 1:
        return torch.zeros(T, dtype=torch.int32, device=dev), keys.clone()
    lib = _lib()
    words = lib.symmer_sort_keys_scratch(T)
    out, perm = torch.empty(T, dtype=torch.int64, device=dev), torch.empty(
        T, dtype=torch.int32, device=dev)
    # the large buckets' other keys and perm (int32 pairs in int64 words),
    # then the histograms, the ticket and the status words
    tmp = torch.empty(T + (T + 1) // 2 + words, dtype=torch.int64, device=dev) if words else None
    t = 0 if tmp is None else tmp.data_ptr()
    _launch("sort_keys", lib.symmer_sort_keys(
        keys.data_ptr(), T, out.data_ptr(), perm.data_ptr(), t, t and t + 8 * T,
        t and t + 8 * (T + (T + 1) // 2), _stream(dev)),
        n=lib.symmer_sort_keys_launches(T))
    return perm, out


def _merge_operands(name, dev, ka, kb, cr, ci, rows, live, more=()) -> tuple:
    """(T, W) of a merge's operands on `dev` (merge_groups, merge_small):
    ka, kb int64[T], cr, ci float64[T], live bool[T] or None, `more` of T
    rows too, and a row source (row_source) of T rows of W words; raises on
    another device, dtype or shape."""
    for arg, t, dt in (("ka", ka, torch.int64), ("kb", kb, torch.int64),
                       ("cr", cr, torch.float64), ("ci", ci, torch.float64)):
        _check(arg, t, dt, 1, dev)
    if live is not None:
        _check("live", live, torch.bool, 1, dev)
    kind = row_source(rows)
    for arg, t in zip(("x", "z", "x2", "z2"), rows):
        _check(arg, t, torch.int64, 2 if kind == PAIRS or arg in ("x", "z") else 1, dev)
    T = ka.shape[0]
    m, W = rows[0].shape
    held = m * rows[2].shape[0] if kind == PAIRS else 2 * m if kind == ROTATION else m
    flags = (live,) if live is not None else ()
    if (any(t.shape != (T,) for t in (kb, cr, ci) + flags + tuple(more))
            or rows[1].shape != rows[0].shape or any(t.shape[-1] != W for t in rows)
            or (kind == PAIRS and rows[3].shape != rows[2].shape)
            or (kind == ROTATION and rows[3].shape != (W,)) or held != T):
        raise ValueError(f"{name}: operand shapes disagree")
    return T, W


def _no_rows(W: int, dev) -> tuple:
    """A merge's outputs (x, z, cr, ci, ka) with no row."""
    planes = torch.empty((2, 0, W), dtype=torch.int64, device=dev)
    c = torch.empty((2, 0), dtype=torch.float64, device=dev)
    return planes[0], planes[1], c[0], c[1], torch.empty(0, dtype=torch.int64, device=dev)


def merge_groups(perm, kas, ka, kb, cr, ci, zero_threshold, rows, live=None, check=True):
    """The cleanup after its sort: (x, z, cr, ci, ka) of the groups of equal
    signatures (ka, kb), each group's live coefficients summed from +0.0 in
    input order, the groups with no live row or with hypot(re, im) <=
    zero_threshold dropped (None keeps every group with a live row), in
    order of their first live rows; x, z are those rows and ka their key.
    None where `check` finds a split run.

    perm: int32[T], the rows sorted stably by ka (sort_keys, K17) or, with
    check False, by (ka, kb) (torch_core.lexsort_keys); kas: int64[T], ka in
    that order; ka, kb: int64[T]; cr, ci: float64[T]; live: bool[T] or None
    (every row live); rows: the row source (row_source): the planes (x, z),
    int64[T, W]; a product's operands (x1, z1, x2, z2), int64[M1, W] and
    int64[M2, W] with T = M1 M2, row r = (x1[r // M2] ^ x2[r % M2], ...); a
    rotation's (x, z, xr, zr), int64[T / 2, W] and int64[W], row r = x[r mod
    T/2] ^ (xr if r >= T/2); masked (x, z, col_keep), int64[T, W] and
    int64[W], row r = x[r] & col_keep.  check: two adjacent sorted positions
    (live or dead) with equal ka and unequal kb, which a sort by ka alone
    leaves where two signatures share ka, return None (pass A only).  Bit
    for bit torch_core.merge_groups.  Two launches and one host read
    between them, the survivor count with the split report, which sizes
    the outputs (none for T = 0).  CUDA kernel: csrc/merge_groups.cu."""
    if perm.device.type == "cpu":
        from . import torch_core

        return torch_core.merge_groups(perm, kas, ka, kb, cr, ci, zero_threshold, rows, live,
                                       check)
    dev = perm.device
    if dev.type != "cuda":
        raise ValueError(f"merge_groups: unsupported device {dev}")
    _check("perm", perm, torch.int32, 1, dev)
    _check("kas", kas, torch.int64, 1, dev)
    T, W = _merge_operands("merge_groups", dev, ka, kb, cr, ci, rows, live, (kas, perm))
    if T >= 1 << 31:
        raise ValueError(f"merge_groups: {T} rows, at most 2^31 - 1")
    if T == 0:
        return _no_rows(W, dev)
    lib, stream = _lib(), _stream(dev)
    # the sums (re, im) and keep flags by input row, then the count
    scratch = torch.empty(2 * T + (T + 7) // 8 + 1, dtype=torch.int64, device=dev)
    sums, count = scratch.data_ptr(), scratch[-1:]
    _launch("merge_groups", lib.symmer_merge_groups_sums(
        perm.data_ptr(), kas.data_ptr(), kb.data_ptr(), cr.data_ptr(), ci.data_ptr(),
        None if live is None else live.data_ptr(), T, int(check), int(zero_threshold is not None),
        0.0 if zero_threshold is None else float(zero_threshold), sums + 16 * T, sums,
        count.data_ptr(), stream))
    n = int(count.item())  # the one host read: the survivors, and bit 32 a split run
    if n >> 32:
        return None
    planes = torch.empty((2, n, W), dtype=torch.int64, device=dev)
    out = torch.empty((3, n), dtype=torch.int64, device=dev)  # cr, ci (as bits), ka
    if n:
        status, epoch = _look_back_status(dev, stream, lib.symmer_merge_groups_tiles(T))
        o = out.data_ptr()
        _launch("merge_groups", lib.symmer_merge_groups_gather(
            sums + 16 * T, sums, ka.data_ptr(), T, W, *source_args(rows), epoch,
            status.data_ptr(), planes[0].data_ptr(), planes[1].data_ptr(), o, o + 8 * n,
            o + 16 * n, stream), call=False)
    c = out[:2].view(torch.float64)
    return planes[0], planes[1], c[0], c[1], out[2]


def merge_small(ka, kb, cr, ci, zero_threshold, rows, live=None):
    """The cleanup's merge of at most SMALL_ROWS slots in one launch, its own
    sort included: (x, z, cr, ci, ka) of the groups of equal signatures (ka,
    kb), each group's live coefficients summed from +0.0 in slot order, the
    groups with no live slot or with hypot(re, im) <= zero_threshold
    dropped (None keeps every group with a live slot), in order of their
    first live slots; x, z are those slots' rows and ka their key.

    ka, kb: int64[T]; cr, ci: float64[T]; live: bool[T] or None (every slot
    live); rows: the row source (row_source), as for merge_groups.  Bit for
    bit torch_core.merge_small, which is merge_groups after the stable sort
    by (ka, kb).  One launch (none for T = 0): one block, or a cluster of
    blocks that copy the rows where T W is large, and one host read after
    it, the survivor count.  One allocation of T rows, of which the outputs
    are views of the first n: a result kept alive keeps all T rows' memory
    (clone it to keep n).  T above SMALL_ROWS raises (the
    route for it is sort_keys, then merge_groups: torch_core._merge_sorted).
    CUDA kernel: csrc/merge_small.cu (K3's one-block route)."""
    if ka.device.type == "cpu":
        from . import torch_core

        return torch_core.merge_small(ka, kb, cr, ci, zero_threshold, rows, live)
    dev = ka.device
    if dev.type != "cuda":
        raise ValueError(f"merge_small: unsupported device {dev}")
    T, W = _merge_operands("merge_small", dev, ka, kb, cr, ci, rows, live)
    if T > SMALL_ROWS:
        raise ValueError(f"merge_small: {T} slots, at most {SMALL_ROWS}")
    if T == 0:
        return _no_rows(W, dev)
    # the planes (2, T, W), then cr, ci (as bits) and ka (3, T), then the
    # count; the outputs are strided views of it (few torch ops a call)
    buf = torch.empty(2 * T * W + 3 * T + 1, dtype=torch.int64, device=dev)
    b, o = buf.data_ptr(), 2 * T * W
    _launch("merge_small", _lib().symmer_merge_small(
        ka.data_ptr(), kb.data_ptr(), cr.data_ptr(), ci.data_ptr(),
        None if live is None else live.data_ptr(), T, int(zero_threshold is not None),
        0.0 if zero_threshold is None else float(zero_threshold), W, *source_args(rows),
        b, b + 8 * T * W, b + 8 * o, b + 8 * (o + T), b + 8 * (o + 2 * T),
        b + 8 * (o + 3 * T), _stream(dev)))
    return _small_outputs(buf, T, W)


def _small_outputs(buf, T: int, W: int) -> tuple:
    """(x, z, cr, ci, ka) of the first n rows, n read from the buffer's last
    word (the one host read), as views of a one-block merge's buffer: the
    planes (2, T, W), then cr, ci (as bits) and ka (T each)."""
    n, o = int(buf[-1].item()), 2 * T * W
    f = buf.view(torch.float64)
    return (buf.as_strided((n, W), (W, 1), 0), buf.as_strided((n, W), (W, 1), T * W),
            f.as_strided((n,), (1,), o), f.as_strided((n,), (1,), o + T),
            buf.as_strided((n,), (1,), o + 2 * T))


def small_fused(T: int, W: int) -> bool:
    """Whether a cleanup of T rows of W words, or a product of T pairs,
    takes the fused route (cleanup_small, product_small: its slots signed
    inside K3's one-block route, one launch): at most SMALL_ROWS slots and
    FUSED_WORDS slot-words.  Above, K2 or K4 signs them in a launch of its
    own and the merge follows (torch_core._merge_sorted).  A pure size rule:
    the budget is the measured crossover of the two routes on the card."""
    return T <= SMALL_ROWS and T * W <= FUSED_WORDS


def cleanup_small(x, z, cr, ci, zero_threshold):
    """The cleanup of at most SMALL_ROWS stored rows in one launch, the
    rows' signatures included: (x, z, cr, ci, ka) as merge_small gives it
    for the keys row_signature(x, z) and the planes' row source.

    x, z: int64[T, W]; cr, ci: float64[T].  Bit for bit
    torch_core.cleanup_small, which is merge_small after row_signature.  One
    launch (none for T = 0) and one host read after it, the survivor count;
    one allocation of T rows, of which the outputs are views of the first n
    (as merge_small).  T above SMALL_ROWS raises (small_fused sends larger
    cleanups to row_signature and the merge).  CUDA kernel:
    csrc/merge_small.cu (its fused route, symmer_sign_merge_small)."""
    if x.device.type == "cpu":
        from . import torch_core

        return torch_core.cleanup_small(x, z, cr, ci, zero_threshold)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"cleanup_small: unsupported device {dev}")
    for name, t, dt, nd in (("x", x, torch.int64, 2), ("z", z, torch.int64, 2),
                            ("cr", cr, torch.float64, 1), ("ci", ci, torch.float64, 1)):
        _check(name, t, dt, nd, dev)
    T, W = x.shape
    if z.shape != (T, W) or cr.shape != (T,) or ci.shape != (T,):
        raise ValueError("cleanup_small: operand shapes disagree")
    return _sign_merge_small("cleanup_small", PLANES, (x, z, cr, ci), T, W, 0, zero_threshold,
                             dev)


def product_small(x1, z1, cr1, ci1, x2, z2, cr2, ci2, zero_threshold):
    """The all-pairs product and its cleanup of at most SMALL_ROWS pairs in
    one launch, the pairs' signatures and coefficients included: (x, z, cr,
    ci, ka) as merge_small gives it for pair_products' outputs and the pair
    row source (x1, z1, x2, z2).

    x1, z1: int64[M1, W]; cr1, ci1: float64[M1]; the same for operand 2.
    Bit for bit torch_core.product_small, which is merge_small after
    pair_products.  One launch (none for an empty operand) and one host
    read; T = M1 M2 above SMALL_ROWS raises.  CUDA kernel:
    csrc/merge_small.cu (its fused route, symmer_sign_merge_small)."""
    if x1.device.type == "cpu":
        from . import torch_core

        return torch_core.product_small(x1, z1, cr1, ci1, x2, z2, cr2, ci2, zero_threshold)
    dev = x1.device
    if dev.type != "cuda":
        raise ValueError(f"product_small: unsupported device {dev}")
    for name, t, dt, nd in (
        ("x1", x1, torch.int64, 2), ("z1", z1, torch.int64, 2),
        ("cr1", cr1, torch.float64, 1), ("ci1", ci1, torch.float64, 1),
        ("x2", x2, torch.int64, 2), ("z2", z2, torch.int64, 2),
        ("cr2", cr2, torch.float64, 1), ("ci2", ci2, torch.float64, 1),
    ):
        _check(name, t, dt, nd, dev)
    M1, W = x1.shape
    M2 = x2.shape[0]
    if (z1.shape != (M1, W) or x2.shape != (M2, W) or z2.shape != (M2, W)
            or cr1.shape != (M1,) or ci1.shape != (M1,) or cr2.shape != (M2,)
            or ci2.shape != (M2,)):
        raise ValueError("product_small: operand shapes disagree")
    return _sign_merge_small("product_small", PAIRS, (x1, z1, cr1, ci1, x2, z2, cr2, ci2),
                             M1 * M2, W, M2, zero_threshold, dev)


def _sign_merge_small(name, kind, ops, T, W, M2, zero_threshold, dev) -> tuple:
    """One launch of the fused route over the checked operands `ops` of a
    cleanup (PLANES: x, z, cr, ci) or a product (PAIRS: operand 1's, then
    operand 2's): (x, z, cr, ci, ka) of its survivors."""
    if T > SMALL_ROWS:
        raise ValueError(f"{name}: {T} slots, at most {SMALL_ROWS}")
    if T == 0:
        return _no_rows(W, dev)
    p = [t.data_ptr() for t in ops] + [0] * (8 - len(ops))
    # the planes (2, T, W), then cr, ci (as bits) and ka (3, T), then each
    # slot's ka (the kernel's), then the count; the outputs are views of it
    buf = torch.empty(2 * T * W + 4 * T + 1, dtype=torch.int64, device=dev)
    b, o = buf.data_ptr(), 2 * T * W
    _launch("sign_merge_small", _lib().symmer_sign_merge_small(
        kind, *p, M2, T, W, int(zero_threshold is not None),
        0.0 if zero_threshold is None else float(zero_threshold), b, b + 8 * T * W, b + 8 * o,
        b + 8 * (o + T), b + 8 * (o + 2 * T), b + 8 * (o + 4 * T), b + 8 * (o + 3 * T),
        _stream(dev)))
    return _small_outputs(buf, T, W)


def rotation_rows(x, z, cr, ci, xr, zr, cos_t: float, sin_t: float):
    """(ka, kb, pr, pi, live) of the 2T slots of a non-Clifford rotation by
    the Pauli Q = (xr, zr), without the rotated rows: slot r is term r
    (signature of (x[r], z[r]), its coefficient times cos_t where it
    anticommutes with Q), slot T + r its P Q row (signature of (x[r] ^ xr,
    z[r] ^ zr), mul_single's coefficient times -i sin_t), live where the term
    anticommutes.

    x, z: int64[T, W]; cr, ci: float64[T]; xr, zr: int64[W].  Bit for bit
    torch_core.rotation_rows.  One launch (none for T = 0).  CUDA kernel:
    csrc/rotation_rows.cu."""
    if x.device.type == "cpu":
        from . import torch_core

        return torch_core.rotation_rows(x, z, cr, ci, xr, zr, cos_t, sin_t)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"rotation_rows: unsupported device {dev}")
    for name, t, dt, nd in (
        ("x", x, torch.int64, 2), ("z", z, torch.int64, 2),
        ("cr", cr, torch.float64, 1), ("ci", ci, torch.float64, 1),
        ("xr", xr, torch.int64, 1), ("zr", zr, torch.int64, 1),
    ):
        _check(name, t, dt, nd, dev)
    T, W = x.shape
    if (z.shape != (T, W) or cr.shape != (T,) or ci.shape != (T,) or xr.shape != (W,)
            or zr.shape != (W,)):
        raise ValueError("rotation_rows: operand shapes disagree")
    keys = torch.empty((2, 2 * T), dtype=torch.int64, device=dev)
    coeffs = torch.empty((2, 2 * T), dtype=torch.float64, device=dev)
    live = torch.empty(2 * T, dtype=torch.bool, device=dev)
    if T:
        k, c = keys.data_ptr(), coeffs.data_ptr()
        _launch("rotation_rows", _lib().symmer_rotation_rows(
            x.data_ptr(), z.data_ptr(), cr.data_ptr(), ci.data_ptr(), T, W, xr.data_ptr(),
            zr.data_ptr(), float(cos_t), float(sin_t), k, k + 16 * T, c, c + 16 * T,
            live.data_ptr(), _stream(dev)))
    return keys[0], keys[1], coeffs[0], coeffs[1], live


def project_rows(x, z, cr, ci, ac, neg_x, neg_z, col_keep):
    """(ka, kb, pr, pi, live) of a stabilizer-subspace projection's T slots,
    without the filtered rows: live where no entry of ac's row is set (the
    term commutes with every rotated stabilizer), the signature of (x &
    col_keep, z & col_keep), the coefficient times -1.0 where popc(x &
    neg_x) + popc(z & neg_z) is odd and +1.0 elsewhere.

    x, z: int64[T, W]; cr, ci: float64[T]; ac: bool[T, S] (anticommutes'
    output); neg_x, neg_z, col_keep: int64[W].  Bit for bit
    torch_core.project_rows.  One launch (none for T = 0).  CUDA kernel:
    csrc/project_rows.cu."""
    if x.device.type == "cpu":
        from . import torch_core

        return torch_core.project_rows(x, z, cr, ci, ac, neg_x, neg_z, col_keep)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"project_rows: unsupported device {dev}")
    for name, t, dt, nd in (
        ("x", x, torch.int64, 2), ("z", z, torch.int64, 2),
        ("cr", cr, torch.float64, 1), ("ci", ci, torch.float64, 1),
        ("ac", ac, torch.bool, 2), ("neg_x", neg_x, torch.int64, 1),
        ("neg_z", neg_z, torch.int64, 1), ("col_keep", col_keep, torch.int64, 1),
    ):
        _check(name, t, dt, nd, dev)
    T, W = x.shape
    if (z.shape != (T, W) or cr.shape != (T,) or ci.shape != (T,) or ac.shape[0] != T
            or any(t.shape != (W,) for t in (neg_x, neg_z, col_keep))):
        raise ValueError("project_rows: operand shapes disagree")
    keys = torch.empty((2, T), dtype=torch.int64, device=dev)
    coeffs = torch.empty((2, T), dtype=torch.float64, device=dev)
    live = torch.empty(T, dtype=torch.bool, device=dev)
    if T:
        k, c = keys.data_ptr(), coeffs.data_ptr()
        _launch("project_rows", _lib().symmer_project_rows(
            x.data_ptr(), z.data_ptr(), cr.data_ptr(), ci.data_ptr(), T, W, ac.data_ptr(),
            ac.shape[1], neg_x.data_ptr(), neg_z.data_ptr(), col_keep.data_ptr(), k, k + 8 * T,
            c, c + 8 * T, live.data_ptr(), _stream(dev)))
    return keys[0], keys[1], coeffs[0], coeffs[1], live


def expval(x, z, cr, ci, s, ar, ai):
    """(re, im) of <psi|O|psi> as 0-d float64 tensors, for a DEDUPLICATED
    state (one row per basis state: a probe pairs each target with one row).

    x, z: int64[T, W]; cr, ci: float64[T]; s: int64[B, W]; ar, ai:
    float64[B].  The terms' X parts are hashed (a first launch) and their
    hashes sorted here (torch.sort), then one launch groups the terms,
    builds the hash table, chooses the route on the card
    (torch_state.expval_route's rule), probes and sums.  No host round
    trip.  CUDA kernel: csrc/state_expval.cu."""
    from . import torch_state

    if x.device.type == "cpu":
        return torch_state.expval(x, z, cr, ci, s, ar, ai)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"expval: unsupported device {dev}")
    for name, t, dt, nd in (
        ("x", x, torch.int64, 2), ("z", z, torch.int64, 2),
        ("cr", cr, torch.float64, 1), ("ci", ci, torch.float64, 1),
        ("s", s, torch.int64, 2), ("ar", ar, torch.float64, 1),
        ("ai", ai, torch.float64, 1),
    ):
        _check(name, t, dt, nd, dev)
    T, W = x.shape
    B = s.shape[0]
    if (z.shape != (T, W) or cr.shape != (T,) or ci.shape != (T,)
            or s.shape != (B, W) or ar.shape != (B,) or ai.shape != (B,)):
        raise ValueError("expval: operand shapes disagree")
    if T == 0 or B == 0 or W == 0:
        out = torch.zeros(2, dtype=torch.float64, device=dev)
        return out[0], out[1]
    lib, cols = _lib(), _hash_columns(W, dev)
    hx = torch.empty(T, dtype=torch.int32, device=dev)
    _raise("expval", lib.symmer_state_hash(x.data_ptr(), T, W, cols.data_ptr(), hx.data_ptr(),
                                           _stream()))
    keys, order = torch.sort(hx, stable=True)
    capacity = torch_state.table_capacity(max(B, T))
    size = lib.symmer_state_expval_scratch(B, W, T, capacity, MAX_BLOCKS)
    scratch = torch.empty((size + 7) // 8, dtype=torch.int64, device=dev)
    out = torch.empty(2, dtype=torch.float64, device=dev)
    _launch("expval", lib.symmer_state_expval(
        s.data_ptr(), ar.data_ptr(), ai.data_ptr(), B, W, x.data_ptr(), z.data_ptr(),
        cr.data_ptr(), ci.data_ptr(), T, order.data_ptr(), keys.data_ptr(), cols.data_ptr(),
        scratch.data_ptr(), capacity, MAX_BLOCKS, out.data_ptr(), _stream(),
    ))
    return out[0], out[1]


@functools.lru_cache(maxsize=None)
def _hash_columns(W: int, dev: torch.device) -> torch.Tensor:
    from . import torch_state

    return torch_state.hash_columns(W).to(dev)


def brute_force_minimise(gmask, base, seg_off, n_free: int, n_cliques: int,
                         start: int = 0, stop: int = None):
    """(min energy, argmin index) of the noncontextual objective over the
    assignments start .. stop - 1 (default all 2**n_free), as 0-d tensors
    (float64, int64); ties go to the smaller index.  Each assignment's
    energy does not depend on the range, so the minimum over the minima of
    disjoint ranges is the full search's, bit for bit.

    gmask: int64[M], base: float64[M], seg_off: int64[n_cliques + 2], as
    torch_noncon.kernel_inputs builds them.  One launch: a prologue folds
    the signs and sorts the terms into buckets, then the split
    Walsh-Hadamard transform (split width: torch_noncon.MAX_SPLIT) over
    the range and its final fold.  CUDA kernel: csrc/noncon_brute.cu."""
    from . import torch_noncon

    if stop is None:
        stop = 1 << n_free
    if gmask.device.type == "cpu":
        return torch_noncon.brute_force_plain(gmask, base, seg_off, n_free, n_cliques,
                                              start=start, stop=stop)
    dev = gmask.device
    if dev.type != "cuda":
        raise ValueError(f"brute_force_minimise: unsupported device {dev}")
    for name, t, dt in (("gmask", gmask, torch.int64), ("base", base, torch.float64),
                        ("seg_off", seg_off, torch.int64)):
        _check(name, t, dt, 1, dev)
    M = gmask.shape[0]
    if not 1 <= n_free <= 31:
        raise ValueError(f"brute_force_minimise: n_free {n_free} not in [1, 31]")
    if not 0 <= start < stop <= 1 << n_free:
        raise ValueError(f"brute_force_minimise: range [{start}, {stop}) not in [0, 2^{n_free})")
    if base.shape != (M,) or seg_off.shape != (n_cliques + 2,):
        raise ValueError("brute_force_minimise: operand shapes disagree")
    # the kernel reads terms by these offsets: check them (a few bytes)
    off = seg_off.cpu()
    if int(off[0]) != 0 or int(off[-1]) != M or bool((off[1:] < off[:-1]).any()):
        raise ValueError("brute_force_minimise: seg_off is not a partition of the terms")
    n_lo = min(n_free, torch_noncon.MAX_SPLIT)
    n_segs = n_cliques + 1
    iscratch = torch.empty(M + 2 * ((n_segs << n_lo) + 1) + 1, dtype=torch.int32, device=dev)
    fscratch = torch.empty(M + MAX_BLOCKS + 1, dtype=torch.float64, device=dev)
    kscratch = torch.empty(MAX_BLOCKS + 1, dtype=torch.int64, device=dev)
    out_e, out_k = fscratch[-1:], kscratch[-1:]
    _launch("brute_force_minimise", _lib().symmer_noncon_brute(
        gmask.data_ptr(), base.data_ptr(), seg_off.data_ptr(), M, n_segs, n_free, n_lo,
        start, stop, iscratch.data_ptr(), fscratch.data_ptr(), fscratch[M:].data_ptr(),
        kscratch.data_ptr(), MAX_BLOCKS, out_e.data_ptr(), out_k.data_ptr(), _stream(),
    ))
    return out_e[0], out_k[0]


# column widths of the group_matvec kernel (a template parameter each)
MATVEC_WIDTHS = (8, 4, 2, 1)


def group_matvec(ux, off, z, ph, V, out=None, rows=None) -> torch.Tensor:
    """out[c, r] = sum_g D_g(r) * V[c, r ^ ux[g]]: H @ V in X-grouped form,
    with D_g(r) = sum_{t in g} ph[t] (-1)^{popcount(r & z[t])} recomputed
    from the terms (no table).

    ux: int64[G] with values in [0, 2^n); off: int32[G + 1], group g's terms
    are off[g] .. off[g + 1] - 1; z: int32[T] in [0, 2^n); ph:
    complex128[T]; V: complex128[b, 2^n]; rows: an optional (r0, r1), 0 <=
    r0 < r1 <= 2^n, to compute only out[:, r0:r1] (a mesh's row block),
    each row bit for bit the launch over all rows (the kernel keeps the
    tiles and slices of all 2^n rows); out: an optional complex128[b,
    r1 - r0] to write into.  For b in (1, 2, 4, 8) one launch, and a second
    that adds the partial sums of the group slices where the kernel cuts
    the groups to fill the card; wider blocks go in column chunks of those
    widths.  Deterministic (no atomics, a fixed order of terms, groups and
    slices).  CUDA kernel: csrc/lanczos_matvec.cu."""
    if V.device.type == "cpu":
        from . import torch_lanczos

        return torch_lanczos.terms_matvec(ux, off, z, ph, V, rows=rows)
    dev = V.device
    if dev.type != "cuda":
        raise ValueError(f"group_matvec: unsupported device {dev}")
    for name, t, dt, nd in (("ux", ux, torch.int64, 1), ("off", off, torch.int32, 1),
                            ("z", z, torch.int32, 1), ("ph", ph, torch.complex128, 1),
                            ("V", V, torch.complex128, 2)):
        _check(name, t, dt, nd, dev)
    G, T = ux.shape[0], z.shape[0]
    b, dim = V.shape
    if off.shape != (G + 1,) or ph.shape != (T,):
        raise ValueError("group_matvec: operand shapes disagree")
    if dim & (dim - 1) or dim > 1 << 31:
        raise ValueError(f"group_matvec: {dim} rows, expected a power of two up to 2^31")
    r0, r1 = (0, dim) if rows is None else (int(rows[0]), int(rows[1]))
    if not 0 <= r0 < r1 <= dim:
        raise ValueError(f"group_matvec: rows {rows} not a range of [0, {dim})")
    if out is None:
        out = torch.empty((b, r1 - r0), dtype=torch.complex128, device=dev)
    else:
        _check("out", out, torch.complex128, 2, dev)
        if out.shape != (b, r1 - r0):
            raise ValueError("group_matvec: out and V shapes disagree")
    if G == 0:
        return out.zero_()
    lib, c0, stream = _lib(), 0, _stream(dev)
    v_ptr, out_ptr = V.data_ptr(), out.data_ptr()
    while c0 < b:
        w = next(w for w in MATVEC_WIDTHS if w <= b - c0)
        slices = _matvec_slices(dim, w)
        part = _matvec_partials(slices * w * (r1 - r0) if slices > 1 else 0, dev, r0)
        err = lib.symmer_group_matvec(
            ux.data_ptr(), off.data_ptr(), z.data_ptr(), ph.data_ptr(), v_ptr + c0 * 16 * dim,
            out_ptr + c0 * 16 * (r1 - r0), part.data_ptr(), G, T, dim, w, r0, r1, stream)
        # the second launch adds the slices' partial sums
        _launch("group_matvec", err, n=2 if slices > 1 else 1, call=c0 == 0)
        c0 += w
    return out


@functools.lru_cache(maxsize=None)
def _matvec_slices(dim: int, b: int) -> int:
    """How many slices of the groups the matvec kernel adds up for b
    columns of dim rows (its second launch, when more than one)."""
    return int(_lib().symmer_group_matvec_slices(dim, b))


@functools.lru_cache(maxsize=16)
def _matvec_partials(n: int, dev: torch.device, r0: int) -> torch.Tensor:
    """Scratch for the slices' partial sums (n complex128), kept per size
    and first row: a mesh's row blocks each have their own."""
    return torch.empty(max(1, n), dtype=torch.complex128, device=dev)


@functools.lru_cache(maxsize=None)
def _step_partials(dim: int, dev: torch.device) -> torch.Tensor:
    """The grid route's chunk sums (two per 512-row chunk), kept per size."""
    return torch.empty(2 * max(1, dim // 512), dtype=torch.float64, device=dev)


@functools.lru_cache(maxsize=None)
def step_cluster() -> tuple:
    """(blocks, rows): the pass-1 step's thread-block cluster on the card, 16
    blocks where cudaOccupancyMaxActiveClusters admits them and 8
    otherwise, and the most rows its route takes (found once)."""
    blocks, rows = ctypes.c_int64(), ctypes.c_int64()
    _raise("lanczos_step", _lib().symmer_lanczos_step_cluster(ctypes.byref(blocks),
                                                              ctypes.byref(rows)))
    return blocks.value, rows.value


def lanczos_step_route(dim: int) -> str:
    """The pass-1 step's route for 2^n rows: "cluster" (one thread-block
    cluster holds the vector on chip) up to step_cluster()'s rows, "grid"
    (one cooperative launch) above; a size rule, the same for every step of
    a solve."""
    return "cluster" if dim <= step_cluster()[1] else "grid"


def _check_step(name, hv, v_prev, v_cur, alphas, betas, j):
    dev = hv.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for arg, t, dt in (("hv", hv, torch.complex128), ("v_prev", v_prev, torch.complex128),
                       ("v_cur", v_cur, torch.complex128), ("alphas", alphas, torch.float64),
                       ("betas", betas, torch.float64)):
        _check(arg, t, dt, 1, dev)
    dim = hv.shape[0]
    if v_prev.shape != (dim,) or v_cur.shape != (dim,) or betas.shape != alphas.shape:
        raise ValueError(f"{name}: operand shapes disagree")
    if dim & (dim - 1) or not 0 <= j < alphas.shape[0]:
        raise ValueError(f"{name}: {dim} rows (a power of two) and step {j} of {alphas.shape[0]}")
    return dim


def lanczos_step(hv, v_prev, v_cur, v_next, alphas, betas, j: int, route: str = None,
                 blocks: int = 0) -> None:
    """One step of pass 1 of the scalar recurrence, in place, as
    torch_lanczos.lanczos_step (bit for bit): w = hv - beta_{j-1} v_prev,
    alpha = Re <v_cur, w>, w -= alpha v_cur, beta = ||w||, alphas[j] and
    betas[j] set, v_next <- w / beta.  v_next may be v_prev (or another
    buffer, such as the next row of a kept basis); hv is scratch (the grid
    route leaves w there, the cluster route leaves it as it was).

    complex128[2^n] vectors, float64[k] scalars, all on the card; no host
    synchronisation.  One launch, by lanczos_step_route(2^n): one
    thread-block cluster that keeps v_cur and w in registers, its sums added
    across the cluster's blocks through distributed shared memory (up to
    2^15 rows with 16 blocks); or one cooperative launch whose sums add
    512-row chunk sums after a grid-wide barrier.  ``route`` forces "cluster" or "grid" and ``blocks`` a smaller
    cluster, for the tests and measurements.  A refused launch raises.
    CUDA kernel: csrc/lanczos_step.cu."""
    if hv.device.type == "cpu":
        from . import torch_lanczos

        return torch_lanczos.lanczos_step(hv, v_prev, v_cur, v_next, alphas, betas, j)
    dim = _check_step("lanczos_step", hv, v_prev, v_cur, alphas, betas, j)
    _check("v_next", v_next, torch.complex128, 1, hv.device)
    if v_next.shape != (dim,):
        raise ValueError("lanczos_step: operand shapes disagree")
    route = route or lanczos_step_route(dim)
    if route not in ("cluster", "grid"):
        raise ValueError(f"lanczos_step: route {route!r} is neither 'cluster' nor 'grid'")
    cluster = route == "cluster"
    part = _step_partials(dim, hv.device)
    _launch("lanczos_step", _lib().symmer_lanczos_step(
        hv.data_ptr(), v_prev.data_ptr(), v_cur.data_ptr(), v_next.data_ptr(),
        alphas.data_ptr(), betas.data_ptr(), j, part.data_ptr(), dim, int(cluster), blocks,
        _stream(hv.device)))


def lanczos_replay(hv, v_prev, v_cur, alphas, betas, j: int, S, y) -> None:
    """One step of pass 2 where the basis is not kept, in place, as
    torch_lanczos.lanczos_replay (bit for bit): y[e] += S[j, e] v_cur, then
    pass 1's vector operations from the stored scalars (v_prev <- v_{j+1});
    hv is only read.  S: float64[k', m], y: complex128[m, 2^n].  One launch,
    no sums, counted under its own key.  CUDA kernel: csrc/lanczos_step.cu."""
    if hv.device.type == "cpu":
        from . import torch_lanczos

        return torch_lanczos.lanczos_replay(hv, v_prev, v_cur, alphas, betas, j, S, y)
    dim = _check_step("lanczos_replay", hv, v_prev, v_cur, alphas, betas, j)
    _check("S", S, torch.float64, 2, hv.device)
    _check("y", y, torch.complex128, 2, hv.device)
    m = y.shape[0]
    if y.shape[1] != dim or S.shape[1] != m or not j < S.shape[0]:
        raise ValueError("lanczos_replay: operand shapes disagree")
    _launch("lanczos_replay", _lib().symmer_lanczos_replay(
        hv.data_ptr(), v_prev.data_ptr(), v_cur.data_ptr(), alphas.data_ptr(),
        betas.data_ptr(), j, S.data_ptr(), y.data_ptr(), m, dim, _stream(hv.device)))


def lanczos_ritz(basis, S, k_eff: int) -> torch.Tensor:
    """complex128[m, 2^n] Ritz vectors y[e] = sum_{j < k_eff} S[j, e] basis[j]
    from the Krylov basis that pass 1 kept, as torch_lanczos.ritz_from_basis
    (bit for bit: the terms added in the order j = 0, 1, ... from +0.0, so y
    is the replay's).  basis: complex128[>= k_eff, 2^n]; S: float64[>= k_eff,
    m].  One launch (none for m = 0).  CUDA kernel: csrc/lanczos_step.cu."""
    if basis.device.type == "cpu":
        from . import torch_lanczos

        return torch_lanczos.ritz_from_basis(basis, S, k_eff)
    dev = basis.device
    if dev.type != "cuda":
        raise ValueError(f"lanczos_ritz: unsupported device {dev}")
    _check("basis", basis, torch.complex128, 2, dev)
    _check("S", S, torch.float64, 2, dev)
    dim, m = basis.shape[1], S.shape[1]
    if dim & (dim - 1) or not 1 <= k_eff <= min(basis.shape[0], S.shape[0]):
        raise ValueError(f"lanczos_ritz: {dim} rows (a power of two) and {k_eff} terms of "
                         f"{basis.shape[0]} basis rows and {S.shape[0]} rows of S")
    y = torch.empty((m, dim), dtype=torch.complex128, device=dev)
    if m == 0:
        return y
    _launch("lanczos_ritz", _lib().symmer_lanczos_ritz(
        basis.data_ptr(), S.data_ptr(), y.data_ptr(), k_eff, m, dim, _stream(dev)))
    return y


def build_group_diagonals(gidx, z_int, phase_c, G: int, n_qubits: int) -> torch.Tensor:
    """complex128[G, 2^n] group-diagonal table, bit for bit
    torch_lanczos.build_group_diagonals (the phases added into a zeroed
    table at (gidx, z_int), then a Walsh-Hadamard transform of each row at
    h = 1, 2, 4, ...).

    gidx, z_int: int64[T] (unique pairs, gidx in [0, G), z_int in
    [0, 2^n)); phase_c: complex128[T].  The terms are sorted by table
    position here (torch.sort), then one launch per pass of
    torch_lanczos.fwht_passes; the first pass also scatters the phases.
    CUDA kernel: csrc/group_diag.cu."""
    from . import torch_lanczos

    if phase_c.device.type == "cpu":
        return torch_lanczos.build_group_diagonals(gidx, z_int, phase_c, G, n_qubits)
    dev = phase_c.device
    if dev.type != "cuda":
        raise ValueError(f"build_group_diagonals: unsupported device {dev}")
    for name, t, dt in (("gidx", gidx, torch.int64), ("z_int", z_int, torch.int64),
                        ("phase_c", phase_c, torch.complex128)):
        _check(name, t, dt, 1, dev)
    T = phase_c.shape[0]
    if gidx.shape != (T,) or z_int.shape != (T,):
        raise ValueError("build_group_diagonals: operand shapes disagree")
    if not 0 <= n_qubits <= 31:
        raise ValueError(f"build_group_diagonals: {n_qubits} qubits not in [0, 31]")
    dim = 1 << n_qubits
    S = torch.empty((G, dim), dtype=torch.complex128, device=dev)
    if G == 0:
        return S
    keys, order = torch.sort(gidx * dim + z_int)
    ph = phase_c[order]
    lib = _lib()
    for s, kb in torch_lanczos.fwht_passes(n_qubits):
        _launch("build_group_diagonals", lib.symmer_group_diag_pass(
            S.data_ptr(), G, n_qubits, s, kb, keys.data_ptr(), ph.data_ptr(), T, int(s == 0),
            _stream()))
    return S


def _state_rows(name: str, v: torch.Tensor, dev: torch.device) -> int:
    _check(name, v, torch.complex128, 1, dev)
    dim = v.shape[0]
    if dim < 2 or dim & (dim - 1):
        raise ValueError(f"{name}: {dim} rows, expected a power of two of at least 2")
    return dim


def _check_plan(name: str, plan, cs, dim: int, dev: torch.device) -> int:
    """The plan's generator count, after checking it against the state and
    the (cos, sin) pairs cs."""
    p = plan.plan
    if 1 << p.n_qubits != dim:
        raise ValueError(f"{name}: a plan for {p.n_qubits} qubits against {dim} rows")
    _check("plan.ints", plan.ints, torch.int64, 1, dev)
    _check("plan.ph", plan.ph, torch.float64, 2, dev)
    _check("cs", cs, torch.float64, 2, dev)
    P = p.gx.shape[0]
    if cs.shape != (P, 2):
        raise ValueError(f"{name}: cs has shape {tuple(cs.shape)}, expected ({P}, 2)")
    return P


def _sections(plan):
    """The offsets of the plan's int64 sections, as the kernels take them."""
    return (ctypes.c_int64 * len(plan.sections))(*plan.sections)


def vqe_runs(psi, plan, cs, out=None) -> torch.Tensor:
    """prod_k e^{i t_k G_k} psi (G_0 first) for the generators of `plan`
    (torch_vqe.RunPlan.on(device)), cs float64[P, 2] = (cos t_k, sin t_k).

    psi: complex128[2^n]; out: an optional complex128[2^n] to write into,
    psi itself for in place.  Bit for bit torch_vqe.rotate_runs, and so P
    sequential torch_vqe.rotate calls.  One cooperative launch, a grid
    barrier between the plan's runs; counted under "vqe_rotate".
    CUDA kernel: csrc/vqe_rotate.cu."""
    if psi.device.type == "cpu":
        from . import torch_vqe

        res = torch_vqe.rotate_runs(psi, plan.plan, cs)
        return res if out is None else out.copy_(res)
    dev = psi.device
    if dev.type != "cuda":
        raise ValueError(f"vqe_runs: unsupported device {dev}")
    dim = _state_rows("psi", psi, dev)
    _check_plan("vqe_runs", plan, cs, dim, dev)
    if out is None:
        out = torch.empty_like(psi)
    else:
        _check("out", out, torch.complex128, 1, dev)
        if out.shape != psi.shape:
            raise ValueError("vqe_runs: out and psi shapes disagree")
    R = plan.plan.n_runs
    if R == 0:
        return out if out.data_ptr() == psi.data_ptr() else out.copy_(psi)
    _launch("vqe_rotate", _lib().symmer_vqe_runs(
        psi.data_ptr(), out.data_ptr(), dim, plan.plan.tile_bits, R, plan.ints.data_ptr(),
        _sections(plan), plan.ph.data_ptr(), cs.data_ptr(), _stream(dev)))
    return out


def vqe_adjoint(psi, lam, plan, cs) -> torch.Tensor:
    """complex128[P]: the adjoint sweep's overlaps ov_k = <lam_k| G_k |psi_k>
    for k = P-1 .. 0, psi_k and lam_k un-rotated by U_{P-1} .. U_{k+1}; the
    gradient of <psi| H |psi> is -2 Im ov for lam = H psi.

    psi, lam: complex128[2^n]; on the card the sweep runs in place and
    leaves both vectors un-rotated down to U_1 (the CPU path leaves them as
    they were); plan, cs as vqe_runs.  Bit for bit
    torch_vqe.adjoint_sweep.  One cooperative launch, then one for the
    totals; counted under "vqe_adjoint".  CUDA kernel: csrc/vqe_rotate.cu."""
    if psi.device.type == "cpu":
        from . import torch_vqe

        return torch_vqe.adjoint_sweep(psi, lam, plan.plan, cs)
    dev = psi.device
    if dev.type != "cuda":
        raise ValueError(f"vqe_adjoint: unsupported device {dev}")
    dim = _state_rows("psi", psi, dev)
    _check("lam", lam, torch.complex128, 1, dev)
    if lam.shape != psi.shape or lam.data_ptr() == psi.data_ptr():
        raise ValueError("vqe_adjoint: lam must be another vector of psi's shape")
    P = _check_plan("vqe_adjoint", plan, cs, dim, dev)
    ov = torch.empty(P, dtype=torch.complex128, device=dev)
    if P == 0:
        return ov
    part = torch.empty(2 * P * plan.plan.n_cosets, dtype=torch.float64, device=dev)
    _launch("vqe_adjoint", _lib().symmer_vqe_adjoint(
        psi.data_ptr(), lam.data_ptr(), dim, plan.plan.tile_bits, plan.plan.n_runs,
        plan.ints.data_ptr(), _sections(plan), plan.ph.data_ptr(), cs.data_ptr(), P,
        part.data_ptr(), ov.data_ptr(), _stream(dev)), n=2)
    return ov


@functools.lru_cache(maxsize=64)
def _rotation_plan(n: int, x: int, z: int, phr: float, phi: float, dev: torch.device):
    from . import torch_vqe

    return torch_vqe.plan_runs([x], [z], [complex(phr, phi)], n).on(dev)


def vqe_rotate(psi, x: int, z: int, phr: float, phi: float, c: float, s: float,
               out=None) -> torch.Tensor:
    """e^{i t G} psi for one generator G = ph (-1)^{popcount(r & z)} X^x with
    ph = phr + i phi = (-i)^{|Y|} c_G, c_G real +-1, and (c, s) = (cos t,
    sin t):  out[r] = c psi[r] + i s ph (-1)^{popcount(r & z)} psi[r ^ x].

    psi: complex128[2^n]; x, z ints in [0, 2^n); out: an optional
    complex128[2^n], not psi, to write into.  Bit for bit torch_vqe.rotate.
    The one-generator case of vqe_runs (its plan cached per generator): one
    launch.  CUDA kernel: csrc/vqe_rotate.cu."""
    if psi.device.type == "cpu":
        from . import torch_vqe

        res = torch_vqe.rotate(psi, x, z, phr, phi, c, s)
        return res if out is None else out.copy_(res)
    dev = psi.device
    if dev.type != "cuda":
        raise ValueError(f"vqe_rotate: unsupported device {dev}")
    dim = _state_rows("psi", psi, dev)
    if not (0 <= x < dim and 0 <= z < dim):
        raise ValueError(f"vqe_rotate: x = {x}, z = {z} not in [0, {dim})")
    if out is not None and out.data_ptr() == psi.data_ptr():
        raise ValueError("vqe_rotate: out must be another vector of psi's shape")
    plan = _rotation_plan(dim.bit_length() - 1, int(x), int(z), float(phr), float(phi), dev)
    cs = torch.tensor([[c, s]], dtype=torch.float64, device=dev)
    return vqe_runs(psi, plan, cs, out=out)


def overlap_groups(xs, dim: int, device) -> tuple:
    """(ux, off, order) int64 tensors on `device`: the Paulis' X parts (taken
    modulo dim) grouped on the host, as pauli_overlaps takes them
    (torch_vqe.x_groups)."""
    from . import torch_vqe

    if isinstance(xs, torch.Tensor):
        xs = xs.cpu().numpy()
    xs = np.asarray(xs, np.int64) & (dim - 1)
    return tuple(torch.as_tensor(a, device=device) for a in torch_vqe.x_groups(xs))


def pauli_overlaps(a, b, xs, zs, ph, groups, out=None) -> torch.Tensor:
    """complex128[N]: out_i = <a| P_i |b> = ph_i sum_r (-1)^{popcount(r &
    z_i)} conj(a[r]) b[r ^ x_i], the sum over the rows in the pairwise order
    of torch_lanczos.pairwise_sum, ph_i applied once.

    a, b: complex128[2^n]; xs, zs: int64[N], x taken modulo 2^n; ph:
    float64[N, 2] (re, im); groups: the Paulis grouped by x
    (overlap_groups(xs, 2^n, device)); out: an optional complex128[N] to
    write into.  Bit for bit
    torch_vqe.pauli_overlaps.  Two launches (a block per X group and chunk
    of rows, then a block per Pauli adds the chunk sums), no atomics.  CUDA
    kernel: csrc/pauli_overlaps.cu."""
    if a.device.type == "cpu":
        from . import torch_vqe

        res = torch_vqe.pauli_overlaps(a, b, xs, zs, ph)
        return res if out is None else out.copy_(res)
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"pauli_overlaps: unsupported device {dev}")
    dim = _state_rows("a", a, dev)
    _check("b", b, torch.complex128, 1, dev)
    for name, t in (("xs", xs), ("zs", zs)):
        _check(name, t, torch.int64, 1, dev)
    _check("ph", ph, torch.float64, 2, dev)
    N = xs.shape[0]
    if b.shape != a.shape or zs.shape != (N,) or ph.shape != (N, 2):
        raise ValueError("pauli_overlaps: operand shapes disagree")
    if out is None:
        out = torch.empty(N, dtype=torch.complex128, device=dev)
    else:
        _check("out", out, torch.complex128, 1, dev)
        if out.shape != (N,):
            raise ValueError("pauli_overlaps: out has the wrong shape")
    if N == 0:
        return out
    ux, off, order = groups
    for name, t in (("ux", ux), ("off", off), ("order", order)):
        _check(name, t, torch.int64, 1, dev)
    G = ux.shape[0]
    if off.shape != (G + 1,) or order.shape != (N,):
        raise ValueError("pauli_overlaps: groups disagree with the Paulis")
    lib = _lib()
    part = torch.empty(2 * N * lib.symmer_pauli_overlaps_chunks(dim, G), dtype=torch.float64,
                       device=dev)
    _launch("pauli_overlaps", lib.symmer_pauli_overlaps(
        a.data_ptr(), b.data_ptr(), dim, ux.data_ptr(), off.data_ptr(), order.data_ptr(), G,
        zs.data_ptr(), ph.data_ptr(), N, part.data_ptr(), out.data_ptr(), _stream(dev)), n=2)
    return out


def gf2_rref(M, stats: dict = None) -> torch.Tensor:
    """GF(2) row-reduced echelon form of M (int64[R, W] packed rows) in
    place, without reordering: in row order a nonzero row pivots on its
    lowest set bit and is XORed into every other row holding it.  Returns
    M; bit for bit torch_gf2.rref.  One cooperative launch: a blocked
    elimination of up to 64 pivots a pass.  `stats`, if given, gets
    "passes": a one-element int64 tensor on M's device holding the launch's
    passes once it has run.  CUDA kernel: csrc/gf2_rref.cu."""
    if M.device.type == "cpu":
        from . import torch_gf2

        return torch_gf2.rref(M)
    dev = M.device
    if dev.type != "cuda":
        raise ValueError(f"gf2_rref: unsupported device {dev}")
    _check("M", M, torch.int64, 2, dev)
    R, W = M.shape
    if R and W:
        lib = _lib()
        scratch = torch.empty((lib.symmer_gf2_rref_scratch(R, W) + 7) // 8, dtype=torch.int64,
                              device=dev)
        _launch("gf2_rref", lib.symmer_gf2_rref(M.data_ptr(), R, W, scratch.data_ptr(),
                                                _stream(dev)))
        if stats is not None:
            stats["passes"] = scratch[2:3]
    return M


def _span(t: torch.Tensor) -> tuple:
    """The byte range [start, end) of a contiguous tensor's memory."""
    a = t.data_ptr()
    return a, a + t.numel() * t.element_size()


# the scratch of the decoupled look-back (csrc/look_back.cuh) that
# route_rows and merge_groups share, per (device, stream):
# an int64 tensor whose word 0 is the ticket counter and whose other words
# are the tiles' status words, and the epoch of the last call on it
_look_back_scratch = {}


def _look_back_status(dev: torch.device, stream: int, tiles: int):
    """(scratch, epoch) for a route_rows or merge_groups (pass B) call of
    `tiles` tiles on `stream`.

    Each call gets the next epoch, which tags its status words, so the words
    of earlier calls never need a reset; when the epoch would leave the
    kernel's 30 bits the words are zeroed (stream-ordered) and it starts
    again at 1.  A larger scratch replaces a smaller one (a new one starts
    zeroed: the ticket 0, no status published)."""
    entry = _look_back_scratch.get((dev.index, stream))
    if entry is None or entry[0].numel() < tiles + 1:
        entry = [torch.zeros(max(tiles + 1, 1024), dtype=torch.int64, device=dev), 0]
        _look_back_scratch[(dev.index, stream)] = entry
    entry[1] += 1
    if entry[1] >= 1 << 30:
        entry[0].zero_()
        entry[1] = 1
    return entry[0], entry[1]


def route_rows(x, z, cr, ci, key, k: int, bit: int, keep, send) -> torch.Tensor:
    """One round of the mesh's exchange on one shard: rows whose key has bit
    k equal to `bit` are kept, the others sent.  Writes the kept rows, in
    input order, to the front of the keep buffers and the sent rows, in
    input order, to the front of the send buffers; returns int64[2] (kept,
    sent) on the rows' device.

    x, z: int64[n, W]; cr, ci: float64[n]; key: int64[n]; keep and send:
    (x, z, cr, ci) buffers of at least n rows that overlap no input.  Bit
    for bit torch_core.route_rows.  One launch (a decoupled look-back over
    tiles of rows; its status words live in a scratch kept per device and
    stream, `_look_back_status`).  CUDA kernel: csrc/route_rows.cu."""
    if x.device.type == "cpu":
        from . import torch_core

        return torch_core.route_rows(x, z, cr, ci, key, k, bit, keep, send)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"route_rows: unsupported device {dev}")
    n, W = x.shape
    for name, t, dt, nd in (("x", x, torch.int64, 2), ("z", z, torch.int64, 2),
                            ("cr", cr, torch.float64, 1), ("ci", ci, torch.float64, 1),
                            ("key", key, torch.int64, 1)):
        _check(name, t, dt, nd, dev)
    if z.shape != (n, W) or cr.shape != (n,) or ci.shape != (n,) or key.shape != (n,):
        raise ValueError("route_rows: operand shapes disagree")
    if not 0 <= k < 63 or bit not in (0, 1):
        raise ValueError(f"route_rows: bit {k} of the key, own bit {bit}")
    if n >= 1 << 31:
        raise ValueError(f"route_rows: {n} rows, at most 2^31 - 1")
    inputs = [_span(a) for a in (x, z, cr, ci, key) if a.numel()]
    for side, bufs in (("keep", keep), ("send", send)):
        for name, t, dt, nd in zip(("x", "z", "cr", "ci"), bufs,
                                   (torch.int64, torch.int64, torch.float64, torch.float64),
                                   (2, 2, 1, 1)):
            _check(f"{side}.{name}", t, dt, nd, dev)
            if t.shape[0] < n or (nd == 2 and t.shape[1] != W):
                raise ValueError(f"route_rows: {side}.{name} holds fewer than {n} rows of {W}")
            if t.numel():
                a0, a1 = _span(t)
                if any(a0 < b1 and b0 < a1 for b0, b1 in inputs):
                    raise ValueError(f"route_rows: {side}.{name} overlaps an input")
    if n == 0:
        return torch.zeros(2, dtype=torch.int64, device=dev)
    counts = torch.empty(2, dtype=torch.int64, device=dev)  # the last tile writes both
    lib, stream = _lib(), _stream(dev)
    scratch, epoch = _look_back_status(dev, stream, lib.symmer_route_rows_tiles(n))
    _launch("route_rows", lib.symmer_route_rows(
        x.data_ptr(), z.data_ptr(), cr.data_ptr(), ci.data_ptr(), key.data_ptr(), n, W, k, bit,
        epoch, scratch.data_ptr(), *(t.data_ptr() for t in keep),
        *(t.data_ptr() for t in send), counts.data_ptr(), stream))
    return counts
