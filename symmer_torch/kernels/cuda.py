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
           "pauli_overlaps.cu", "gf2_rref.cu")
# headers the sources include (part of the library's digest)
HEADERS = ("pairwise_sum.cuh",)
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")

launches = {"anticommutes": 0, "clifford_scan": 0, "expval": 0, "brute_force_minimise": 0,
            "group_matvec": 0, "build_group_diagonals": 0, "lanczos_step": 0,
            "lanczos_replay": 0, "vqe_rotate": 0, "vqe_adjoint": 0, "pauli_overlaps": 0,
            "gf2_rref": 0}
# wrapper calls that launched, per launch key (one call may launch several times)
calls = dict.fromkeys(launches, 0)
# block partials of the two-pass reductions (expval, brute_force_minimise)
MAX_BLOCKS = 4096
# nvcc's stderr of the last build (ptxas register / shared-memory report)
build_log = ""


def reset_launches() -> None:
    for name in launches:
        launches[name] = calls[name] = 0


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
    lib.symmer_noncon_brute.argtypes = [p, p, p, i64, i64, i64, i64, p, p, p, p, i64, p, p, p]
    lib.symmer_noncon_brute.restype = ctypes.c_int
    lib.symmer_group_matvec.argtypes = [p, p, p, p, p, p, p, i64, i64, i64, i64, p]
    lib.symmer_group_matvec_slices.argtypes = [i64, i64]
    lib.symmer_group_matvec_slices.restype = i64
    lib.symmer_group_matvec.restype = ctypes.c_int
    lib.symmer_group_diag_pass.argtypes = [p, i64, i64, i64, i64, p, p, i64, i64, p]
    lib.symmer_group_diag_pass.restype = ctypes.c_int
    lib.symmer_lanczos_step.argtypes = [p, p, p, p, p, i64, p, i64, p]
    lib.symmer_lanczos_step.restype = ctypes.c_int
    lib.symmer_lanczos_replay.argtypes = [p, p, p, p, p, i64, p, p, i64, i64, p]
    lib.symmer_lanczos_replay.restype = ctypes.c_int
    i32, sec = ctypes.c_int, ctypes.POINTER(ctypes.c_int64)
    lib.symmer_vqe_runs.argtypes = [p, p, i64, i32, i32, p, sec, p, p, p]
    lib.symmer_vqe_runs.restype = ctypes.c_int
    lib.symmer_vqe_adjoint.argtypes = [p, p, i64, i32, i32, p, sec, p, p, i64, p, p, p]
    lib.symmer_vqe_adjoint.restype = ctypes.c_int
    lib.symmer_pauli_overlaps_chunks.argtypes = [i64, i64]
    lib.symmer_pauli_overlaps_chunks.restype = i64
    lib.symmer_pauli_overlaps.argtypes = [p, p, i64, p, p, p, i64, p, p, i64, p, p, p]
    lib.symmer_pauli_overlaps.restype = ctypes.c_int
    lib.symmer_gf2_rref.argtypes = [p, i64, i64, p]
    lib.symmer_gf2_rref.restype = ctypes.c_int
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


def brute_force_minimise(gmask, base, seg_off, n_free: int, n_cliques: int):
    """(min energy, argmin index) of the noncontextual objective over all
    2**n_free assignments, as 0-d tensors (float64, int64); ties go to the
    smaller index.

    gmask: int64[M], base: float64[M], seg_off: int64[n_cliques + 2], as
    torch_noncon.kernel_inputs builds them.  One launch: a prologue folds
    the signs and sorts the terms into buckets, then the split
    Walsh-Hadamard transform (split width: torch_noncon.MAX_SPLIT) and
    its final fold.  CUDA kernel: csrc/noncon_brute.cu."""
    from . import torch_noncon

    if gmask.device.type == "cpu":
        return torch_noncon.brute_force_plain(gmask, base, seg_off, n_free, n_cliques)
    dev = gmask.device
    if dev.type != "cuda":
        raise ValueError(f"brute_force_minimise: unsupported device {dev}")
    for name, t, dt in (("gmask", gmask, torch.int64), ("base", base, torch.float64),
                        ("seg_off", seg_off, torch.int64)):
        _check(name, t, dt, 1, dev)
    M = gmask.shape[0]
    if not 1 <= n_free <= 31:
        raise ValueError(f"brute_force_minimise: n_free {n_free} not in [1, 31]")
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
        iscratch.data_ptr(), fscratch.data_ptr(), fscratch[M:].data_ptr(),
        kscratch.data_ptr(), MAX_BLOCKS, out_e.data_ptr(), out_k.data_ptr(), _stream(),
    ))
    return out_e[0], out_k[0]


# column widths of the group_matvec kernel (a template parameter each)
MATVEC_WIDTHS = (8, 4, 2, 1)


def group_matvec(ux, off, z, ph, V, out=None) -> torch.Tensor:
    """out[c, r] = sum_g D_g(r) * V[c, r ^ ux[g]]: H @ V in X-grouped form,
    with D_g(r) = sum_{t in g} ph[t] (-1)^{popcount(r & z[t])} recomputed
    from the terms (no table).

    ux: int64[G] with values in [0, 2^n); off: int32[G + 1], group g's terms
    are off[g] .. off[g + 1] - 1; z: int32[T] in [0, 2^n); ph:
    complex128[T]; V: complex128[b, 2^n]; out: an optional complex128[b,
    2^n] to write into.  For b in (1, 2, 4, 8) one launch, and a second that
    adds the partial sums of the group slices where the kernel cuts the
    groups to fill the card; wider blocks go in column chunks of those
    widths.  Deterministic (no atomics, a fixed order of terms, groups and
    slices).  CUDA kernel: csrc/lanczos_matvec.cu."""
    if V.device.type == "cpu":
        from . import torch_lanczos

        return torch_lanczos.terms_matvec(ux, off, z, ph, V)
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
    if out is None:
        out = torch.empty((b, dim), dtype=torch.complex128, device=dev)
    else:
        _check("out", out, torch.complex128, 2, dev)
        if out.shape != V.shape:
            raise ValueError("group_matvec: out and V shapes disagree")
    if G == 0:
        return out.zero_()
    lib, c0, stream = _lib(), 0, _stream(dev)
    v_ptr, out_ptr, col = V.data_ptr(), out.data_ptr(), 16 * dim
    while c0 < b:
        w = next(w for w in MATVEC_WIDTHS if w <= b - c0)
        slices = _matvec_slices(dim, w)
        part = _matvec_partials(slices * w * dim if slices > 1 else 0, dev)
        err = lib.symmer_group_matvec(
            ux.data_ptr(), off.data_ptr(), z.data_ptr(), ph.data_ptr(), v_ptr + c0 * col,
            out_ptr + c0 * col, part.data_ptr(), G, T, dim, w, stream)
        # the second launch adds the slices' partial sums
        _launch("group_matvec", err, n=2 if slices > 1 else 1, call=c0 == 0)
        c0 += w
    return out


@functools.lru_cache(maxsize=None)
def _matvec_slices(dim: int, b: int) -> int:
    """How many slices of the groups the matvec kernel adds up for b
    columns of dim rows (its second launch, when more than one)."""
    return int(_lib().symmer_group_matvec_slices(dim, b))


@functools.lru_cache(maxsize=8)
def _matvec_partials(n: int, dev: torch.device) -> torch.Tensor:
    """Scratch for the slices' partial sums (n complex128), kept per size."""
    return torch.empty(max(1, n), dtype=torch.complex128, device=dev)


@functools.lru_cache(maxsize=None)
def _step_partials(dim: int, dev: torch.device) -> torch.Tensor:
    """The step kernel's chunk sums (two per 512-row chunk), kept per size."""
    return torch.empty(2 * max(1, dim // 512), dtype=torch.float64, device=dev)


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


def lanczos_step(hv, v_prev, v_cur, alphas, betas, j: int) -> None:
    """One step of pass 1 of the scalar recurrence, in place, as
    torch_lanczos.lanczos_step (bit for bit): w = hv - beta_{j-1} v_prev,
    alpha = Re <v_cur, w>, w -= alpha v_cur, beta = ||w||, alphas[j] and
    betas[j] set, v_prev <- w / beta; hv holds w on return.

    complex128[2^n] vectors, float64[k] scalars, all on the card; no host
    synchronisation.  One cooperative launch: the two sums are pairwise
    trees over 512-row chunks, each block adding the chunk sums in the same
    order after a grid-wide barrier.  CUDA kernel: csrc/lanczos_step.cu."""
    if hv.device.type == "cpu":
        from . import torch_lanczos

        return torch_lanczos.lanczos_step(hv, v_prev, v_cur, alphas, betas, j)
    dim = _check_step("lanczos_step", hv, v_prev, v_cur, alphas, betas, j)
    part = _step_partials(dim, hv.device)
    _launch("lanczos_step", _lib().symmer_lanczos_step(
        hv.data_ptr(), v_prev.data_ptr(), v_cur.data_ptr(), alphas.data_ptr(),
        betas.data_ptr(), j, part.data_ptr(), dim, _stream(hv.device)))


def lanczos_replay(hv, v_prev, v_cur, alphas, betas, j: int, S, y) -> None:
    """One step of pass 2, in place, as torch_lanczos.lanczos_replay (bit
    for bit): y[e] += S[j, e] v_cur, then pass 1's vector operations from
    the stored scalars (v_prev <- v_{j+1}); hv is only read.  S:
    float64[k', m], y: complex128[m, 2^n].  One launch, no sums, counted
    under its own key.  CUDA kernel: csrc/lanczos_step.cu."""
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


def gf2_rref(M) -> torch.Tensor:
    """GF(2) row-reduced echelon form of M (int64[R, W] packed rows) in
    place, without reordering: in row order a nonzero row pivots on its
    lowest set bit and is XORed into every other row holding it.  Returns
    M; bit for bit torch_gf2.rref.  One cooperative launch.  CUDA kernel:
    csrc/gf2_rref.cu."""
    if M.device.type == "cpu":
        from . import torch_gf2

        return torch_gf2.rref(M)
    dev = M.device
    if dev.type != "cuda":
        raise ValueError(f"gf2_rref: unsupported device {dev}")
    _check("M", M, torch.int64, 2, dev)
    R, W = M.shape
    if R and W:
        _launch("gf2_rref", _lib().symmer_gf2_rref(M.data_ptr(), R, W, _stream(dev)))
    return M
