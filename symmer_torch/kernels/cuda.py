"""Hand-written Hopper kernels: build, ctypes binding, wrappers, launch counts.

The CUDA C++ sources live in ``symmer_torch/csrc``.  On first use they are
compiled with ``nvcc`` for ``sm_90a`` (one process per source, in parallel)
and linked into one shared library with a plain C interface under
``build/symmer_torch/`` (beside the package; the file name
carries a digest of the sources and flags, so an edited source rebuilds) and
loaded with ctypes.

Each wrapper takes the kernel's plain torch version (kernels/torch_core.py,
torch_state.py, torch_noncon.py, torch_lanczos.py) only for CPU tensors.  For CUDA tensors it checks device, dtype, shape and
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
SOURCES = ("anticommutes.cu", "clifford_scan.cu", "state_expval.cu", "noncon_brute.cu",
           "lanczos_matvec.cu", "group_diag.cu", "lanczos_step.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")

launches = {"anticommutes": 0, "clifford_scan": 0, "expval": 0, "brute_force_minimise": 0,
            "group_matvec": 0, "build_group_diagonals": 0, "lanczos_step": 0,
            "lanczos_replay": 0}
# block partials of the two-pass reductions (expval, brute_force_minimise)
MAX_BLOCKS = 4096
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
    h = hashlib.sha1(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for name in SOURCES:
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


def _launch(name: str, err: int) -> None:
    _raise(name, err)
    launches[name] += 1


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
        _launch("group_matvec", err)
        if slices > 1:  # the second launch adds the slices' partial sums
            launches["group_matvec"] += 1
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
