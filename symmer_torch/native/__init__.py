"""ctypes bindings for the native host kernels (gf2core.cpp).

Compiled lazily on first import, cached as libgf2core-<cpu-key>.so next to
the source (the key fingerprints the host CPU features: -march=native code
must never be dlopen'd by a different host). All callers fall back to the
pure-numpy implementations if compilation is unavailable, so the native
module is a performance optimisation, not a hard dependency.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import warnings

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "gf2core.cpp")


def _host_key() -> str:
    """Short fingerprint of this host's CPU features.

    The library is compiled with ``-march=native`` (2.2x on the popcount-
    heavy Clifford kernels via AVX-512 VPOPCNTDQ where available), so a .so
    cached on a shared filesystem must never be dlopen'd by a host with a
    different ISA -- the feature-keyed filename forces a local rebuild
    instead of a SIGILL.
    """
    import hashlib

    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return hashlib.sha1(line.encode()).hexdigest()[:12]
    except OSError:
        pass
    import platform

    return hashlib.sha1(
        (platform.machine() + platform.processor()).encode()
    ).hexdigest()[:12]


_LIB = os.path.join(_HERE, f"libgf2core-{_host_key()}.so")


def _build() -> bool:
    if os.path.exists(_LIB) and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC):
        return True
    # compile to a unique temp name and rename into place: POSIX rename is
    # atomic, so concurrent builders (pytest-xdist, multi-host launches on a
    # shared filesystem) never dlopen a partially written .so.  uuid4 rather
    # than pid: pids collide ACROSS hosts on a shared filesystem
    import uuid

    tmp = f"{_LIB}.{uuid.uuid4().hex}"
    try:
        # -ffp-contract=off: g++ -O3 contracts a*b-c*d into FMA, which
        # drifts one ulp from numpy's separate multiply+subtract; the
        # host kernels must be bit-identical to the packed-numpy oracle.
        # -march=native vectorises the popcount inner loops (AVX-512
        # VPOPCNTDQ: measured 2.2x on clifford_rotate_sequence); it does
        # NOT reassociate floats, so bit-identity holds.  Retry without it
        # for toolchains/targets that reject the flag.
        base = ["g++", "-O3", "-ffp-contract=off", "-shared", "-fPIC",
                "-std=c++17", _SRC, "-o", tmp]
        try:
            subprocess.run(base[:2] + ["-march=native"] + base[2:],
                           check=True, capture_output=True, timeout=120)
        except (subprocess.CalledProcessError, subprocess.TimeoutExpired):
            subprocess.run(base, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
        return True
    except Exception as exc:  # pragma: no cover
        warnings.warn(f"symmer_torch native build failed ({exc}); using numpy fallbacks")
        return False
    finally:
        if os.path.exists(tmp):  # pragma: no cover
            try:
                os.unlink(tmp)
            except OSError:
                pass


class _GF2Core:
    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.rref_inplace.argtypes = [u64p, ctypes.c_int64, ctypes.c_int64]
        lib.rref_inplace.restype = None
        lib.unique_rows.argtypes = [u64p, ctypes.c_int64, ctypes.c_int64, i64p, i64p]
        lib.unique_rows.restype = ctypes.c_int64
        lib.matmul_gf2.argtypes = [
            u64p, ctypes.c_int64, u64p, ctypes.c_int64, ctypes.c_int64, u8p,
        ]
        lib.matmul_gf2.restype = None
        lib.transpose_bits.argtypes = [
            u64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            u64p, ctypes.c_int64,
        ]
        lib.transpose_bits.restype = None
        lib.qwc_matrix.argtypes = [
            u64p, u64p, ctypes.c_int64, u64p, u64p, ctypes.c_int64,
            ctypes.c_int64, u8p,
        ]
        lib.qwc_matrix.restype = None
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.clifford_rotate_inplace.argtypes = [
            u64p, u64p, f64p, ctypes.c_int64, ctypes.c_int64,
            u64p, u64p, ctypes.c_int64,
        ]
        lib.clifford_rotate_inplace.restype = None
        lib.mul_pairs.argtypes = [
            u64p, u64p, f64p, ctypes.c_int64,
            u64p, u64p, f64p, ctypes.c_int64,
            ctypes.c_int64, u64p, u64p, f64p,
        ]
        lib.mul_pairs.restype = None
        lib.cleanup_rows.argtypes = [
            u64p, f64p, ctypes.c_int64, ctypes.c_int64, u64p, f64p,
        ]
        lib.cleanup_rows.restype = ctypes.c_int64
        lib.rotate_nonclifford_cleanup.argtypes = [
            u64p, u64p, f64p, ctypes.c_int64, ctypes.c_int64,
            u64p, u64p, ctypes.c_double, ctypes.c_double,
            u64p, u64p, f64p,
        ]
        lib.rotate_nonclifford_cleanup.restype = ctypes.c_int64
        lib.mul_pairs_cleanup.argtypes = [
            u64p, u64p, f64p, ctypes.c_int64,
            u64p, u64p, f64p, ctypes.c_int64,
            ctypes.c_int64, u64p, u64p, f64p,
        ]
        lib.mul_pairs_cleanup.restype = ctypes.c_int64
        lib.clifford_rotate_sequence_inplace.argtypes = [
            u64p, u64p, f64p, ctypes.c_int64, ctypes.c_int64,
            u64p, u64p, i64p, ctypes.c_int64,
        ]
        lib.clifford_rotate_sequence_inplace.restype = None
        lib.select_columns.argtypes = [
            u64p, ctypes.c_int64, ctypes.c_int64, u64p, u64p, ctypes.c_int64,
        ]
        lib.select_columns.restype = None
        lib.clifford_project_cleanup.argtypes = [
            u64p, u64p, f64p, ctypes.c_int64, ctypes.c_int64,
            u64p, u64p, i64p, ctypes.c_int64,
            u64p, u64p, u64p, u64p,
            u64p, ctypes.c_int64, u64p, f64p,
        ]
        lib.clifford_project_cleanup.restype = ctypes.c_int64
        lib.xor_fold.argtypes = [
            u64p, ctypes.c_int64, ctypes.c_int64, i64p, u64p,
        ]
        lib.xor_fold.restype = None
        lib.null_check2.argtypes = [
            u64p, ctypes.c_int64, u64p, ctypes.c_int64, ctypes.c_int64,
            u64p, u64p, ctypes.c_int64,
        ]
        lib.null_check2.restype = ctypes.c_int64

    def rref_inplace(self, M: np.ndarray) -> None:
        assert M.dtype == np.uint64 and M.flags["C_CONTIGUOUS"]
        self._lib.rref_inplace(M, M.shape[0], M.shape[1])

    def unique_rows(self, rows: np.ndarray):
        """Returns (first_idx[int64, n_unique], inverse[int64, n]) in
        first-occurrence order (cf. qiskit Rust unordered_unique)."""
        rows = np.ascontiguousarray(rows, dtype=np.uint64)
        n, words = rows.shape
        first_idx = np.empty(max(n, 1), dtype=np.int64)
        inverse = np.empty(max(n, 1), dtype=np.int64)
        n_unique = self._lib.unique_rows(rows, n, words, first_idx, inverse)
        return first_idx[:n_unique], inverse[:n]

    def transpose_bits(self, M: np.ndarray, n_cols: int) -> np.ndarray:
        """Transpose a packed bit matrix: (rows, words) -> (n_cols, ceil(rows/64))."""
        M = np.ascontiguousarray(M, dtype=np.uint64)
        rows, in_words = M.shape
        out_words = max(1, (rows + 63) // 64)
        out = np.zeros((n_cols, out_words), dtype=np.uint64)
        self._lib.transpose_bits(M, rows, in_words, n_cols, out, out_words)
        return out

    def clifford_rotate_sequence_inplace(self, x, z, c, rx, rz, m4s) -> None:
        """Apply a whole Clifford rotation sequence in one native call.

        x, z: uint64 planes (modified in place); c: complex128 (in place);
        rx, rz: (depth, W) uint64; m4s: (depth,) int64 pi/2 multiples."""
        assert x.flags["C_CONTIGUOUS"] and z.flags["C_CONTIGUOUS"]
        assert c.flags["C_CONTIGUOUS"] and c.dtype == np.complex128
        n, W = x.shape
        rx = np.ascontiguousarray(rx, np.uint64).reshape(-1, W)
        rz = np.ascontiguousarray(rz, np.uint64).reshape(-1, W)
        m4s = np.ascontiguousarray(m4s, np.int64)
        self._lib.clifford_rotate_sequence_inplace(
            x, z, c.view(np.float64), n, W, rx, rz, m4s, len(m4s)
        )

    def clifford_rotate_inplace(self, x, z, c, xr, zr, m4: int) -> None:
        """In-place Clifford rotation (x, z uint64 planes; c complex128)."""
        assert x.flags["C_CONTIGUOUS"] and z.flags["C_CONTIGUOUS"]
        assert c.flags["C_CONTIGUOUS"] and c.dtype == np.complex128
        n, W = x.shape
        self._lib.clifford_rotate_inplace(
            x, z, c.view(np.float64), n, W,
            np.ascontiguousarray(xr.reshape(-1), np.uint64),
            np.ascontiguousarray(zr.reshape(-1), np.uint64),
            int(m4),
        )

    def mul_pairs_cleanup(self, x1, z1, c1, x2, z2, c2):
        """Fused all-pairs product + dedup (first-occurrence order); the
        m1*m2 product row set never materialises.  Returns (x, z, coeffs)
        deduplicated (threshold not applied)."""
        x1 = np.ascontiguousarray(x1, dtype=np.uint64)
        z1 = np.ascontiguousarray(z1, dtype=np.uint64)
        x2 = np.ascontiguousarray(x2, dtype=np.uint64)
        z2 = np.ascontiguousarray(z2, dtype=np.uint64)
        c1 = np.ascontiguousarray(c1, dtype=np.complex128)
        c2 = np.ascontiguousarray(c2, dtype=np.complex128)
        m1, W = x1.shape
        m2 = x2.shape[0]
        P = max(m1 * m2, 1)
        x_out = np.empty((P, W), dtype=np.uint64)
        z_out = np.empty_like(x_out)
        c_out = np.empty(P, dtype=np.complex128)
        n_u = self._lib.mul_pairs_cleanup(
            x1, z1, c1.view(np.float64), m1,
            x2, z2, c2.view(np.float64), m2,
            W, x_out, z_out, c_out.view(np.float64),
        )
        return x_out[:n_u], z_out[:n_u], c_out[:n_u]

    def rotate_nonclifford_cleanup(self, x, z, c, xr, zr, angle: float):
        """Fused e^{i t/2 Q} conjugation + dedup for a NON-Clifford angle;
        returns deduplicated (x_out, z_out, coeffs) (threshold not applied)."""
        x = np.ascontiguousarray(x, dtype=np.uint64)
        z = np.ascontiguousarray(z, dtype=np.uint64)
        c = np.ascontiguousarray(c, dtype=np.complex128)
        n, W = x.shape
        x_out = np.empty((2 * max(n, 1), W), dtype=np.uint64)
        z_out = np.empty_like(x_out)
        c_out = np.empty(2 * max(n, 1), dtype=np.complex128)
        n_u = self._lib.rotate_nonclifford_cleanup(
            x, z, c.view(np.float64), n, W,
            np.ascontiguousarray(xr.reshape(-1), np.uint64),
            np.ascontiguousarray(zr.reshape(-1), np.uint64),
            float(np.cos(angle)), float(np.sin(angle)),
            x_out, z_out, c_out.view(np.float64),
        )
        return x_out[:n_u], z_out[:n_u], c_out[:n_u]

    def clifford_project_cleanup(
        self, x, z, c, rx, rz, m4s,
        zmask, xmask, negx, negz, colmask, n_out_words: int,
    ):
        """Fused host taper projection: Clifford sequence + single-qubit
        stabilizer commute filter + eigenvalue sign parity + free-column
        PEXT selection + dedup in one pass per row.  Returns
        (x_out, z_out, coeffs) on the reduced qubit set, or None when the
        width exceeds the native kernel's register budget (W > 8)."""
        x = np.ascontiguousarray(x, dtype=np.uint64)
        z = np.ascontiguousarray(z, dtype=np.uint64)
        c = np.ascontiguousarray(c, dtype=np.complex128)
        n, W = x.shape
        depth = len(m4s)
        rx = np.ascontiguousarray(rx, np.uint64).reshape(-1, W)
        rz = np.ascontiguousarray(rz, np.uint64).reshape(-1, W)
        m4s = np.ascontiguousarray(m4s, np.int64)
        rows_out = np.empty((max(n, 1), 2 * n_out_words), dtype=np.uint64)
        c_out = np.empty(max(n, 1), dtype=np.complex128)
        n_u = self._lib.clifford_project_cleanup(
            x, z, c.view(np.float64), n, W,
            rx, rz, m4s, depth,
            np.ascontiguousarray(zmask, np.uint64),
            np.ascontiguousarray(xmask, np.uint64),
            np.ascontiguousarray(negx, np.uint64),
            np.ascontiguousarray(negz, np.uint64),
            np.ascontiguousarray(colmask, np.uint64),
            n_out_words, rows_out, c_out.view(np.float64),
        )
        if n_u < 0:
            return None
        return (
            np.ascontiguousarray(rows_out[:n_u, :n_out_words]),
            np.ascontiguousarray(rows_out[:n_u, n_out_words:]),
            c_out[:n_u],
        )

    def xor_fold(self, M: np.ndarray, idx: np.ndarray, m: int) -> np.ndarray:
        """Scatter XOR-fold rows into m buckets: out[idx[i]] ^= M[i]."""
        M = np.ascontiguousarray(M, dtype=np.uint64)
        idx = np.ascontiguousarray(idx, dtype=np.int64)
        R, W = M.shape
        out = np.zeros((m, W), dtype=np.uint64)
        if R:
            self._lib.xor_fold(M, R, W, idx, out)
        return out

    def null_check2(self, A, B, Va, Vb) -> bool:
        """True iff every candidate [Va_j | Vb_j] annihilates every row
        [A_i | B_i] under the GF(2) symplectic pairing parity."""
        A = np.ascontiguousarray(A, dtype=np.uint64)
        B = np.ascontiguousarray(B, dtype=np.uint64)
        Va = np.ascontiguousarray(Va, dtype=np.uint64)
        Vb = np.ascontiguousarray(Vb, dtype=np.uint64)
        R, Wa = A.shape
        Wb = B.shape[1]
        k = Va.shape[0]
        if R == 0 or k == 0:
            return True
        return self._lib.null_check2(A, Wa, B, Wb, R, Va, Vb, k) == 0

    def cleanup_rows(self, rows: np.ndarray, c: np.ndarray):
        """Fused unique-rows + coefficient accumulation (first-occurrence
        order); returns (unique_rows, summed_coeffs)."""
        rows = np.ascontiguousarray(rows, dtype=np.uint64)
        c = np.ascontiguousarray(c, dtype=np.complex128)
        n, words = rows.shape
        rows_out = np.empty_like(rows)
        c_out = np.empty(max(n, 1), dtype=np.complex128)
        n_u = self._lib.cleanup_rows(
            rows, c.view(np.float64), n, words,
            rows_out, c_out.view(np.float64),
        )
        return rows_out[:n_u], c_out[:n_u]

    def mul_pairs(self, x1, z1, c1, x2, z2, c2):
        """All-pairs Pauli product with phases (rows ordered i*m2 + j);
        returns (xo, zo, coeffs) like np_core.multiply."""
        x1 = np.ascontiguousarray(x1, dtype=np.uint64)
        z1 = np.ascontiguousarray(z1, dtype=np.uint64)
        x2 = np.ascontiguousarray(x2, dtype=np.uint64)
        z2 = np.ascontiguousarray(z2, dtype=np.uint64)
        c1 = np.ascontiguousarray(c1, dtype=np.complex128)
        c2 = np.ascontiguousarray(c2, dtype=np.complex128)
        m1, W = x1.shape
        m2 = x2.shape[0]
        xo = np.empty((m1 * m2, W), dtype=np.uint64)
        zo = np.empty((m1 * m2, W), dtype=np.uint64)
        co = np.empty(m1 * m2, dtype=np.complex128)
        self._lib.mul_pairs(
            x1, z1, c1.view(np.float64), m1,
            x2, z2, c2.view(np.float64), m2,
            W, xo, zo, co.view(np.float64),
        )
        return xo, zo, co

    def qwc_matrix(self, x1, z1, x2, z2) -> np.ndarray:
        """Termwise qubitwise-commutation adjacency -> bool[m1, m2]."""
        x1 = np.ascontiguousarray(x1, dtype=np.uint64)
        z1 = np.ascontiguousarray(z1, dtype=np.uint64)
        x2 = np.ascontiguousarray(x2, dtype=np.uint64)
        z2 = np.ascontiguousarray(z2, dtype=np.uint64)
        m1, words = x1.shape
        m2 = x2.shape[0]
        out = np.empty((m1, m2), dtype=np.uint8)
        self._lib.qwc_matrix(x1, z1, m1, x2, z2, m2, words, out)
        return out.astype(bool)

    def select_columns(self, p: np.ndarray, mask_words: np.ndarray,
                       n_out_words: int) -> np.ndarray:
        """Keep packed bit columns where the mask is set (PEXT per word)."""
        p = np.ascontiguousarray(p, dtype=np.uint64)
        T, W = p.shape
        mask_words = np.ascontiguousarray(mask_words, dtype=np.uint64)
        out = np.zeros((T, n_out_words), dtype=np.uint64)
        if T:
            self._lib.select_columns(p, T, W, mask_words, out, n_out_words)
        return out

    def matmul_gf2(self, A: np.ndarray, B_rows: np.ndarray) -> np.ndarray:
        """parity(popcount(A_i & B_j)) -> bool[m, p]."""
        A = np.ascontiguousarray(A, dtype=np.uint64)
        B_rows = np.ascontiguousarray(B_rows, dtype=np.uint64)
        m, words = A.shape
        p = B_rows.shape[0]
        out = np.empty((m, p), dtype=np.uint8)
        self._lib.matmul_gf2(A, m, B_rows, p, words, out)
        return out.astype(bool)


gf2core = None
if os.environ.get("SYMMER_TORCH_NO_NATIVE", "0") != "1":
    if _build():
        try:
            gf2core = _GF2Core(ctypes.CDLL(_LIB))
        except Exception as exc:  # pragma: no cover
            warnings.warn(f"symmer_torch native load failed ({exc}); using numpy fallbacks")
            gf2core = None
