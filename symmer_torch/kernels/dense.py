"""Dense / sparse matrix realisations of packed Pauli operators.

Pauli tensor products are one-sparse: row r maps to column r ^ x_int with value
(-i)^{|Y|} (-1)^{popcount(r & z_int)} (cf. symmer ``operators/utils.py:182-228``
and the XOR-indexing construction ``base.py:1477-1498``).  This module provides

  - scipy CSR construction (API parity with ``to_sparse_matrix``),
  - a matrix-free matvec (host and jitted device) enabling iterative
    eigensolvers far beyond the reference's 30-qubit dense cap.

Integer basis convention: qubit 0 is the MOST significant bit of the basis
index (reference convention).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from . import pack


def plane_ints(pck: np.ndarray, n_qubits: int) -> np.ndarray:
    """Packed rows -> int64 with qubit 0 as MSB.  Requires n_qubits <= 62."""
    assert n_qubits <= 62, "plane_ints limited to 62 qubits"
    bits = pack.unpack_bits(pck, n_qubits).astype(np.int64)
    weights = (1 << np.arange(n_qubits - 1, -1, -1)).astype(np.int64)
    return bits @ weights


# largest (G, 2^n) complex128 host table the grouped fast paths may build
_HOST_TABLE_BUDGET = 1 << 30


def group_count(x, n_qubits: int) -> int:
    """Number of distinct X patterns (G) -- O(T log T), no table built."""
    return int(np.unique(plane_ints(x, n_qubits)).size)


def group_table_fits(x, n_qubits: int) -> bool:
    """True when the (G, 2^n) complex128 grouped-diagonal table is within
    the host budget (the grouped fast paths lose their point beyond it)."""
    if n_qubits > 26:
        return False
    return group_count(x, n_qubits) * (1 << n_qubits) * 16 <= _HOST_TABLE_BUDGET


def group_scatter_inputs(x, z, c, n_qubits: int):
    """Per-term scatter triples for the X-grouped diagonal representation:
    (ux, gidx, z_int, phase_c) with ux the (G,) distinct x_ints, gidx the
    (T,) group of each term, and phase_c = (-i)^{|Y_t|} c_t.  Since terms
    are cleanup-unique in (x, z), the (gidx, z_int) pairs are unique: the
    scatter has no collisions and is exact in any arithmetic."""
    x_int = plane_ints(x, n_qubits)
    z_int = plane_ints(z, n_qubits)
    y_cnt = np.bitwise_count(x & z).sum(axis=1).astype(np.int64)
    minus_i_pow = np.array([1, -1j, -1, 1j])
    phase_c = minus_i_pow[y_cnt % 4] * np.asarray(c, complex)
    ux, gidx = np.unique(x_int, return_inverse=True)
    return ux, gidx, z_int, phase_c


def group_diagonals(x, z, c, n_qubits: int):
    """Merge terms by X pattern: returns (ux, D) with ux the (G,) distinct
    x_ints and D the (G, dim) complex diagonals

        D[g, r] = sum_{t: x_t = ux[g]} (-i)^{|Y_t|} c_t (-1)^{par(r & z_t)}

    so that H v = sum_g D[g] * v[r ^ ux[g]].  G << n_terms for molecular
    operators (same-excitation terms share X support), which is what makes
    both the CSR assembly and the device Lanczos matvec cheap."""
    dim = 1 << n_qubits
    ux, gidx, z_int, phase_c = group_scatter_inputs(x, z, c, n_qubits)
    # D[g] = H @ S[g] with S[g, z_t] = ph_t: a T-element scatter plus one
    # fast Walsh-Hadamard butterfly pass per row block -- O(G 2^n n) with
    # vectorised bodies (the naive (T, dim) parity broadcast with np.add.at
    # measured 61 s for tapered N2; this runs in ~1 s)
    vals = np.zeros((ux.shape[0], dim), dtype=complex)
    np.add.at(vals, (gidx, z_int), phase_c)
    return ux, fwht_rows(vals)


def fwht_rows(vals: np.ndarray) -> np.ndarray:
    """In-place fast Walsh-Hadamard butterfly along axis 1 of (K, dim):
    out[k, z] = sum_r (-1)^{popcount(r & z)} vals[k, r].  Shared by the
    grouped-diagonal builds here and by ``_from_matrix_projector``."""
    K, dim = vals.shape
    h = 1
    while h < dim:
        vals = vals.reshape(K, dim // (2 * h), 2, h)
        top = vals[:, :, 0, :].copy()
        vals[:, :, 0, :] += vals[:, :, 1, :]
        vals[:, :, 1, :] = top - vals[:, :, 1, :]
        vals = vals.reshape(K, dim)
        h *= 2
    return vals


def to_sparse_matrix(x, z, c, n_qubits: int, grouped=None):
    """scipy CSR matrix of the operator (n_qubits <= ~16 advisable).

    Terms sharing an X pattern hit identical (row, col) positions, so the
    values are pre-merged per distinct x_int (``group_diagonals``) and the
    CSR is assembled once from already-unique COO triples -- no duplicate-
    summing sort, no repeated sparse adds.
    """
    from scipy.sparse import csr_matrix

    if n_qubits == 0:
        return csr_matrix(np.array([[np.sum(c)]]))
    dim = 1 << n_qubits
    ux, vals = grouped if grouped is not None else group_diagonals(
        x, z, c, n_qubits
    )
    G = ux.shape[0]
    rows = np.arange(dim, dtype=np.int64)
    cols = (rows[None, :] ^ ux[:, None]).reshape(-1)
    row_idx = np.broadcast_to(rows, (G, dim)).reshape(-1)
    return csr_matrix(
        (vals.reshape(-1), (row_idx, cols)), shape=(dim, dim)
    )


def expval_dense_state(x, z, c, n_qubits: int, s_pack, amps, grouped=None) -> complex:
    """<psi|O|psi> for DENSE-support states via X-grouped diagonals: O(G 2^n).

    The general expval kernels are built for sparse-support states (hash
    joins / one-hot lookups cost O(T B) .. O(T B^2)); when the state covers
    a large fraction of the basis it is cheaper to scatter the amplitudes
    into a full statevector and contract against the G << T group diagonals
    (``group_diagonals``):

        <psi|O|psi> = sum_g sum_r conj(v[r]) D_g(r) v[r ^ x_g]
    """
    dim = 1 << n_qubits
    v = np.zeros(dim, dtype=complex)
    idx = plane_ints(s_pack, n_qubits)
    np.add.at(v, idx, amps)  # duplicate basis rows accumulate
    if grouped is None:
        grouped = group_diagonals(x, z, c, n_qubits)
    ux, D = grouped
    rows = np.arange(dim, dtype=np.int64)
    Hv = np.zeros(dim, dtype=complex)
    for g, xg in enumerate(ux):
        Hv += D[g] * v[rows ^ xg]
    return complex(np.vdot(v, Hv))


def matvec_host(x, z, c, n_qubits: int, v: np.ndarray) -> np.ndarray:
    """H @ v without materialising H (host)."""
    dim = 1 << n_qubits
    x_int = plane_ints(x, n_qubits)
    z_int = plane_ints(z, n_qubits)
    y_cnt = np.bitwise_count(x & z).sum(axis=1).astype(np.int64)
    minus_i_pow = np.array([1, -1j, -1, 1j])
    rows = np.arange(dim, dtype=np.int64)
    out = np.zeros(dim, dtype=complex)
    step = max(1, (1 << 24) // dim)
    for t0 in range(0, len(c), step):
        t1 = min(len(c), t0 + step)
        src = rows[None, :] ^ x_int[t0:t1, None]         # H[r, r^x] pattern
        par = np.bitwise_count(rows[None, :] & z_int[t0:t1, None]).astype(np.int64) & 1
        amp = (minus_i_pow[y_cnt[t0:t1] % 4] * c[t0:t1])[:, None] * (1 - 2 * par)
        out += np.sum(amp * v[src], axis=0)
    return out


def make_linear_operator(x, z, c, n_qubits: int, grouped=None):
    """scipy LinearOperator backed by the matrix-free matvec.

    When the (G, dim) grouped-diagonal table fits the host budget
    (``group_table_fits``), every matvec is O(G 2^n) (G << T); beyond it the
    per-term O(T 2^n) ``matvec_host`` streams without building any table.
    """
    from scipy.sparse.linalg import LinearOperator

    dim = 1 << n_qubits
    if grouped is not None or group_table_fits(x, n_qubits):
        if grouped is None:
            grouped = group_diagonals(x, z, c, n_qubits)
        ux, D = grouped
        rows = np.arange(dim, dtype=np.int64)

        def mv(v):
            v = np.asarray(v).reshape(-1)
            out = np.zeros(dim, dtype=complex)
            for g, xg in enumerate(ux):
                out += D[g] * v[rows ^ xg]
            return out

        return LinearOperator((dim, dim), matvec=mv, dtype=complex)
    return LinearOperator(
        (dim, dim),
        matvec=lambda v: matvec_host(x, z, c, n_qubits, np.asarray(v).reshape(-1)),
        dtype=complex,
    )

