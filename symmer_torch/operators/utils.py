"""Operator-level utilities (parity surface of symmer ``operators/utils.py``).

The boolean-symplectic helpers are thin wrappers over the packed kernels in
:mod:`symmer_torch.kernels`; they exist for API familiarity and for tests that
speak the reference's [X|Z] dialect.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..kernels import gf2, np_core, pack

try:
    from ..native import gf2core
except Exception:  # pragma: no cover
    gf2core = None


# ---------------------------------------------------------------------------
# string <-> symplectic (reference operators/utils.py:80-163)
# ---------------------------------------------------------------------------

def symplectic_to_string(symp_vec: np.ndarray) -> str:
    symp_vec = np.asarray(symp_vec).astype(bool)
    n_qubits = len(symp_vec) // 2
    x, z, _ = pack.symplectic_to_planes(symp_vec)
    return pack.planes_to_strings(x, z, n_qubits)[0]


def string_to_symplectic(pauli_str: str, n_qubits: int) -> np.ndarray:
    assert len(pauli_str) == n_qubits, "Number of qubits is incompatible with pauli string"
    assert set(pauli_str).issubset({"I", "X", "Y", "Z"}), (
        "pauliword must only contain X,Y,Z,I terms"
    )
    x, z, _ = pack.strings_to_planes([pauli_str])
    return pack.planes_to_symplectic(x, z, n_qubits)[0].astype(int)


def random_symplectic_matrix(n_qubits, n_terms, diagonal=False, density=0.3):
    """Random boolean [X|Z] matrix (reference operators/utils.py:281-290)."""
    if diagonal:
        Z_block = np.random.choice(
            [True, False], size=[n_terms, n_qubits], p=[density / 2, 1 - density / 2]
        )
        return np.hstack([np.zeros_like(Z_block), Z_block])
    return np.random.choice([True, False], size=[n_terms, 2 * n_qubits], p=[density, 1 - density])


# ---------------------------------------------------------------------------
# GF(2) echelon forms (packed implementations under the hood)
# ---------------------------------------------------------------------------

def _rref_binary(matrix: np.ndarray) -> np.ndarray:
    return gf2.rref_bool(matrix, reorder=False)


def rref_binary(matrix: np.ndarray) -> np.ndarray:
    return gf2.rref_bool(matrix, reorder=True)


def _cref_binary(matrix: np.ndarray) -> np.ndarray:
    return gf2.cref_bool(matrix, reorder=False)


def cref_binary(matrix: np.ndarray) -> np.ndarray:
    return gf2.cref_bool(matrix, reorder=True)


def matmul_GF2(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """(A @ B) mod 2 over boolean matrices (reference operators/utils.py:9-26)."""
    A = np.atleast_2d(np.asarray(A, dtype=bool))
    B = np.atleast_2d(np.asarray(B, dtype=bool))
    Ap = pack.pack_bits(A, A.shape[1])
    Bp = pack.pack_bits(B.T, B.shape[0])
    return gf2.matmul_gf2_packed(Ap, Bp)


def numba_binary_matmal_GF2(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """API-familiarity alias of :func:`matmul_GF2` keeping the reference's
    public kernel name (reference operators/utils.py:29-61, numba-compiled
    there; "matmal" is the reference's own spelling). Routes through the
    packed-word popcount-parity matmul."""
    return matmul_GF2(A, B)


def numba_dot_matmal_GF2(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """API-familiarity alias of :func:`matmul_GF2` (reference
    operators/utils.py:63-78: float dot then mod 2).  The reference variant
    returns a NUMERIC array (float dot taken mod 2), so the alias casts the
    packed boolean result to int to keep downstream dtype arithmetic intact."""
    return matmul_GF2(A, B).astype(int)


# ---------------------------------------------------------------------------
# independence / contextuality checks (reference operators/utils.py:504-616)
# ---------------------------------------------------------------------------

def check_independent(operators) -> bool:
    """True iff the terms are algebraically independent under multiplication."""
    if operators.n_terms > 2 * operators.n_qubits:
        return False
    joint = pack.hstack_words(operators.x_pack, operators.z_pack)
    red = gf2.rref_packed(joint)
    return not bool(np.any(~np.any(red, axis=1)))


def check_jordan_independent(operators) -> bool:
    """Independence under the Jordan product (reference utils.py:521-564)."""
    if operators.n_terms > 3 * operators.n_qubits:
        return False
    comm_mask = np.sum(operators.commutes_termwise(operators), axis=1) == operators.n_terms
    if not check_independent(operators[comm_mask]):
        return False
    # row-reduce with Y treated as independent letter: [X^Y | Z^Y | Y]
    y = operators.x_pack & operators.z_pack
    xzy = pack.hstack_words(operators.x_pack ^ y, operators.z_pack ^ y, y)
    red = gf2.rref_packed(xzy)
    return not bool(np.any(~np.any(red, axis=1)))


def check_adjmat_noncontextual(adjmat: np.ndarray) -> bool:
    """Noncontextuality test on a commutation adjacency matrix.

    (reference operators/utils.py:567-589, after arXiv:1904.02260)
    """
    non_universal = ~np.all(adjmat, axis=1)
    if gf2core is not None and adjmat.shape[0] > 64:
        # The reference's np.unique(axis=0) on the doubly-masked M x M bool
        # matrix costs seconds at M ~ 10^4 (the column gather alone is ~4 s).
        # Universal columns are constant True on every row (the matrix is a
        # symmetric commutation adjacency), so dropping them cannot change
        # row uniqueness: dedup the *full* non-universal rows packed, and
        # apply the column mask only to the final per-column count.
        rows = np.ascontiguousarray(adjmat[non_universal])
        if rows.shape[0] == 0:
            return True
        packed = pack.pack_bits(rows)
        first_idx, _ = gf2core.unique_rows(packed)
        counts = rows[np.sort(first_idx)].sum(axis=0)
        return bool(np.all(counts[non_universal] == 1))
    sub = adjmat[non_universal][:, non_universal]
    unique_commutation_character = np.unique(sub, axis=0)
    return bool(np.all(np.count_nonzero(unique_commutation_character, axis=0) == 1))


def perform_noncontextual_sweep(operator):
    """Single ordered sweep retaining terms that keep the set noncontextual.

    (reference operators/utils.py:592-616)
    """
    noncon_indices = np.array([0])
    adjmat = np.array([[True]], dtype=bool)
    for index in range(1, operator.n_terms):
        term = operator[index]
        adjmat_vector = np.append(
            term.commutes_termwise(operator[noncon_indices]), True
        )
        adjmat_padded = np.pad(adjmat, pad_width=((0, 1), (0, 1)), mode="constant")
        adjmat_padded[-1, :] = adjmat_vector
        adjmat_padded[:, -1] = adjmat_vector
        if check_adjmat_noncontextual(adjmat_padded):
            noncon_indices = np.append(noncon_indices, index)
            adjmat = adjmat_padded
    return operator[noncon_indices]


# ---------------------------------------------------------------------------
# misc numerics
# ---------------------------------------------------------------------------

def binary_array_to_int(bin_arr: np.ndarray) -> np.ndarray:
    """Rows of binary (MSB first, reference convention) -> integers.

    Uses Python objects above 63 bits so arbitrary widths are exact
    (cf. reference operators/utils.py:618-640 which loses precision >64q).
    """
    bin_arr = np.atleast_2d(bin_arr).astype(int)
    n = bin_arr.shape[1]
    if n < 63:
        return bin_arr @ (1 << np.arange(n - 1, -1, -1))
    weights = np.array([1 << int(i) for i in range(n - 1, -1, -1)], dtype=object)
    return bin_arr.astype(object) @ weights


def packed_rows_to_ints(pck: np.ndarray, n_bits: int) -> List[int]:
    """Packed LSB-first rows -> Python ints with bit q = qubit q weight 2^(n-1-q).

    Matches the reference's MSB-first integer convention for basis states.
    """
    bits = pack.unpack_bits(pck, n_bits)
    out = []
    for row in bits:
        v = 0
        for b in row:  # qubit 0 is the most significant bit
            v = (v << 1) | int(b)
        out.append(v)
    return out


def mul_symplectic(symp_vec1, coeff1, symp_vec2, coeff2):
    """Single-pair Pauli product on boolean symplectic vectors.

    (reference operators/utils.py:429-470)
    """
    x1, z1, _ = pack.symplectic_to_planes(np.asarray(symp_vec1))
    x2, z2, _ = pack.symplectic_to_planes(np.asarray(symp_vec2))
    xo, zo, co = np_core.multiply(x1, z1, np.array([coeff1]), x2, z2, np.array([coeff2]))
    n_qubits = len(np.asarray(symp_vec1)) // 2
    return (
        pack.planes_to_symplectic(xo, zo, n_qubits)[0].astype(int),
        co[0],
    )


def unit_n_sphere_cartesian_coords(angles: np.ndarray) -> np.ndarray:
    """(reference operators/utils.py:472-485)"""
    cartesians = [
        np.prod(np.sin(angles[:i])) * np.cos(angles[i]) for i in range(len(angles))
    ]
    cartesians.append(np.prod(np.sin(angles)))
    return np.array(cartesians)


def binomial_coefficient(n, k):
    """n-choose-k allowing non-integer n (reference operators/utils.py:487-502)."""
    prod = 1
    for r in range(k):
        prod *= (n - r) / (k - r)
    return prod


def count1_in_int_bitstring(i):
    """HAKMEM-style popcount for int arrays (reference operators/utils.py:165-180)."""
    i = i - ((i >> 1) & 0x55555555)
    i = (i & 0x33333333) + ((i >> 2) & 0x33333333)
    return (((i + (i >> 4) & 0xF0F0F0F) * 0x1010101) & 0xFFFFFFFF) >> 24


# ---------------------------------------------------------------------------
# serialisation (reference operators/utils.py:401-427)
# ---------------------------------------------------------------------------

def safe_PauliwordOp_to_dict(op) -> Dict[str, Tuple[float, float]]:
    terms, coeffs = zip(*op.to_dictionary.items())
    return dict(zip(terms, [(c.real, c.imag) for c in coeffs]))


def safe_QuantumState_to_dict(psi) -> Dict[str, Tuple[float, float]]:
    terms, coeffs = zip(*psi.to_dictionary.items())
    return dict(zip(terms, [(c.real, c.imag) for c in coeffs]))


# ---------------------------------------------------------------------------
# optional external-library interchange (qiskit / openfermion are NOT
# dependencies of symmer-tpu; dictionaries are the canonical interchange)
# ---------------------------------------------------------------------------

def QubitOperator_to_dict(op, num_qubits: int) -> Dict[str, complex]:
    op_dict = {}
    for term, coeff in op.terms.items():
        letters = ["I"] * num_qubits
        for idx, letter in term:
            letters[idx] = letter
        op_dict["".join(letters)] = coeff
    return op_dict


def SparsePauliOp_to_dict(op) -> Dict[str, complex]:
    return {pstr: coeff for pstr, coeff in op.to_list()}


def symplectic_cleanup(symp_matrix, coeff_vec, zero_threshold=None):
    """Deduplicate boolean symplectic rows, summing coefficients of merged
    terms and (optionally) dropping any below ``zero_threshold`` in magnitude.

    API-parity wrapper over the packed host cleanup kernel (reference
    operators/utils.py:230-279, which routes through qiskit's Rust
    ``unordered_unique``).  Returns ``(reduced_symp_matrix, reduced_coeffs)``.
    """
    symp_matrix = np.atleast_2d(np.asarray(symp_matrix)).astype(bool)
    x, z, nq = pack.symplectic_to_planes(symp_matrix)
    xo, zo, c = np_core.cleanup(
        x, z, np.asarray(coeff_vec, dtype=complex), zero_threshold
    )
    return (
        np.hstack([pack.unpack_bits(xo, nq), pack.unpack_bits(zo, nq)]),
        c,
    )


def symplectic_to_openfermion(symp_vec, coeff):
    """Single symplectic row -> openfermion ``QubitOperator`` term (reference
    operators/utils.py:109-137).  Requires openfermion (optional)."""
    from openfermion.ops import QubitOperator

    s = symplectic_to_string(symp_vec)
    term = " ".join(f"{p}{i}" for i, p in enumerate(s) if p != "I")
    return QubitOperator(term, coeff)


def symplectic_to_sparse_matrix(symp_vec, coeff):
    """Single symplectic row -> one-sparse ``(2^n, 2^n)`` CSR matrix scaled by
    ``coeff`` (reference operators/utils.py:182-228).  Delegates to the packed
    one-sparse construction behind ``PauliwordOp.to_sparse_matrix``."""
    from .base import PauliwordOp

    symp_vec = np.asarray(symp_vec, dtype=bool).reshape(1, -1)
    return PauliwordOp(symp_vec, [coeff]).to_sparse_matrix
