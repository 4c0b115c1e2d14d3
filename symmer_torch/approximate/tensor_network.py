"""MPO construction and DMRG ground-state approximation.

Parity surface of symmer ``approximate/tensor_network.py``: ``MPOOp``,
``get_MPO`` and a ground-state solver.  The reference delegates DMRG to quimb
(``find_groundstate_quimb``, tensor_network.py:101-128); quimb is not a
dependency here, so a native two-site DMRG is implemented
(:func:`find_groundstate_dmrg`), with the same default bond-dimension schedule
[10, 20, 100, 100, 200] and tolerances.  ``find_groundstate_quimb`` is kept as
an alias for API familiarity.

MPO tensors are shaped (sigma_out, sigma_in, left_bond, right_bond), matching
the reference's (sigma, l, i, j) convention.
"""
from __future__ import annotations

from functools import reduce
from typing import Dict, List, Optional

import numpy as np

from ..operators import PauliwordOp, QuantumState

Paulis = {
    "I": np.eye(2, dtype=np.complex128),
    "X": np.array([[0, 1], [1, 0]], dtype=np.complex128),
    "Y": np.array([[0, -1j], [1j, 0]], dtype=np.complex128),
    "Z": np.array([[1, 0], [0, -1]], dtype=np.complex128),
}


def coefflist_to_complex(coefflist) -> np.ndarray:
    """[(re, im), ...] -> complex vector (reference tensor_network.py:141-153)."""
    arr = np.array(coefflist, dtype=complex)
    return arr[:, 0] + 1j * arr[:, 1]


def pstrings_to_mpo(pstrings: List[str], coeffs=None, Dmax: Optional[int] = None):
    """Direct diagonal-selector MPO of a Pauli sum, then SVD truncation.

    Bond dimension starts at n_terms: site tensors are diagonal in the bond
    (term) index with the per-site Pauli matrix on the diagonal; the first
    site carries the coefficients.  (cf. reference
    ``pstrings_to_mpo_optimized`` tensor_network.py:155-215)
    """
    if coeffs is None:
        coeffs = np.ones(len(pstrings))
    coeffs = np.asarray(coeffs, dtype=complex)
    n_sites = len(pstrings[0])
    T = len(pstrings)

    mpo = []
    for k in range(n_sites):
        mats = np.stack([Paulis[p[k]] for p in pstrings])  # (T, 2, 2)
        if n_sites == 1:
            # single site: both bonds are boundaries -- the term sum must
            # contract HERE (the k == 0 branch below would leave the right
            # bond open at width T)
            W = np.sum(mats * coeffs[:, None, None], axis=0)[:, :, None, None]
        elif k == 0:
            mats = mats * coeffs[:, None, None]
            W = np.transpose(mats, (1, 2, 0))[:, :, None, :]  # (2,2,1,T)
        elif k == n_sites - 1:
            W = np.transpose(mats, (1, 2, 0))[:, :, :, None]  # (2,2,T,1)
        else:
            W = np.zeros((2, 2, T, T), dtype=complex)
            idx = np.arange(T)
            W[:, :, idx, idx] = np.transpose(mats, (1, 2, 0))
        mpo.append(W)
    return truncate_MPO(mpo, Dmax if Dmax is not None else np.inf)


# keep the reference's "optimized" name as an alias
pstrings_to_mpo_optimized = pstrings_to_mpo


def pstring_to_mpo(pstring: str, scaling=None):
    """Bond-dimension-1 MPO of a single Pauli string: one (2, 2, 1, 1)
    site tensor per character, coefficient absorbed into the first site
    (reference tensor_network.py:247-265)."""
    mpo = [Paulis[p][:, :, None, None] for p in pstring]
    if scaling is not None:
        mpo[0] = mpo[0] * scaling
    return mpo


def truncated_SVD(M, Dmax=None):
    U, S, V = np.linalg.svd(M, full_matrices=False)
    if Dmax is not None and not np.isinf(Dmax) and len(S) > Dmax:
        S = S[:Dmax]
        U = U[:, :Dmax]
        V = V[:Dmax, :]
    return U, S, V


def truncate_MPO(mpo, Dmax):
    """Two-pass SVD compression: right-canonicalise (lossless QR gauge), then
    truncate left-to-right so singular values are globally meaningful.

    (the reference's single-pass version tensor_network.py:303-331 truncates in
    an arbitrary gauge, which is uncontrolled)
    """
    n = len(mpo)
    # right-to-left lossless gauge pass
    for k in range(n - 1, 0, -1):
        A = mpo[k]  # (2, 2, Dl, Dr)
        s_o, s_i, Dl, Dr = A.shape
        mat = np.transpose(A, (2, 0, 1, 3)).reshape(Dl, s_o * s_i * Dr)
        Q, Rm = np.linalg.qr(mat.conj().T)
        D = Q.shape[1]
        mpo[k] = np.transpose(Q.conj().T.reshape(D, s_o, s_i, Dr), (1, 2, 0, 3))
        mpo[k - 1] = np.einsum("ijab,bc->ijac", mpo[k - 1], Rm.conj().T)
    # left-to-right truncation pass
    As = []
    for k in range(n - 1):
        A = mpo[k]
        s_o, s_i, Dl, Dr = A.shape
        mat = np.transpose(A, (0, 1, 2, 3)).reshape(s_o * s_i * Dl, Dr)
        U, S, V = truncated_SVD(mat, None if np.isinf(Dmax) else int(Dmax))
        D = len(S)
        As.append(U.reshape(s_o, s_i, Dl, D))
        M = np.diag(S) @ V
        As_next = mpo[k + 1]
        mpo[k + 1] = np.einsum("ab,ijbd->ijad", M, As_next)
    As.append(mpo[-1])
    return As


def sum_mpo(mpo1, mpo2):
    """Direct-sum combination of two MPOs (reference tensor_network.py:333-356)."""
    summed = []
    n = len(mpo1)
    for k in range(n):
        a, b = mpo1[k], mpo2[k]
        _, _, i1, j1 = a.shape
        _, _, i2, j2 = b.shape
        if k == 0:
            out = np.zeros((2, 2, i1, j1 + j2), dtype=complex)
            out[:, :, :, :j1] = a
            out[:, :, :, j1:] = b
        elif k == n - 1:
            out = np.zeros((2, 2, i1 + i2, j1), dtype=complex)
            out[:, :, :i1, :] = a
            out[:, :, i1:, :] = b
        else:
            out = np.zeros((2, 2, i1 + i2, j1 + j2), dtype=complex)
            out[:, :, :i1, :j1] = a
            out[:, :, i1:, j1:] = b
        summed.append(out)
    return summed


class MPOOp:
    """Matrix product operator built from Pauli strings + coefficients.

    (reference tensor_network.py:11-83)
    """

    def __init__(self, pauliList: List[str], coeffList: List[complex], Dmax: int = None):
        coeffList = np.asarray(coeffList)
        if coeffList.ndim == 2:
            coeffList = coefflist_to_complex(coeffList)
        self.mpo = pstrings_to_mpo(list(pauliList), coeffList, Dmax)
        self.n_qubits = len(pauliList[0])

    @classmethod
    def from_dictionary(cls, operator_dict: Dict[str, complex], Dmax: int = None):
        paulis, coeffs = zip(*operator_dict.items())
        return cls(list(paulis), coeffs, Dmax)

    @classmethod
    def from_WordOp(cls, WordOp: PauliwordOp):
        return cls.from_dictionary(WordOp.to_dictionary)

    @property
    def to_matrix(self) -> np.ndarray:
        """Contract the MPO to a dense 2^n x 2^n matrix."""
        contr = self.mpo[0]  # (2,2,1,D)
        for W in self.mpo[1:]:
            contr = np.einsum("ijab,klbc->ikjlac", contr, W)
            s1, s2, t1, t2, Dl, Dr = contr.shape
            contr = contr.reshape(s1 * s2, t1 * t2, Dl, Dr)
        return np.squeeze(contr, axis=(2, 3))


def get_MPO(operator: PauliwordOp, max_bond_dimension: int) -> MPOOp:
    """(reference tensor_network.py:85-99)"""
    pstrings, coefflist = zip(*operator.to_dictionary.items())
    return MPOOp(list(pstrings), coefflist, Dmax=max_bond_dimension)


# ---------------------------------------------------------------------------
# native two-site DMRG
# ---------------------------------------------------------------------------

def _build_right_env(Rnext, A_bra, W, A_ket):
    """R'[a, v, c] = sum A_bra[a,p,b] W[p,q,v,w] A_ket[c,q,e] Rnext[b,w,e]."""
    t = np.tensordot(A_ket, Rnext, axes=([2], [2]))      # (c, q, b?, w) -> (Dlk, 2, Du, w)
    # A_ket: (Dlk, 2, Dre), Rnext: (Drb, w, Dre) -> t: (Dlk, 2, Drb, w)
    t = np.tensordot(W, t, axes=([1, 3], [1, 3]))        # W(p,q,v,w) x t -> (p, v, Dlk, Drb)
    # -> t: (2, wl, Dlk, Drb)
    out = np.tensordot(A_bra.conj(), t, axes=([1, 2], [0, 3]))  # (Dlb, p, Drb) x (p, v, Dlk, Drb)
    # -> (Dlb, wl, Dlk)
    return out


def _build_left_env(Lprev, A_bra, W, A_ket):
    """L'[b, w, e] = sum Lprev[a, v, c] A_bra[a,p,b] W[p,q,v,w] A_ket[c,q,e]."""
    t = np.tensordot(Lprev, A_ket, axes=([2], [0]))      # (a, v, q, e)
    t = np.tensordot(t, W, axes=([1, 2], [2, 1]))        # (a, e, p, w)
    out = np.tensordot(A_bra.conj(), t, axes=([0, 1], [0, 2]))  # (b, e, w)
    return np.transpose(out, (0, 2, 1))


def find_groundstate_dmrg(
    mpo_op: MPOOp,
    bond_dims: List[int] = (10, 20, 100, 100, 200),
    cutoff: float = 1e-10,
    tol: float = 1e-6,
    max_sweeps_per_dim: int = 2,
    gs_guess: np.ndarray = None,
    rng_seed: int = 0,
) -> QuantumState:
    """Two-site DMRG ground-state search over the given MPO.

    Native replacement for the reference's quimb DMRG2 call
    (tensor_network.py:101-128): same bond-dimension schedule and tolerances.
    Returns the (cleaned) QuantumState, threshold 1e-5 as in the reference.
    """
    from scipy.sparse.linalg import LinearOperator, eigsh

    mpo = mpo_op.mpo
    n = len(mpo)
    rng = np.random.default_rng(rng_seed)

    D0 = min(int(bond_dims[0]), 8)
    if gs_guess is not None:
        # seed from the supplied dense state by successive SVD splits (the
        # reference forwards gs_guess into quimb's DMRG2 the same way) --
        # a good guess saves sweeps and avoids foreign local minima
        vec0 = np.asarray(gs_guess, complex).reshape(-1)
        assert vec0.size == 1 << n, "gs_guess dimension != 2^n_qubits"
        vec0 = vec0 / np.linalg.norm(vec0)
        mps = []
        rest, Dl = vec0.reshape(1, -1), 1
        for k in range(n - 1):
            rest = rest.reshape(Dl * 2, -1)
            U, Sv, V = np.linalg.svd(rest, full_matrices=False)
            keep = max(1, min(D0, int(np.sum(Sv > 1e-14 * Sv[0]))))
            mps.append(U[:, :keep].reshape(Dl, 2, keep))
            rest, Dl = np.diag(Sv[:keep]) @ V[:keep], keep
        mps.append(rest.reshape(Dl, 2, 1))
    else:
        # random at a healthy starting bond dimension (narrow random starts
        # get stuck in symmetry sectors), right-canonicalised below
        mps = []
        Dl = 1
        for k in range(n):
            Dr = min(D0, 2 ** (n - k - 1), 2 ** (k + 1))
            mps.append(
                rng.normal(size=(Dl, 2, Dr)) + 1j * rng.normal(size=(Dl, 2, Dr))
            )
            Dl = Dr

    def right_canonicalise():
        for k in range(n - 1, 0, -1):
            A = mps[k]
            Dl_, d, Dr_ = A.shape
            Q, Rm = np.linalg.qr(A.reshape(Dl_, d * Dr_).conj().T)
            mps[k] = Q.conj().T.reshape(-1, d, Dr_)
            mps[k - 1] = np.tensordot(mps[k - 1], Rm.conj().T, axes=([2], [0]))

    right_canonicalise()

    energy_prev = None
    noise_level = 1e-3

    def local_solve(k, Dmax, L, R, sweep_right, noise=0.0):
        """Optimise the two-site tensor at bond (k, k+1) and split it."""
        Le = L[k]
        Re = R[k + 2]
        W1, W2 = mpo[k], mpo[k + 1]
        Dl_, d1, _ = mps[k].shape
        _, d2, Dr_ = mps[k + 1].shape
        dim = Dl_ * d1 * d2 * Dr_

        def hmv(vec):
            th = vec.reshape(Dl_, d1, d2, Dr_)
            t = np.tensordot(Le, th, axes=([2], [0]))          # (a, v, q1, q2, Dr)
            t = np.tensordot(t, W1, axes=([1, 2], [2, 1]))     # (a, q2, Dr, p1, w1)
            t = np.tensordot(t, W2, axes=([4, 1], [2, 1]))     # (a, Dr, p1, p2, w2)
            t = np.tensordot(t, Re, axes=([1, 4], [2, 1]))     # (a, p1, p2, b)
            return t.reshape(dim)

        v0 = np.tensordot(mps[k], mps[k + 1], axes=([2], [0])).reshape(dim)
        nv0 = np.linalg.norm(v0)
        v0 = v0 / nv0 if nv0 > 0 else None
        if dim <= 16:
            dense = np.array([hmv(np.eye(dim)[:, i]) for i in range(dim)]).T
            evals, evecs = np.linalg.eigh((dense + dense.conj().T) / 2)
            energy, theta = evals[0], evecs[:, 0]
        else:
            Heff = LinearOperator((dim, dim), matvec=hmv, dtype=complex)
            evals, evecs = eigsh(Heff, k=1, which="SA", v0=v0, maxiter=5000)
            energy, theta = evals[0], evecs[:, 0]

        theta = theta.reshape(Dl_ * d1, d2 * Dr_)
        if noise > 0:
            theta = theta + noise * np.linalg.norm(theta) * (
                rng.normal(size=theta.shape) + 1j * rng.normal(size=theta.shape)
            )
        U, S, V = np.linalg.svd(theta, full_matrices=False)
        keep = min(int(Dmax), int(np.sum(S > cutoff * S[0])) if S[0] > 0 else 1)
        keep = max(keep, 1)
        U, S, V = U[:, :keep], S[:keep], V[:keep, :]
        S = S / np.linalg.norm(S)
        if sweep_right:
            mps[k] = U.reshape(Dl_, d1, keep)
            mps[k + 1] = (np.diag(S) @ V).reshape(keep, d2, Dr_)
            L[k + 1] = _build_left_env(L[k], mps[k], W1, mps[k])
        else:
            mps[k + 1] = V.reshape(keep, d2, Dr_)
            mps[k] = (U @ np.diag(S)).reshape(Dl_, d1, keep)
            R[k + 1] = _build_right_env(R[k + 2], mps[k + 1], W2, mps[k + 1])
        return energy

    def one_sweep(Dmax, noise):
        # full right-environment pass
        R = [None] * (n + 1)
        R[n] = np.ones((1, 1, 1))
        for k in range(n - 1, 1, -1):
            R[k] = _build_right_env(R[k + 1], mps[k], mpo[k], mps[k])
        L = [None] * (n + 1)
        L[0] = np.ones((1, 1, 1))

        energy = None
        for k in range(n - 1):            # left-to-right
            energy = local_solve(k, Dmax, L, R, sweep_right=True, noise=noise)
        for k in range(n - 2, -1, -1):    # right-to-left
            energy = local_solve(k, Dmax, L, R, sweep_right=False, noise=noise)
        return energy

    for Dmax in bond_dims:
        for _ in range(max_sweeps_per_dim):
            energy = one_sweep(Dmax, noise_level)
            noise_level *= 0.5
            if energy_prev is not None and abs(energy - energy_prev) < tol:
                energy_prev = energy
                break
            energy_prev = energy
    # one final NOISELESS sweep: the escape noise injected during the search
    # never reached zero, which left an irreducible ~noise_level floor on the
    # returned state regardless of tolerances
    one_sweep(bond_dims[-1], 0.0)

    # contract the MPS to a dense statevector (small n regime)
    vec = mps[0]
    for k in range(1, n):
        vec = np.tensordot(vec, mps[k], axes=([-1], [0]))
    vec = vec.reshape(-1)
    vec = vec / np.linalg.norm(vec)
    return QuantumState.from_array(vec.reshape(-1, 1)).cleanup(zero_threshold=1e-5)


# API-familiarity alias for reference users
def find_groundstate_quimb(MPOOp_in: MPOOp, dmrg=None, gs_guess=None) -> QuantumState:
    """Alias of :func:`find_groundstate_dmrg` (the reference delegates to quimb)."""
    return find_groundstate_dmrg(MPOOp_in, gs_guess=gs_guess)
