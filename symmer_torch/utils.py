"""Top-level utilities (parity surface of symmer ``utils.py``).

``exact_gs_energy`` adds a matrix-free path (packed one-sparse matvec) on top
of the reference's sparse/dense eigensolve, lifting the dense-matrix cap.
``exact_gs_energy_device`` and ``exact_lowest_states_device`` run the
Lanczos drivers of ``kernels/lanczos.py`` on ``config.device`` (the CUDA
kernels of the X-grouped matvec and its table on a card, their plain torch
versions on the CPU device).
"""
from __future__ import annotations

from functools import reduce
from typing import List, Tuple, Union

import numpy as np

from .operators import PauliwordOp, QuantumState
from .operators.anticommuting_op import AntiCommutingOp


def exact_gs_energy(
    sparse_matrix,
    initial_guess=None,
    n_particles=None,
    number_operator=None,
    n_eigs=6,
) -> Tuple[float, QuantumState]:
    """Ground-state energy and state of a (sparse or LinearOperator) matrix.

    (reference utils.py:14-76)  Specifying ``n_particles`` restricts to
    eigenvectors with that Hamming weight expectation under ``number_operator``.

    Also accepts a ``PauliwordOp`` directly (beyond the reference surface):
    small operators go through the sparse matrix, wide ones through the
    matrix-free one-sparse matvec so no dense/CSR matrix is ever built.
    """
    import scipy as sp

    if number_operator is None:
        n_eigs = 1

    from scipy.sparse.linalg import LinearOperator

    if isinstance(sparse_matrix, PauliwordOp):
        operator = sparse_matrix
        sparse_matrix = (
            operator.to_sparse_matrix
            if operator.n_qubits <= 16
            else operator.matrix_free_linear_operator()
        )

    if isinstance(sparse_matrix, LinearOperator):
        eigvals, eigvecs = sp.sparse.linalg.eigsh(
            sparse_matrix, k=n_eigs, v0=initial_guess, which="SA", maxiter=1e7
        )
    elif sparse_matrix.shape[0] > 2**5:
        eigvals, eigvecs = sp.sparse.linalg.eigsh(
            sparse_matrix, k=n_eigs, v0=initial_guess, which="SA", maxiter=1e7
        )
    else:
        eigvals, eigvecs = np.linalg.eigh(sparse_matrix.toarray())

    order = np.argsort(eigvals)
    eigvals, eigvecs = eigvals[order], eigvecs[:, order]

    if n_particles is None:
        return eigvals[0], QuantumState.from_array(eigvecs[:, 0].reshape([-1, 1]))
    return _select_by_particle_number(
        eigvals, eigvecs, n_particles, number_operator
    )


def _zdiag_vector(operator: PauliwordOp, dim: int) -> np.ndarray:
    """Dense diagonal of a Z/I-only operator over the computational basis
    (qubit 0 = most significant bit, matching ``QuantumState.from_array``)."""
    n = operator.n_qubits
    r = np.arange(dim, dtype=np.int64)
    diag = np.zeros(dim, np.float64)
    for Z_symp, cz in zip(operator.Z_block, operator.coeff_vec):
        zmask = 0
        for q in np.nonzero(Z_symp)[0]:
            zmask |= 1 << (n - 1 - int(q))
        v = r & np.int64(zmask)
        for s in (32, 16, 8, 4, 2, 1):  # XOR parity fold
            v = v ^ (v >> s)
        diag += np.real(cz) * (1.0 - 2.0 * (v & 1))
    return diag


def _sector_rotate(eigvals, eigvecs, Nd, degeneracy_tol: float = 1e-8):
    """Rotate each near-degenerate multiplet so the (diagonal) number
    operator is diagonal within it.

    Any black-box eigensolver returns an ARBITRARY orthonormal basis inside
    a degenerate eigenspace, whose members generally are NOT particle-number
    eigenstates — their <N> lands between sectors and a round() filter
    misfires (a flaw the reference's sector scan, utils.py:53-69, inherits
    from ARPACK).  Diagonalising N restricted to each multiplet recovers
    exact sector eigenstates.  Returns (vals, vecs, <N> per column,
    multiplet id per column), energies ascending.
    """
    eigvals = np.asarray(eigvals, np.float64)
    order = np.argsort(eigvals)
    eigvals, eigvecs = eigvals[order], np.asarray(eigvecs)[:, order]
    scale = max(1.0, float(np.max(np.abs(eigvals))))
    nvals = np.empty(len(eigvals))
    group = np.empty(len(eigvals), int)
    out = eigvecs.copy()
    i = gid = 0
    while i < len(eigvals):
        j = i + 1
        while (
            j < len(eigvals)
            and abs(eigvals[j] - eigvals[i]) <= degeneracy_tol * scale
        ):
            j += 1
        Y = eigvecs[:, i:j]
        Nsub = Y.conj().T @ (Nd[:, None] * Y)
        w, U = np.linalg.eigh((Nsub + Nsub.conj().T) / 2)
        out[:, i:j] = Y @ U
        nvals[i:j] = w
        group[i:j] = gid
        i, gid = j, gid + 1
    return eigvals, out, nvals, group


def _select_by_particle_number(
    eigvals, eigvecs, n_particles, number_operator
) -> Tuple[float, QuantumState]:
    """First eigenpair whose <N> rounds to n_particles (reference
    utils.py:53-69's sector scan, shared by the host and device solvers),
    with degenerate multiplets sector-rotated first (``_sector_rotate``).

    A candidate must also actually BE a number eigenstate (variance check):
    when ``eigvecs`` spans only part of a degenerate multiplet, N is not
    invariant on the partial span and the rotated column can have
    <N> = n_particles while being a mixture of sectors — rounding alone
    (the reference's test) would silently return a wrong state."""
    assert number_operator is not None, "Must specify the number operator."
    assert not np.any(number_operator.X_block), "Number operator not diagonal"
    Nd = _zdiag_vector(number_operator, eigvecs.shape[0])
    vals, vecs, nvals, _ = _sector_rotate(eigvals, eigvecs, Nd)
    n_scale = max(1.0, float(np.max(np.abs(Nd))))
    for evl, evc, nv in zip(vals, vecs.T, nvals):
        if np.round(nv) == n_particles:
            n_var = float(np.linalg.norm((Nd - nv) * evc))
            if n_var > 1e-6 * n_scale:
                continue  # partial-multiplet mixture, not a sector state
            return evl, QuantumState.from_array(evc.reshape([-1, 1]))
    raise RuntimeError(
        "No eigenvector of the correct particle number was identified - "
        "try increasing n_eigs."
    )


def exact_gs_energy_matrix_free(operator: PauliwordOp, n_eigs: int = 1):
    """Ground state via the packed matrix-free matvec (no 2^n x 2^n matrix).

    Practical far beyond the reference's 30-qubit dense cap; cost per
    iteration is O(n_terms * 2^n).
    """
    return exact_gs_energy(operator.matrix_free_linear_operator(), n_eigs=n_eigs)


def exact_gs_energy_device(
    operator: PauliwordOp,
    n_eigs: int = 1,
    k: int = 0,
    initial_guess=None,
    n_particles=None,
    number_operator=None,
) -> Tuple[float, QuantumState]:
    """Ground-state energy and state by Lanczos on ``config.device``.

    Same contract as ``exact_gs_energy`` (reference ``utils.py:14-76``), but
    the operator is never a matrix: every step is one X-grouped matvec
    (``kernels/lanczos.py``).

    With ``n_particles`` the low spectrum is resolved WITH multiplicity by
    deflated restarts (``lanczos.lanczos_lowest_eigsh``), each degenerate
    multiplet is sector-rotated to diagonalise the number operator
    (``_sector_rotate``), and the lowest exact sector eigenstate is
    returned.  Sweeping stops once a CLOSED multiplet (one with a strictly
    higher eigenvalue found above it) contains a match; the sweep budget
    grows (up to the whole space) while none does.

    Under ``symmer_torch.use_mesh`` the matvec's rows are split over the
    mesh (``config.mesh``), as in symmer_tpu.
    """
    from .config import config
    from .kernels import lanczos

    x, z, c, nq = operator.x_pack, operator.z_pack, operator.coeff_vec, operator.n_qubits
    v0 = None
    if initial_guess is not None:
        v0 = np.asarray(initial_guess, complex).reshape(-1)

    if n_particles is None:
        evals, evecs = lanczos.lanczos_ground_state(x, z, c, nq, k=k, v0=v0, n_eigs=n_eigs,
                                                    mesh=config.mesh)
        return evals[0], QuantumState.from_array(evecs[:, 0].reshape([-1, 1]))

    assert number_operator is not None, "Must specify the number operator."
    Nd = _zdiag_vector(number_operator, 1 << nq)

    def _sector_match_in_closed_multiplet(vals, vecs) -> bool:
        if len(vals) < 2:
            return False
        _, _, nvals, group = _sector_rotate(vals, vecs, Nd)
        closed = group < group[-1]  # last multiplet may still be filling
        return bool(np.any(closed & (np.round(nvals) == n_particles)))

    dim = 1 << nq
    budget = max(n_eigs, 6)
    prepared = lanczos.prepare_operator(x, z, c, nq, config.mesh)
    while True:
        evals, evecs = lanczos.lanczos_lowest_eigsh(
            x, z, c, nq, n_vecs=budget, k=k, v0=v0,
            stop=_sector_match_in_closed_multiplet, prepared=prepared,
        )
        try:
            return _select_by_particle_number(evals, evecs, n_particles, number_operator)
        except RuntimeError:
            # len < budget: the complement was exhausted -- no more states
            if budget >= dim or len(evals) < budget:
                raise
            budget = min(dim, 4 * budget)


def exact_lowest_states_device(
    operator: PauliwordOp, n_states: int, k: int = 0, method: str = "auto"
) -> Tuple[np.ndarray, List[QuantumState]]:
    """Lowest ``n_states`` eigenpairs WITH multiplicity on ``config.device``.

    ``method='block'`` runs the band (block) recurrence
    (``lanczos.lanczos_block_eigsh``): one pass, multiplicities resolved up
    to the power-of-two block width; ``'deflate'`` runs deflated restarts
    (``lanczos.lanczos_lowest_eigsh``).  ``'auto'`` is ``'deflate'``
    (symmer_tpu picks ``'block'`` in float64): H2O's lowest four on an H100
    take the band recurrence three passes of 96, 192 and 384 blocks, which
    leave fewer than four converged pairs, where four deflated sweeps
    finish in under a third of the time (``chip_smoke.py`` phase 7).  When
    the block driver returns fewer than ``n_states`` pairs (its space closed,
    e.g. H proportional to the identity, or pairs left unconverged after its
    retries, with a warning), deflated restarts finish the job, as in
    symmer_tpu.  Returns (energies ascending, [QuantumState]); within an
    exactly degenerate multiplet the states are an orthonormal basis of
    the eigenspace.  Under ``symmer_torch.use_mesh`` the matvec's rows are
    split over the mesh (``config.mesh``), as in symmer_tpu.
    """
    from .config import config
    from .kernels import lanczos

    if method == "auto":
        method = "deflate"
    x, z, c, nq = operator.x_pack, operator.z_pack, operator.coeff_vec, operator.n_qubits
    solver = lanczos.lanczos_block_eigsh if method == "block" else lanczos.lanczos_lowest_eigsh
    prepared = lanczos.prepare_operator(x, z, c, nq, config.mesh)
    evals, evecs = solver(x, z, c, nq, n_vecs=n_states, k=k, prepared=prepared)
    if method == "block" and len(evals) < n_states:
        evals, evecs = lanczos.lanczos_lowest_eigsh(
            x, z, c, nq, n_vecs=n_states, k=k, prepared=prepared)
    states = [
        QuantumState.from_array(evecs[:, i].reshape([-1, 1]))
        for i in range(evecs.shape[1])
    ]
    return evals, states


def get_entanglement_entropy(psi: QuantumState, qubits: List[int]) -> float:
    """Von Neumann entropy of the bipartition (reference utils.py:78-94)."""
    reduced = psi.get_rdm(qubits)
    eigvals, _ = np.linalg.eig(reduced)
    eigvals = eigvals[eigvals > 0]
    return -np.sum(eigvals * np.log(eigvals)).real


def random_anitcomm_2n_1_PauliwordOp(n_qubits, complex_coeff=False, apply_clifford=True):
    """Structured maximal (2n+1)-term anticommuting set, optionally scrambled
    by random Clifford rotations (reference utils.py:96-157)."""
    Y_base = np.hstack((np.eye(n_qubits), np.tril(np.ones(n_qubits))))
    X_base = Y_base.copy()
    X_base[:, n_qubits:] = np.tril(np.ones(n_qubits), -1)
    ac_symp = np.vstack((Y_base, X_base))
    Z_symp = np.zeros(2 * n_qubits)
    Z_symp[n_qubits:] = np.ones(n_qubits)
    ac_symp = np.vstack((ac_symp, Z_symp)).astype(bool)

    coeff_vec = np.random.randn(ac_symp.shape[0]).astype(complex)
    if complex_coeff:
        coeff_vec += 1j * np.random.randn(2 * n_qubits + 1).astype(complex)
    P_anticomm = PauliwordOp(ac_symp, coeff_vec)

    if apply_clifford:
        U_cliff_rotations = []
        for _ in range(n_qubits * 5):
            P_rand = PauliwordOp.random(n_qubits, n_terms=1)
            P_rand.coeff_vec = np.array([1])
            U_cliff_rotations.append((P_rand, np.random.choice([np.pi / 2, -np.pi / 2])))
        P_anticomm = P_anticomm.perform_rotations(U_cliff_rotations)

    assert P_anticomm.n_terms == 2 * n_qubits + 1
    return P_anticomm


def tensor_list(factor_list: List[PauliwordOp]) -> PauliwordOp:
    """Recursive tensor product from the right (reference utils.py:160-171)."""
    return reduce(lambda x, y: x.tensor(y), factor_list)


def product_list(product_list: List[PauliwordOp]) -> PauliwordOp:
    """Recursive operator product from the right (reference utils.py:173-184)."""
    return reduce(lambda x, y: x * y, product_list)


def gram_schmidt_from_quantum_state(state) -> np.ndarray:
    """Unitary whose first column prepares the given state (utils.py:186-233)."""
    if isinstance(state, QuantumState):
        N_qubits = state.n_qubits
        state = state.to_sparse_matrix.toarray().reshape([-1])
    else:
        state = np.asarray(state).reshape([-1])
        N_qubits = round(np.log2(state.shape[0]))
        missing_amps = 2**N_qubits - state.shape[0]
        state = np.hstack((state, np.zeros(missing_amps, dtype=complex)))
    assert state.shape[0] == 2**N_qubits, "state is not defined on power of two"
    assert np.isclose(np.linalg.norm(state), 1), "state is not normalized"
    M = np.eye(2**N_qubits, dtype=complex)
    if np.isclose(state[0], 0):
        max_amp_ind = np.argmax(state)
        M[:, [0, max_amp_ind]] = M[:, [max_amp_ind, 0]]
    M[:, 0] = state
    for a in range(M.shape[0]):
        for b in range(a):
            M[:, a] -= (M[:, b].conj().T @ M[:, a]) * M[:, b]
        M[:, a] = M[:, a] / np.linalg.norm(M[:, a])
    return M


def matrix_allclose(A, B, tol: float = 1e-15) -> bool:
    """(reference utils.py:300-323)"""
    from scipy.sparse import csr_matrix

    if isinstance(A, csr_matrix) and isinstance(B, csr_matrix):
        max_diff = np.abs(A - B).max()
        return max_diff <= tol
    if isinstance(A, csr_matrix):
        A = A.toarray()
    if isinstance(B, csr_matrix):
        B = B.toarray()
    return np.allclose(A, B, atol=tol)


def get_PauliwordOp_root(power: float, pauli: PauliwordOp) -> PauliwordOp:
    """Arbitrary power of a single Pauli (reference utils.py:325-355)."""
    assert pauli.n_terms == 1, "can only take power of single operators"
    I_term = PauliwordOp.from_list(["I" * pauli.n_qubits])
    cos_term = np.cos(power * np.pi / 2)
    sin_term = np.sin(power * np.pi / 2)
    return I_term.multiply_by_constant(
        cos_term**2 + 1j * cos_term * sin_term
    ) + pauli.multiply_by_constant(-1j * cos_term * sin_term + sin_term**2)


def Get_AC_root(power: float, operator: AntiCommutingOp) -> PauliwordOp:
    """Arbitrary power of an anticommuting operator via unitary partitioning.

    (reference utils.py:357-385)
    """
    Ps, rot, gamma_l, AC_normed = operator.unitary_partitioning(up_method="LCU")
    Ps_root = get_PauliwordOp_root(power, Ps)
    rot_op = operator.R_LCU
    return (rot_op.dagger * Ps_root * rot_op).multiply_by_constant(gamma_l**power)
