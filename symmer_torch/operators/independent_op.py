"""Algebraically independent stabilizer sets.

API parity with symmer ``operators/independent_op.py``; the symmetry-generator
search runs on the packed GF(2) kernel-basis routine (kernels/gf2.py), which is
O(N^2) in qubits and term-count independent.
"""
from __future__ import annotations

import warnings
from functools import reduce
from typing import Dict, List, Tuple, Union

import numpy as np

from ..kernels import gf2, pack
from .base import PauliwordOp, QuantumState, single_term_expval
from .utils import check_independent


class IndependentOp(PauliwordOp):
    """Independent stabilizer set with coefficients in {0, +1, -1}.

    (reference independent_op.py:9-383)
    """

    def __init__(self, symp_matrix, coeff_vec=None, target_sqp: str = "Z"):
        if coeff_vec is None:
            coeff_vec = np.ones(np.atleast_2d(symp_matrix).shape[0], dtype=complex)
        super().__init__(symp_matrix, coeff_vec)
        self._post_init(target_sqp)

    def _post_init(self, target_sqp: str = "Z") -> None:
        self._check_stab()
        self.coeff_vec = self.coeff_vec.real.astype(int)
        self._check_independent()
        if target_sqp in ["X", "Z", "Y"]:
            self.target_sqp = target_sqp
        else:
            raise ValueError("Target single-qubit Pauli not recognised - must be X or Z")
        self.stabilizer_rotations = None
        self.used_indices = None

    @classmethod
    def from_planes(cls, x_pack, z_pack, coeff_vec, n_qubits) -> "IndependentOp":
        op = cls.__new__(cls)
        op._init_from_planes(x_pack, z_pack, coeff_vec, n_qubits)
        op._post_init()
        return op

    @classmethod
    def from_PauliwordOp(cls, PwordOp: PauliwordOp) -> "IndependentOp":
        return cls.from_planes(
            PwordOp.x_pack, PwordOp.z_pack, PwordOp.coeff_vec, PwordOp.n_qubits
        )

    @classmethod
    def from_list(cls, pauli_terms: List[str], coeff_vec=None) -> "IndependentOp":
        return cls.from_PauliwordOp(PauliwordOp.from_list(pauli_terms, coeff_vec))

    @classmethod
    def from_dictionary(cls, operator_dict: Dict[str, complex]) -> "IndependentOp":
        return cls.from_PauliwordOp(PauliwordOp.from_dictionary(operator_dict))

    @classmethod
    def symmetry_generators(
        cls, PwordOp: PauliwordOp, commuting_override: bool = False, largest_clique=False
    ) -> "IndependentOp":
        """Independent basis of operators commuting with every term of PwordOp.

        Kernel of the symplectic form: stack [Z|X] (swapped blocks) over the
        identity and column-reduce (reference independent_op.py:90-144); here
        via the packed GF(2) kernel-basis routine.
        """
        # rows are [Z|X]-swapped planes; kernel vectors v satisfy M.v = 0 mod 2,
        # i.e. v commutes with every term (fully bit-packed pipeline; the
        # two-block entry point sketches tall matrices without materialising
        # the [Z|X] concatenation)
        nq = PwordOp.n_qubits
        kernel = gf2.kernel_basis_symplectic(
            PwordOp.z_pack, nq, PwordOp.x_pack, nq
        )
        S_x = gf2.extract_bit_range(kernel, 0, nq)
        S_z = gf2.extract_bit_range(kernel, nq, nq)
        W = pack.n_words_for(nq)
        S_x = np.ascontiguousarray(S_x[:, :W]) if S_x.shape[1] >= W else np.pad(S_x, [(0, 0), (0, W - S_x.shape[1])])
        S_z = np.ascontiguousarray(S_z[:, :W]) if S_z.shape[1] >= W else np.pad(S_z, [(0, 0), (0, W - S_z.shape[1])])
        if kernel.shape[0] == 0:
            warnings.warn("The input PauliwordOp has no Z2 symmetries.")
            empty = cls.__new__(cls)
            empty._init_from_planes(
                np.zeros((0, PwordOp.n_words), np.uint64),
                np.zeros((0, PwordOp.n_words), np.uint64),
                np.zeros(0, complex),
                PwordOp.n_qubits,
            )
            empty.target_sqp = "Z"
            empty.stabilizer_rotations = None
            empty.used_indices = None
            empty.coeff_vec = empty.coeff_vec.real.astype(int)
            return empty
        S = cls.from_planes(S_x, S_z, np.ones(kernel.shape[0]), nq)
        if np.all(S.adjacency_matrix) or commuting_override:
            return S
        # non-commuting symmetries: take the largest commuting subset
        if S.n_terms < 10 or largest_clique:
            S_commuting = S.largest_clique(edge_relation="C")
        else:
            S_commuting = S.clique_cover(edge_relation="C", strategy="independent_set")[0]
            warnings.warn(
                "Greedy method may identify non-optimal commuting symmetry terms; "
                "might be able to taper again."
            )
        return cls.from_planes(
            S_commuting.x_pack, S_commuting.z_pack,
            np.ones(S_commuting.n_terms, dtype=complex), S_commuting.n_qubits,
        )

    def _check_stab(self) -> None:
        if not set(self.coeff_vec).issubset({0, +1, -1}):
            raise ValueError(f"Stabilizer coefficients not +/-1: {self.coeff_vec}")

    def _check_independent(self) -> None:
        if not check_independent(self):
            raise ValueError("The supplied stabilizers are not independent")

    def __str__(self) -> str:
        strings = pack.planes_to_strings(self.x_pack, self.z_pack, self.n_qubits)
        return " \n".join(f"{coeff} {p}" for p, coeff in zip(strings, self.coeff_vec))

    def __repr__(self) -> str:
        return str(self)

    def __add__(self, Pword: "IndependentOp") -> "IndependentOp":
        summed = PauliwordOp.append(self, Pword).cleanup()
        return IndependentOp.from_PauliwordOp(summed)

    def _rotate_by_single_Pword(self, Pword, angle=None) -> "IndependentOp":
        rotated = PauliwordOp._rotate_by_single_Pword(self, Pword, angle)
        return IndependentOp.from_PauliwordOp(rotated)

    def perform_rotations(self, rotations) -> "IndependentOp":
        rotated = PauliwordOp.perform_rotations(self, rotations)
        return IndependentOp.from_PauliwordOp(rotated)

    def _recursive_rotations(self, basis: "IndependentOp") -> None:
        """Map each stabilizer onto a single-qubit Pauli via XOR-pivot rotations.

        (reference independent_op.py:204-241)
        """
        # drop terms that are already single-qubit Paulis
        weights = pack.popcount_rows(basis.x_pack) + pack.popcount_rows(basis.z_pack)
        non_sqp = np.where(weights != 1)[0]
        sqp_rows = np.where(weights == 1)[0]
        basis_non_sqp = (
            PauliwordOp.from_planes(
                basis.x_pack[non_sqp], basis.z_pack[non_sqp],
                basis.coeff_vec[non_sqp], basis.n_qubits,
            )
            if len(non_sqp) else None
        )
        for r in sqp_rows:
            symp_row = np.concatenate([
                pack.unpack_bits(basis.x_pack[r : r + 1], self.n_qubits)[0],
                pack.unpack_bits(basis.z_pack[r : r + 1], self.n_qubits)[0],
            ])
            idx = int(np.where(symp_row)[0][0]) % self.n_qubits
            self.used_indices += [idx, idx + self.n_qubits]
        if basis_non_sqp is None or basis_non_sqp.n_terms == 0:
            return None
        symp = basis_non_sqp.symp_matrix
        row_sum = np.sum(symp, axis=1)
        pivot_row = symp[np.argsort(row_sum, kind="stable")[0]]
        non_I = np.setdiff1d(np.where(pivot_row)[0], np.array(self.used_indices))
        col_sum = np.sum(symp, axis=0)
        support = pivot_row * col_sum
        pivot_point = non_I[np.argmin(support[non_I])]
        target = np.zeros(2 * self.n_qubits, dtype=int)
        target[pivot_point + self.n_qubits * (-1) ** (pivot_point // self.n_qubits)] = 1
        pivot_rotation = PauliwordOp(np.bitwise_xor(target, pivot_row.astype(int)), [1])
        self.stabilizer_rotations.append((pivot_rotation, None))
        rotated_basis = PauliwordOp._rotate_by_single_Pword(
            basis_non_sqp, pivot_rotation
        )
        return self._recursive_rotations(rotated_basis)

    def generate_stabilizer_rotations(self) -> None:
        """Find the Clifford rotations mapping every stabilizer to a single-qubit
        Pauli (reference independent_op.py:243-273).

        The rotation set depends only on the symplectic planes and the target
        single-qubit Pauli, NOT on the sector coefficients, so the result is
        memoised per (planes, target) -- the flagship taper flow needs it for
        the operator rotation, the rotated stabilizers AND the reference-state
        projection, and re-deriving it pays the recursion three times."""
        cache = getattr(self, "_stab_rot_cache", None)
        key = (self.x_pack.tobytes(), self.z_pack.tobytes(), self.target_sqp)
        if cache is not None and cache[0] == key:
            self.stabilizer_rotations = list(cache[1])
            self.used_indices = list(cache[2])
            return
        assert self.n_terms <= self.n_qubits, (
            "Too many terms in basis to reduce to single-qubit Paulis"
        )
        assert np.all(self.adjacency_matrix), (
            "The basis is not commuting, hence the rotation is not possible"
        )
        self.stabilizer_rotations = []
        self.used_indices = []
        basis = PauliwordOp.from_planes(
            self.x_pack.copy(), self.z_pack.copy(),
            np.ones(self.n_terms, dtype=complex), self.n_qubits,
        )
        self._recursive_rotations(basis)
        rotated_basis = PauliwordOp.perform_rotations(
            basis, self.stabilizer_rotations
        )
        for P in rotated_basis:
            symp_row = P.symp_matrix[0]
            sqp_index = int(np.where(symp_row)[0][0]) % self.n_qubits
            target = np.zeros(2 * self.n_qubits, dtype=int)
            if self.target_sqp in ["X", "Y"]:
                target[sqp_index] = 1
            if self.target_sqp in ["Y", "Z"]:
                target[sqp_index + self.n_qubits] = 1
            R_symp = np.bitwise_xor(target, symp_row.astype(int))
            if np.any(R_symp):
                self.stabilizer_rotations.append((PauliwordOp(R_symp, [1]), None))
        self._stab_rot_cache = (
            key, list(self.stabilizer_rotations), list(self.used_indices)
        )

    def copy(self) -> "IndependentOp":
        op = IndependentOp.__new__(IndependentOp)
        op._init_from_planes(
            self.x_pack.copy(), self.z_pack.copy(), self.coeff_vec.copy(), self.n_qubits
        )
        op.coeff_vec = self.coeff_vec.copy()
        op.target_sqp = self.target_sqp
        op.stabilizer_rotations = None
        op.used_indices = None
        return op

    def update_sector(
        self,
        ref_state: Union[List[int], np.ndarray, QuantumState],
        threshold: float = 0.5,
    ) -> None:
        """Measure each stabilizer on the reference state to fix its +/-1 value.

        (reference independent_op.py:275-300; the per-stabilizer expectation
        values are evaluated by the packed one-sparse kernel rather than a
        process pool)
        """
        if not isinstance(ref_state, QuantumState):
            ref_state = QuantumState(ref_state)
        assert ref_state._is_normalized(), "Reference state is not normalized."
        # ONE batched pass over all stabilizers (the reference parallelises
        # S separate expectation evaluations, independent_op.py:364-383)
        from ..kernels import state_core

        expvals = state_core.termwise_expval(
            self.x_pack, self.z_pack, ref_state._s_pack, ref_state._amps
        ).real
        self.coeff_vec = np.where(
            np.abs(expvals) > threshold, np.sign(expvals), 0
        ).astype(int)
        if np.any(self.coeff_vec == 0):
            S_zero = self[self.coeff_vec == 0]
            S_zero.coeff_vec[:] = 1
            S_zero = list(S_zero.to_dictionary.keys())
            warnings.warn(
                f"The stabilizers {S_zero} were assigned zero values - bad reference state."
            )

    def rotate_onto_single_qubit_paulis(self) -> "IndependentOp":
        """(reference independent_op.py:302-318)

        One order-preserving planes-level Clifford pass over the whole basis
        (the reference rotates each stabilizer separately to keep row i <->
        stabilizer i alignment; the native clifford_sequence never reorders
        rows, so the batched pass preserves the same alignment -- including
        rows whose sector value is 0, which a per-term rotate-then-cleanup
        would silently drop)."""
        self.generate_stabilizer_rotations()
        if self.stabilizer_rotations != []:
            from ..kernels import np_core

            rx = np.asarray([r.x_pack[0] for r, _ in self.stabilizer_rotations])
            rz = np.asarray([r.z_pack[0] for r, _ in self.stabilizer_rotations])
            m4s = np.ones(len(self.stabilizer_rotations), np.int64)
            x, z, c = np_core.clifford_sequence(
                np.ascontiguousarray(self.x_pack),
                np.ascontiguousarray(self.z_pack),
                self.coeff_vec.astype(complex), rx, rz, m4s,
            )
            # Clifford rotation preserves independence and +/-1 reality of the
            # coefficients; re-validation (IndependentOp.from_PauliwordOp)
            # would pay an RREF per call for an invariant that holds by
            # construction
            out = IndependentOp.__new__(IndependentOp)
            out._init_from_planes(x, z, c, self.n_qubits)
            out.coeff_vec = out.coeff_vec.real.astype(int)
            out.target_sqp = self.target_sqp
            out.stabilizer_rotations = None
            out.used_indices = None
            return out
        return self

    def __getitem__(self, key) -> "IndependentOp":
        mask = self._key_to_mask(key)
        return IndependentOp.from_planes(
            self.x_pack[mask], self.z_pack[mask], self.coeff_vec[mask], self.n_qubits
        )

    def __iter__(self):
        return iter([self[i] for i in range(self.n_terms)])


def assign_value(S: PauliwordOp, ref_state: QuantumState, threshold: float = 0.5) -> int:
    """+/-1 eigenvalue of a stabilizer w.r.t. a reference state; 0 if ambiguous.

    (reference independent_op.py:364-383)
    """
    expval = single_term_expval(S, ref_state)
    if abs(expval) > threshold:
        return int(np.sign(expval))
    return 0
