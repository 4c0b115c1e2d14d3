"""Contextual-Subspace VQE projection (arXiv:2011.10027).

Parity surface of symmer ``projection/contextual_subspace.py``.
"""
from __future__ import annotations

from typing import List, Union

import numpy as np

from ..evolution import trotter
from ..operators import IndependentOp, NoncontextualOp, PauliwordOp, QuantumState
from .base import S3Projection
from .utils import (
    ObservableBiasing,
    StabilizerIdentification,
    stabilizer_walk,
    update_eigenvalues,
)


class ContextualSubspace(S3Projection):
    """(reference contextual_subspace.py:11-364)"""

    name = "contextual_subspace"

    def __init__(
        self,
        operator: PauliwordOp,
        noncontextual_strategy: str = "diag",
        noncontextual_solver: str = "brute_force",
        unitary_partitioning_method: str = "seq_rot",
        reference_state: Union[np.ndarray, QuantumState] = None,
        noncontextual_operator: NoncontextualOp = None,
    ):
        if reference_state is None or isinstance(reference_state, QuantumState):
            self.ref_state = reference_state
        else:
            self.ref_state = QuantumState(reference_state)
        extract_noncon_strat = noncontextual_strategy.split("_")
        self.nc_strategy = extract_noncon_strat[0]
        self.noncontextual_solver = noncontextual_solver
        self.unitary_partitioning_method = unitary_partitioning_method

        self.operator = operator
        if noncontextual_operator is None and self.nc_strategy != "StabilizeFirst":
            self.noncontextual_operator = NoncontextualOp.from_hamiltonian(
                operator, strategy=noncontextual_strategy
            )
        else:
            self.noncontextual_operator = noncontextual_operator
        self._noncontextual_update()

    def manual_stabilizers(self, S: Union[List[str], IndependentOp]) -> None:
        """(reference :73-88)"""
        if isinstance(S, list):
            S = IndependentOp.from_list(S)
        self.n_qubits_in_subspace = self.operator.n_qubits - S.n_terms
        self.return_NC = self.n_qubits_in_subspace == 0
        self.stabilizers = S
        self._prepare_stabilizers()

    def update_stabilizers(
        self,
        n_qubits: int,
        strategy: str = "aux_preserving",
        aux_operator: PauliwordOp = None,
        HF_array: np.ndarray = None,
        use_X_only: bool = True,
    ) -> None:
        """(reference :90-137)"""
        assert n_qubits <= self.operator.n_qubits, (
            "Cannot define a contextual subspace larger than the base Hamiltonian"
        )
        if n_qubits == 0:
            n_qubits = 1
            self.return_NC = True
        else:
            self.return_NC = False

        if n_qubits == self.operator.n_qubits:
            self.stabilizers = None
        else:
            if strategy == "aux_preserving":
                S = self._aux_operator_preserving_stabilizer_search(
                    n_qubits=n_qubits, aux_operator=aux_operator, use_X_only=use_X_only
                )
            elif strategy == "random":
                S = self._random_stabilizers(n_qubits=n_qubits)
            elif strategy == "HOMO_LUMO_biasing":
                S = self._HOMO_LUMO_biasing(
                    n_qubits=n_qubits, HF_array=HF_array,
                    weighting_operator=aux_operator, use_X_only=use_X_only,
                )
            else:
                raise ValueError("Unrecognised stabilizer search strategy.")
            self.n_qubits_in_subspace = self.operator.n_qubits - S.n_terms
            self.stabilizers = S
            self._prepare_stabilizers()

    def _noncontextual_update(self):
        """(reference :139-155)"""
        if self.noncontextual_operator is not None:
            self.noncontextual_operator.up_method = self.unitary_partitioning_method
            self.contextual_operator = self.operator - self.noncontextual_operator
            if self.contextual_operator.n_terms == 0:
                raise ValueError(
                    "The Hamiltonian is noncontextual, the contextual subspace is empty."
                )
            if self.nc_strategy != "solved":
                self.noncontextual_operator.solve(
                    strategy=self.noncontextual_solver, ref_state=self.ref_state
                )
            else:
                self.noncontextual_operator.update_clique_representative_operator()
            self.n_cliques = self.noncontextual_operator.n_cliques

    def _aux_operator_preserving_stabilizer_search(
        self, n_qubits: int, aux_operator: PauliwordOp, use_X_only: bool = True
    ) -> IndependentOp:
        """(reference :157-183)"""
        if aux_operator is None:
            if self.nc_strategy == "StabilizeFirst":
                aux_operator = self.operator
            else:
                aux_operator = self.contextual_operator
        SI = StabilizerIdentification(aux_operator, use_X_only=use_X_only)
        return SI.symmetry_generators_by_subspace_dimension(n_qubits)

    def _HOMO_LUMO_biasing(
        self, n_qubits: int, HF_array: np.ndarray,
        weighting_operator: PauliwordOp = None, use_X_only: bool = True,
    ) -> IndependentOp:
        """(reference :185-216)"""
        assert HF_array is not None, "Must supply the Hartree-Fock state for this strategy"
        OB = ObservableBiasing(
            base_operator=self.operator,
            HOMO_LUMO_gap=np.where(np.asarray(HF_array == 0).reshape(-1))[0][0] - 0.5,
        )
        return stabilizer_walk(
            n_sim_qubits=n_qubits, biasing_operator=OB,
            weighting_operator=weighting_operator, use_X_only=use_X_only,
        )

    def _random_stabilizers(self, n_qubits: int) -> IndependentOp:
        """(reference :218-245; bounded retries instead of a bare infinite loop)"""
        for _ in range(1000):
            try:
                S = PauliwordOp.random(
                    self.operator.n_qubits, self.operator.n_qubits - n_qubits, diagonal=True
                )
                S.coeff_vec[:] = 1
                return IndependentOp.from_PauliwordOp(S)
            except ValueError:
                continue
        raise RuntimeError("Could not identify an independent random stabilizer set")

    def _prepare_stabilizers(self) -> None:
        """(reference :247-296)"""
        self.S3_initialized = False
        if self.nc_strategy == "StabilizeFirst":
            self.noncontextual_operator = NoncontextualOp._from_stabilizers_noncontextual_op(
                H=self.operator, stabilizers=self.stabilizers, use_jordan_product=False
            )
            self._noncontextual_update()

        if self.noncontextual_operator.n_cliques > 0:
            clique_commutation = self.stabilizers.commutes_termwise(
                self.noncontextual_operator.clique_operator
            )
            mask_which_clique = np.all(clique_commutation, axis=0)
        else:
            mask_which_clique = []

        if not np.all(mask_which_clique):
            assert sum(mask_which_clique) == 1, (
                "Cannot enforce stabilizers from different cliques since "
                "unitary partitioning collapses onto just one of them."
            )
            self.noncontextual_operator.update_clique_representative_operator(
                clique_index=int(np.where(mask_which_clique)[0][0])
            )
            # the noncontextual ground state fixes <R A R^dag> = -1 where
            # R A R^dag = c * P_s; the value of the bare Pauli P_s is therefore
            # -c.  (c = -1 occurs when a clique collapses to a single term
            # with negative coefficient; assuming c = +1 flips the entire
            # sector -- a latent edge case in the reference, which hardcodes
            # the value -1, contextual_subspace.py:283-285.)
            rep = self.noncontextual_operator.mapped_clique_rep
            rep_value = -int(np.sign(rep.coeff_vec[0].real))
            augmented_generators = (
                IndependentOp(rep.symp_matrix, [rep_value])
                + self.noncontextual_operator.symmetry_generators
            )
            update_eigenvalues(
                generators=augmented_generators, stabilizers=self.stabilizers
            )
            self.perform_unitary_partitioning = True
        else:
            update_eigenvalues(
                generators=self.noncontextual_operator.symmetry_generators,
                stabilizers=self.stabilizers,
            )
            self.perform_unitary_partitioning = False

    def project_onto_subspace(self, operator_to_project: PauliwordOp = None):
        """(reference :298-332)"""
        if operator_to_project is None:
            operator_to_project = self.operator.copy()
        if self.stabilizers is None:
            return operator_to_project
        super().__init__(self.stabilizers)
        self.S3_initialized = True
        if self.perform_unitary_partitioning:
            rotated_op = operator_to_project.perform_rotations(
                self.noncontextual_operator.unitary_partitioning_rotations
            )
        else:
            rotated_op = operator_to_project
        cs_operator = self.perform_projection(rotated_op)

        if self.return_NC:
            assert cs_operator.n_qubits == 1, (
                "Projected operator consists of more than one qubit."
            )
            cs_operator = NoncontextualOp.from_PauliwordOp(cs_operator)
            cs_operator.solve()
            return cs_operator.energy
        return cs_operator

    def project_state(self, state_to_project: QuantumState = None) -> QuantumState:
        """(reference :334-364)"""
        if self.stabilizers is None:
            return state_to_project
        assert self.S3_initialized, (
            "Must first project an operator into the contextual subspace via "
            "the project_onto_subspace method"
        )
        if state_to_project is None:
            assert self.ref_state is not None, (
                "Must provide a state to project into the contextual subspace"
            )
            state_to_project = self.ref_state

        if self.perform_unitary_partitioning:
            if self.noncontextual_operator.unitary_partitioning_rotations == []:
                rotation = PauliwordOp.from_list(["I" * self.operator.n_qubits])
            else:
                rotation_generator = sum(
                    R * angle * 0.5 * 1j
                    for R, angle in self.noncontextual_operator.unitary_partitioning_rotations
                )
                rotation = trotter(rotation_generator)
            return self._project_state(rotation * state_to_project)
        return self._project_state(state_to_project)
