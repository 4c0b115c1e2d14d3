"""Z2-symmetry qubit tapering (arXiv:1701.08213).

Parity surface of symmer ``projection/qubit_tapering.py``.
"""
from __future__ import annotations

import warnings
from functools import cached_property
from typing import List, Union

import numpy as np

from ..operators import IndependentOp, PauliwordOp, QuantumState
from .base import S3Projection


class QubitTapering(S3Projection):
    """(reference qubit_tapering.py:9-111)"""

    name = "qubit_tapering"

    def __init__(self, operator: PauliwordOp, target_sqp: str = "Z") -> None:
        self.operator = operator
        self.target_sqp = target_sqp
        self.n_taper = self.symmetry_generators.n_terms
        super().__init__(self.symmetry_generators)

    @cached_property
    def symmetry_generators(self) -> IndependentOp:
        stabilizers = IndependentOp.symmetry_generators(self.operator)
        stabilizers.target_sqp = self.target_sqp
        return stabilizers

    def taper_it(
        self,
        ref_state: Union[List[int], np.ndarray, QuantumState] = None,
        sector: Union[List[int], np.ndarray] = None,
        aux_operator: PauliwordOp = None,
    ) -> PauliwordOp:
        """(reference qubit_tapering.py:54-106)"""
        if ref_state is not None:
            if not isinstance(ref_state, QuantumState):
                ref_state = QuantumState(ref_state)
            assert ref_state._is_normalized(), "Reference state is not normalized."

        if self.symmetry_generators != self.stabilizers:
            warnings.warn(
                "the defined symmetry generators have been updated from "
                "parent class stabilizers"
            )
            super().__init__(self.symmetry_generators)

        if aux_operator is not None:
            operator_to_taper = aux_operator.copy()
        else:
            operator_to_taper = self.operator.copy()

        tapered_operator = self.perform_projection(
            operator=operator_to_taper, ref_state=ref_state, sector=sector
        )

        if ref_state is not None:
            self.tapered_ref_state = self.project_state(ref_state)

        return tapered_operator

    def project_state(self, state_to_project: QuantumState) -> QuantumState:
        return self._project_state(state_to_project)
