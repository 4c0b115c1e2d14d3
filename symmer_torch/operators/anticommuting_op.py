"""Pairwise-anticommuting Pauli sets and unitary partitioning.

API parity with symmer ``operators/anticommuting_op.py``: reduce a sum of
anticommuting Paulis to a single term either by a sequence of rotations
(seq_rot, reference :103-151) or a linear combination of unitaries
(LCU, arXiv:1908.08067, reference :239-349).
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from ..kernels import pack
from .base import PauliwordOp
from .utils import binary_array_to_int


class AntiCommutingOp(PauliwordOp):
    def __init__(self, AC_op_symp_matrix, coeff_list):
        super().__init__(AC_op_symp_matrix, coeff_list)
        self._validate_ac()

    def _validate_ac(self):
        adj_mat = self.adjacency_matrix.copy()
        adj_mat[np.diag_indices_from(adj_mat)] = False
        assert not np.any(adj_mat), (
            "operator needs to be made of anti-commuting Pauli operators"
        )
        self.X_sk_rotations = []
        self.R_LCU = None

    @classmethod
    def from_planes(cls, x_pack, z_pack, coeff_vec, n_qubits) -> "AntiCommutingOp":
        op = cls.__new__(cls)
        op._init_from_planes(x_pack, z_pack, coeff_vec, n_qubits)
        op._validate_ac()
        return op

    @classmethod
    def from_list(cls, pauli_terms, coeff_vec=None) -> "AntiCommutingOp":
        return cls.from_PauliwordOp(PauliwordOp.from_list(pauli_terms, coeff_vec))

    @classmethod
    def from_dictionary(cls, operator_dict) -> "AntiCommutingOp":
        return cls.from_PauliwordOp(PauliwordOp.from_dictionary(operator_dict))

    @classmethod
    def from_PauliwordOp(cls, PwordOp: PauliwordOp) -> "AntiCommutingOp":
        return cls.from_planes(
            PwordOp.x_pack, PwordOp.z_pack, PwordOp.coeff_vec, PwordOp.n_qubits
        )

    def get_least_dense_term_index(self) -> int:
        """Index of the least dense Pauli term with a NONZERO coefficient
        (reference :78-100 picks least dense unconditionally and then
        unitary_partitioning has to warn and re-select when that term's
        coefficient is zero; skipping zero-coeff terms up front makes the
        auto-selection silent).  Falls back to the overall least dense term
        when every coefficient is zero."""
        pos_terms_occur = self.X_block | self.Z_block
        ints = np.array(binary_array_to_int(pos_terms_occur.astype(int)), dtype=object)
        order = np.argsort(ints, kind="stable")
        nonzero = ~np.isclose(self.coeff_vec[order], 0)
        if nonzero.any():
            return int(order[np.argmax(nonzero)])
        return int(order[0])

    def _recursive_seq_rotations(self, AC_op: PauliwordOp) -> PauliwordOp:
        if AC_op.n_terms == 1:
            return AC_op
        s_index, k_index = 0, 1
        op_for_rotation = AC_op.copy()
        P_s = PauliwordOp.from_planes(
            op_for_rotation.x_pack[s_index], op_for_rotation.z_pack[s_index],
            [1], self.n_qubits,
        )
        beta_s = op_for_rotation.coeff_vec[s_index]
        beta_k = op_for_rotation.coeff_vec[k_index]
        theta_sk = np.arctan(beta_k / beta_s)
        if beta_s.real < 0:
            theta_sk = theta_sk + np.pi
        assert np.isclose(
            (beta_k * np.cos(theta_sk) - beta_s * np.sin(theta_sk)), 0
        ), "term not zeroing out"
        # X_sk = -i P_s P_k
        jP_k = PauliwordOp.from_planes(
            op_for_rotation.x_pack[k_index], op_for_rotation.z_pack[k_index],
            [-1j], self.n_qubits,
        )
        X_sk = P_s * jP_k
        if X_sk.coeff_vec[0].real < 0:
            X_sk.coeff_vec[0] *= -1
            theta_sk *= -1
        self.X_sk_rotations.append((X_sk, float(theta_sk.real)))
        op_for_rotation.coeff_vec[s_index] = np.sqrt(beta_s**2 + beta_k**2)
        op_for_rotation.coeff_vec[k_index] = 0
        keep = [i for i in range(op_for_rotation.n_terms) if i != k_index]
        AC_op_rotated = PauliwordOp.from_planes(
            op_for_rotation.x_pack[keep], op_for_rotation.z_pack[keep],
            op_for_rotation.coeff_vec[keep], self.n_qubits,
        )
        return self._recursive_seq_rotations(AC_op_rotated)

    def unitary_partitioning(
        self, s_index: int = None, up_method: Optional[str] = "seq_rot"
    ):
        """Reduce self to a single Pauli term (reference :153-217).

        Returns:
            Ps: the single Pauli term rotated onto
            rotations: [(PauliwordOp, angle)] implementing the reduction
            gamma_l: normalisation of the clique
            AC_normed: self / gamma_l
        """
        assert up_method in ["LCU", "seq_rot"], (
            f"unknown unitary partitioning method: {up_method}"
        )
        if s_index is None:
            s_index = self.get_least_dense_term_index()
        if np.isclose(self.coeff_vec[s_index], 0):
            s_index = int(np.argmax(abs(self.coeff_vec)))
            warnings.warn(
                "s indexed term has zero coeff, s_index set to "
                f"{s_index} so that nonzero operator is rotated onto"
            )
        s_index = int(s_index)
        BsPs = self[s_index]
        no_BsPs = (self - BsPs).cleanup()
        if len(no_BsPs.coeff_vec) == 1 and no_BsPs.coeff_vec[0] == 0:
            AC_op = BsPs
        else:
            AC_op = BsPs.append(no_BsPs)

        if AC_op.n_terms == 1:
            rotations = []
            gamma_l = np.linalg.norm(AC_op.coeff_vec)
            AC_op.coeff_vec = AC_op.coeff_vec / gamma_l
            return AC_op, rotations, gamma_l, self.multiply_by_constant(1 / gamma_l)

        assert np.isclose(np.sum(AC_op.coeff_vec.imag), 0), (
            "cannot apply unitary partitioning to operator with complex coeffs"
        )
        gamma_l = np.linalg.norm(AC_op.coeff_vec)
        AC_op.coeff_vec = AC_op.coeff_vec / gamma_l

        if up_method == "seq_rot":
            if len(self.X_sk_rotations) != 0:
                self.X_sk_rotations = []
            Ps = self._recursive_seq_rotations(AC_op)
            rotations = self.X_sk_rotations
        else:
            if self.R_LCU is not None:
                self.R_LCU = None
            Ps = self.generate_LCU_operator(AC_op)
            rotations = LCU_as_seq_rot(self.R_LCU)
        return Ps, rotations, gamma_l, self.multiply_by_constant(1 / gamma_l)

    def multiply_by_constant(self, constant: float) -> "AntiCommutingOp":
        return AntiCommutingOp.from_planes(
            self.x_pack, self.z_pack, self.coeff_vec * constant, self.n_qubits
        )

    @classmethod
    def random(cls, n_qubits: int, n_terms: Union[None, int] = None, apply_clifford=True):
        from ..utils import random_anitcomm_2n_1_PauliwordOp

        if n_terms is None:
            n_terms = 2 * n_qubits + 1
        assert n_terms <= 2 * n_qubits + 1, (
            f"cannot have {n_terms} Pops on {n_qubits} qubits"
        )
        return cls.from_PauliwordOp(
            random_anitcomm_2n_1_PauliwordOp(n_qubits, apply_clifford=apply_clifford)[:n_terms]
        )

    def generate_LCU_operator(self, AC_op) -> PauliwordOp:
        """R = cos(a/2) I - sin(a/2) sum_k d_k P_k P_s (reference :239-288)."""
        s_index = 0
        Ps_LCU = PauliwordOp.from_planes(
            AC_op.x_pack[s_index], AC_op.z_pack[s_index], [1], AC_op.n_qubits
        )
        beta_s = AC_op.coeff_vec[s_index]
        no_βsPs = AC_op - Ps_LCU.multiply_by_constant(beta_s)
        omega_l = np.linalg.norm(no_βsPs.coeff_vec)
        no_βsPs.coeff_vec = no_βsPs.coeff_vec / omega_l
        phi_n_1 = np.arccos(beta_s.real)
        if phi_n_1 > np.pi:
            phi_n_1 = 2 * np.pi - phi_n_1
        alpha = phi_n_1
        I_term = "I" * Ps_LCU.n_qubits
        self.R_LCU = PauliwordOp.from_dictionary({I_term: np.cos(alpha / 2)})
        sin_term = -np.sin(alpha / 2)
        for k in range(no_βsPs.n_terms):
            dk_PkPs = no_βsPs[k] * Ps_LCU
            self.R_LCU += dk_PkPs.multiply_by_constant(sin_term)
        return Ps_LCU


def LCU_as_seq_rot(R_LCU: PauliwordOp) -> List[Tuple[PauliwordOp, float]]:
    """Convert an LCU rotation operator into 2(M-1) sequenced rotations.

    (reference :290-349, equations 18-19 of arXiv:1907.09040)
    """
    if isinstance(R_LCU, list) and len(R_LCU) == 0:
        return list()
    assert R_LCU.n_terms > 1, "AC_op must have more than 1 term"
    assert np.isclose(np.linalg.norm(R_LCU.coeff_vec), 1), "AC_op must be l2 normalized"
    expon_p_terms = []
    coeff_vec = R_LCU.coeff_vec.real + R_LCU.coeff_vec.imag
    for k in range(1, R_LCU.n_terms):
        P_k = R_LCU[k]
        c_k = coeff_vec[k]
        theta_k = np.arcsin(c_k / np.linalg.norm(coeff_vec[: (k + 1)]))
        P_k.coeff_vec[0] = 1
        expon_p_terms.append((P_k, float(theta_k)))
    expon_p_terms = [*expon_p_terms, *expon_p_terms[::-1]]
    return expon_p_terms


def conjugate_Pop_with_R(Pop: PauliwordOp, R: PauliwordOp) -> PauliwordOp:
    """Adjoint rotation R Pop R^dag for R a normalised linear combination of
    Paulis.  The reference keeps this commented out (anticommuting_op.py:351-452);
    the packed all-pairs kernel makes the direct product tractable.
    """
    return (R * Pop * R.dagger).cleanup()
