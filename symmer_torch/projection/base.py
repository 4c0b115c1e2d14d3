"""Stabilizer-subspace (S3) projection engine.

Parity surface of symmer ``projection/base.py``: rotate the stabilizers onto
single-qubit Paulis via Cliffords, drop operator terms anticommuting with them,
fix the +/-1 eigenvalues as coefficient sign flips, and delete the stabilised
qubit columns from the packed planes.
"""
from __future__ import annotations

from functools import reduce
from typing import List, Union

import numpy as np

from ..config import config
from ..kernels import dispatch, pack
from ..operators import IndependentOp, PauliwordOp, QuantumState
from ..evolution import Had, trotter


def _apply_sign_parity(x_keep, z_keep, coeffs, neg_x, neg_z):
    """Coefficient sign flips from the -1 eigenvalue assignments: each
    (single-qubit) rotated stabilizer tests ONE symplectic bit, so the
    product of the -1 assignments is a parity over the OR of their bit
    masks (``dispatch.stabilizer_masks``; a 0 assignment behaves as +1,
    reference base.py:67-72)."""
    if not (neg_x.any() or neg_z.any()):
        return coeffs
    parity = (
        np.bitwise_count(x_keep & neg_x).sum(axis=1)
        + np.bitwise_count(z_keep & neg_z).sum(axis=1)
    ).astype(np.int64) & 1
    return coeffs * (1 - 2 * parity)


class S3Projection:
    """(reference projection/base.py:7-159)"""

    rotated_flag = False

    def __init__(self, stabilizers: IndependentOp) -> None:
        self.stabilizers = stabilizers

    def _perform_projection(self, operator: PauliwordOp) -> PauliwordOp:
        """Project onto the subspace stabilised by single-qubit Paulis.

        (reference :44-84)
        """
        assert operator.n_qubits == self.stabilizers.n_qubits, (
            "The input operator does not have the same number of qubits as the stabilizers"
        )
        assert self.rotated_flag, (
            "The operator has not been rotated - intended for use with "
            "perform_projection method"
        )
        self.rotated_flag = False

        # drop terms anticommuting with any rotated stabilizer
        commutes_all = np.all(
            operator.commutes_termwise(self.rotated_stabilizers), axis=1
        )
        x_keep = operator.x_pack[commutes_all]
        z_keep = operator.z_pack[commutes_all]
        op_coef = operator.coeff_vec[commutes_all]

        rot = self.rotated_stabilizers
        free_mask = np.zeros(operator.n_qubits, dtype=bool)
        free_mask[self.free_qubit_indices] = True
        _, _, neg_x, neg_z, _ = dispatch.stabilizer_masks(
            rot.x_pack, rot.z_pack, rot.coeff_vec, free_mask
        )
        op_coef = _apply_sign_parity(x_keep, z_keep, op_coef, neg_x, neg_z)

        # delete the stabilised qubit columns (packed byte-LUT pext)
        n_free = len(self.free_qubit_indices)
        if n_free:
            return PauliwordOp.from_planes(
                pack.select_columns(x_keep, free_mask),
                pack.select_columns(z_keep, free_mask),
                op_coef, n_free,
            ).cleanup()
        return PauliwordOp(np.array([], dtype=bool), [np.sum(op_coef)])

    def perform_projection(
        self,
        operator: PauliwordOp,
        ref_state: Union[List[int], np.ndarray, QuantumState] = None,
        sector: Union[List[int], np.ndarray] = None,
    ) -> PauliwordOp:
        """(reference :86-124)"""
        if self.stabilizers.n_terms == 0:
            # no stabilizers (e.g. a Hamiltonian with no Z2 symmetries):
            # nothing to project -- return the operator unchanged, as the
            # reference does, instead of crashing on the empty rotation set
            self.rotated_stabilizers = self.stabilizers
            self.stab_qubit_indices = np.array([], dtype=int)
            self.free_qubit_indices = np.arange(operator.n_qubits)
            self.rotated_flag = True
            return operator.cleanup()
        if sector is None and ref_state is not None:
            self.stabilizers.update_sector(ref_state)
        elif sector is not None:
            self.stabilizers.coeff_vec = np.array(sector, dtype=int)

        self.rotated_stabilizers = self.stabilizers.rotate_onto_single_qubit_paulis()
        self.stab_qubit_indices = (
            np.where(self.rotated_stabilizers.symp_matrix)[1] % operator.n_qubits
        )
        self.free_qubit_indices = np.setdiff1d(
            np.arange(operator.n_qubits), self.stab_qubit_indices
        )

        rotations = self.stabilizers.stabilizer_rotations
        from ..operators.device_op import DeviceOperator

        if isinstance(operator, DeviceOperator):
            # device-resident flagship flow: the operator planes never leave
            # device memory -- the stabilizer bookkeeping above is O(n_qubits) host
            # work, the projection is one fused kernel + one scalar sync.
            # Mirror the host path's width guard (perform_projection via
            # _perform_projection asserts operator/stabilizer qubit counts):
            # a once-projected resident operator keeps FULL-width planes, so
            # feeding it into a second projection whose stabilizers index the
            # REDUCED qubits would misalign columns without this check.
            if operator.n_qubits != self.stabilizers.n_qubits:
                raise ValueError(
                    f"resident operator indexes {operator.n_qubits} qubits "
                    f"but the stabilizers {self.stabilizers.n_qubits}; for a "
                    "chained projection download the first result with "
                    ".to_host() (applies the column reduction) and re-upload"
                )
            if operator._free_mask is not None:
                raise ValueError(
                    "resident operator carries a pending projection (its "
                    "planes are full-width with stabilized columns zeroed); "
                    "chain projections through .to_host() so the second "
                    "stabilizer set indexes the reduced qubits"
                )
            assert all(
                dispatch.is_clifford_angle(angle) is not None
                for _, angle in rotations
            ), "device-resident projection requires Clifford rotations"
            free_mask = np.zeros(self.stabilizers.n_qubits, dtype=bool)
            free_mask[self.free_qubit_indices] = True
            self.rotated_flag = False
            return operator.clifford_rotate_project(
                rotations, self.rotated_stabilizers, free_mask
            )
        if self._use_fused_device_path(operator, rotations):
            return self._perform_projection_device(operator, rotations)
        if self._host_fused_applies(operator, rotations):
            return self._perform_projection_host_fused(operator, rotations)

        if len(rotations) > 0:
            op_rotated = operator.perform_rotations(rotations)
        else:
            op_rotated = operator

        self.rotated_flag = True
        return self._perform_projection(operator=op_rotated)

    def _use_fused_device_path(self, operator: PauliwordOp, rotations) -> bool:
        """True when the one-round-trip device projection applies: a large
        operator, Clifford-only stabilizer rotations (always the case for
        tapering; CS-VQE applies its non-Clifford UP rotations before calling
        here), and at least one free qubit."""
        if len(self.free_qubit_indices) == 0:
            return False
        if not all(
            dispatch.is_clifford_angle(angle) is not None
            for _, angle in rotations
        ):
            return False
        T, W = operator.n_terms, operator.n_words
        return config.use_device_io(max(1, len(rotations)) * T * W)

    def _host_fused_applies(self, operator: PauliwordOp, rotations) -> bool:
        """Host analog of the fused-device eligibility: Clifford-only
        rotations, at least one free qubit, and a large enough operator that
        the fused pass (no intermediate full-width cleanup, single-qubit
        commute mask instead of a general GF(2) matmul) pays for itself."""
        if len(self.free_qubit_indices) == 0 or operator.n_terms < 256:
            return False
        return all(
            dispatch.is_clifford_angle(angle) is not None
            for _, angle in rotations
        )

    def _perform_projection_host_fused(
        self, operator: PauliwordOp, rotations
    ) -> PauliwordOp:
        """Rotation + projection fused on the packed host path.

        Semantically identical to ``perform_rotations`` followed by
        ``_perform_projection`` but with the redundant work removed:

        - Clifford rotations preserve term count, so the full-width cleanup
          ``perform_rotations`` ends with is dropped -- ONE cleanup runs at
          the end, on the column-reduced (narrower) planes.
        - The rotated stabilizers are single-qubit Paulis on DISTINCT qubits,
          so the per-stabilizer anticommutation tests are independent bits of
          one packed XOR expression instead of a general termwise GF(2)
          product.
        """
        from ..kernels import np_core

        x, z = operator.x_pack, operator.z_pack
        c = np.asarray(operator.coeff_vec, complex)
        native_out = self._try_native_fused(x, z, c, rotations)
        if native_out is not None:
            return native_out
        if rotations:
            rx = np.asarray([r.x_pack[0] for r, _ in rotations])
            rz = np.asarray([r.z_pack[0] for r, _ in rotations])
            m4s = np.asarray(
                [dispatch.is_clifford_angle(a) % 4 for _, a in rotations],
                np.int64,
            )
            x, z, c = np_core.clifford_sequence(
                np.ascontiguousarray(x), np.ascontiguousarray(z), c, rx, rz, m4s
            )

        # single-qubit stabilizers at DISTINCT qubits: the symplectic-form bit
        # for the stabilizer at qubit q is (x_q & s_z) ^ (z_q & s_x), and the
        # stabilizer masks never overlap, so one packed XOR tests all of them
        # at once (covers X, Y and Z target stabilizers: for a Y stabilizer
        # both mask bits are set and the test is x_q ^ z_q)
        rot = self.rotated_stabilizers
        free_mask = np.zeros(operator.n_qubits, dtype=bool)
        free_mask[self.free_qubit_indices] = True
        zmask, xmask, neg_x, neg_z, _ = dispatch.stabilizer_masks(
            rot.x_pack, rot.z_pack, rot.coeff_vec, free_mask
        )
        commutes_all = ~np.any((x & zmask) ^ (z & xmask), axis=1)
        x_keep = x[commutes_all]
        z_keep = z[commutes_all]
        op_coef = _apply_sign_parity(
            x_keep, z_keep, c[commutes_all], neg_x, neg_z
        )

        self.rotated_flag = False
        n_free = len(self.free_qubit_indices)
        return PauliwordOp.from_planes(
            pack.select_columns(x_keep, free_mask),
            pack.select_columns(z_keep, free_mask),
            op_coef, n_free,
        ).cleanup()

    def _try_native_fused(self, x, z, c, rotations):
        """One-pass native rotate+project+dedup (gf2core
        clifford_project_cleanup); None when the native library is missing
        or the operator is too wide for its register budget."""
        try:
            from ..native import gf2core
        except Exception:  # pragma: no cover
            return None
        if gf2core is None:
            return None
        rot = self.rotated_stabilizers
        n_qubits = self.stabilizers.n_qubits
        W = x.shape[1]
        if rotations:
            rx = np.asarray([r.x_pack[0] for r, _ in rotations])
            rz = np.asarray([r.z_pack[0] for r, _ in rotations])
            m4s = np.asarray(
                [dispatch.is_clifford_angle(a) % 4 for _, a in rotations],
                np.int64,
            )
        else:
            rx = np.zeros((0, W), np.uint64)
            rz = np.zeros((0, W), np.uint64)
            m4s = np.zeros(0, np.int64)
        free_bool = np.zeros(n_qubits, dtype=bool)
        free_bool[self.free_qubit_indices] = True
        zmask, xmask, negx, negz, colmask = dispatch.stabilizer_masks(
            rot.x_pack, rot.z_pack, rot.coeff_vec, free_bool
        )
        n_free = len(self.free_qubit_indices)
        Wout = pack.n_words_for(n_free)
        out = gf2core.clifford_project_cleanup(
            x, z, c, rx, rz, m4s, zmask, xmask, negx, negz, colmask, Wout
        )
        if out is None:  # W > 8: fall back to the staged path
            return None
        xo, zo, co = out
        self.rotated_flag = False
        thr = config.zero_threshold
        keep = np.abs(co) > thr
        if not keep.all():
            xo, zo, co = xo[keep], zo[keep], co[keep]
        if xo.shape[0] == 0:
            return PauliwordOp(np.zeros((1, 2 * n_free), dtype=bool), [0])
        return PauliwordOp.from_planes(xo, zo, co, n_free)

    def _perform_projection_device(
        self, operator: PauliwordOp, rotations
    ) -> PauliwordOp:
        """Rotation + projection + cleanup fused into one device round trip
        (kernels/torch_core.clifford_project_cleanup).  Semantically identical to
        perform_rotations followed by _perform_projection: the device kernel
        zeroes the stabilized columns before dedup (grouping-equivalent to
        deleting them) and the columns are deleted here on the compacted
        result."""
        rot = self.rotated_stabilizers
        free_mask = np.zeros(operator.n_qubits, dtype=bool)
        free_mask[self.free_qubit_indices] = True
        rot_planes = [(r.x_pack[0], r.z_pack[0], angle) for r, angle in rotations]
        x, z, c = dispatch.clifford_rotate_project(
            operator.x_pack, operator.z_pack, operator.coeff_vec,
            rot_planes, rot.x_pack, rot.z_pack, rot.coeff_vec,
            free_mask, zero_threshold=1e-15,
        )
        self.rotated_flag = False
        free = self.free_qubit_indices
        if x.shape[0] == 0:
            # every term projected away: an explicit zero operator on the
            # free qubits (what the host path's cleanup of an empty
            # operator produces)
            return PauliwordOp(
                np.zeros((1, 2 * len(free)), dtype=bool), [0]
            )
        # packed column deletion (byte-LUT pext) -- no boolean round trip
        return PauliwordOp.from_planes(
            pack.select_columns(x, free_mask),
            pack.select_columns(z, free_mask),
            c, len(free),
        )

    def _project_state(self, state: QuantumState) -> QuantumState:
        """Project a state into the stabilizer subspace (reference :126-159).

        The reference multiplies the Hadamard/projector/rotation factors into
        one transformation OPERATOR and applies it once; the factor product
        grows exponentially in intermediate terms while the state stays tiny,
        so here each factor is applied right-to-left directly to the state
        (associativity -- identical result, every intermediate is a state)."""
        transformation_list = []
        rotated = self.stabilizers.rotate_onto_single_qubit_paulis()
        # Hadamards on X-stabilised qubits
        transformation_list += [
            Had(self.stabilizers.n_qubits, i)
            for i in np.where(np.sum(rotated.X_block & ~rotated.Z_block, axis=0))[0]
        ]
        # (P^2 + P)/2 projectors onto the stabilizer subspace
        transformation_list += [
            ((rotated[i] ** 2) + rotated[i]) * 0.5 for i in range(rotated.n_terms)
        ]
        # Clifford rotations mapping the stabilizers onto single-qubit Paulis
        transformation_list += [
            trotter(s[0] * (np.pi / 4 * 1j)) for s in self.stabilizers.stabilizer_rotations
        ]
        transformed_state = reduce(
            lambda psi, T: T * psi, reversed(transformation_list), state
        )
        # drop stabilised qubit positions and merge duplicates
        return QuantumState(
            transformed_state.state_matrix[:, self.free_qubit_indices],
            transformed_state._amps,
        ).cleanup(zero_threshold=1e-12)
