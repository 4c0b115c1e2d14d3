"""Device-resident Pauli-operator pipelines.

Every ``PauliwordOp`` operation dispatched to the device pays a full
host->device->host round trip -- the right trade for an isolated call, but a
pipeline of N large operations moves the operator across PCIe 2N times.

``DeviceOperator`` keeps the packed planes in device memory between
operations: one upload at ``PauliwordOp.to_device()``, one download at
``.to_host()``, and in between each step costs kernel time plus the
data-dependent survivor counts of its cleanup.

    H_dev = H.to_device()
    out = ((H_dev * H_dev).cleanup()
           .perform_rotations(rotations)
           .to_host())
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import config
from ..kernels import dispatch, pack, torch_core


def _masks_compatible(a, b) -> bool:
    """True when two pending-projection masks agree (both absent, or
    identical free-column sets) -- the condition under which binary
    device-resident operations have a single consistent qubit indexing."""
    if a is None and b is None:
        return True
    if a is None or b is None:
        return False
    return a.shape == b.shape and bool(np.all(a == b))


class DeviceOperator:
    """A Pauli sum resident on ``config.device``.

    Internal state: int64 planes ``x, z`` (``[n_terms, W]``, the bit pattern
    of the host uint64 words), float64 coefficient planes ``cr, ci``, and the
    qubit count.  The planes hold exactly the terms (no padding; a fully
    cancelled operator has zero rows).  Instances are immutable; every
    operation returns a new ``DeviceOperator``.
    """

    __slots__ = ("x", "z", "cr", "ci", "n_qubits", "_free_mask")

    def __init__(self, x, z, cr, ci, n_qubits: int, free_mask=None):
        self.x = x
        self.z = z
        self.cr = cr
        self.ci = ci
        self.n_qubits = int(n_qubits)
        # set by clifford_rotate_project: bool[n_qubits] of FREE columns.
        # The projected planes stay at full word width with the stabilized
        # columns zeroed (= tapered operator tensor identity, so resident
        # follow-ups are exact); to_host() deletes the columns on download.
        self._free_mask = free_mask

    # -- host boundary ------------------------------------------------------

    @classmethod
    def from_host(cls, op) -> "DeviceOperator":
        """Upload a PauliwordOp (one transfer)."""
        return cls(
            dispatch._to_dev(op.x_pack), dispatch._to_dev(op.z_pack),
            *dispatch._coeff_to_dev(op.coeff_vec), op.n_qubits,
        )

    def to_host(self):
        """Download as a PauliwordOp.

        A pending projection column selection (``_free_mask``) is applied on
        the downloaded planes: the result is the REDUCED-qubit operator."""
        from .base import PauliwordOp

        x, z, c = dispatch._planes_from_dev(self.x, self.z, self.cr, self.ci)
        n_qubits = self.n_qubits
        W = pack.n_words_for(n_qubits)
        if self._free_mask is not None:
            n_free = int(self._free_mask.sum())
            if x.shape[0]:
                x = pack.select_columns(x[:, :W], self._free_mask)
                z = pack.select_columns(z[:, :W], self._free_mask)
            n_qubits, W = n_free, pack.n_words_for(n_free)
        if x.shape[0] == 0:
            return PauliwordOp.empty(n_qubits).cleanup()
        return PauliwordOp.from_planes(x[:, :W], z[:, :W], c, n_qubits)

    @property
    def n_terms(self) -> int:
        return self.x.shape[0]

    def copy(self) -> "DeviceOperator":
        """Instances are immutable, so copy is the identity -- present so
        generic operator-handling code (e.g. QubitTapering.taper_it's
        defensive copy) accepts resident operands."""
        return self

    def __repr__(self) -> str:
        return (
            f"DeviceOperator(n_qubits={self.n_qubits}, n_terms={self.n_terms}, "
            f"device={self.x.device})"
        )

    def _with(self, planes, free_mask=None) -> "DeviceOperator":
        return DeviceOperator(*planes, self.n_qubits, free_mask=free_mask)

    # -- device-resident operations ----------------------------------------

    def cleanup(self, zero_threshold: Optional[float] = None) -> "DeviceOperator":
        """Deduplicate terms on device."""
        if zero_threshold is None:
            zero_threshold = config.zero_threshold
        return self._with(
            torch_core.cleanup_sorted(self.x, self.z, self.cr, self.ci, zero_threshold),
            self._free_mask,
        )

    def multiply(self, other: "DeviceOperator",
                 zero_threshold: float = 1e-15) -> "DeviceOperator":
        """All-pairs product + cleanup on device."""
        assert self.n_qubits == other.n_qubits, "qubit-count mismatch"
        if not _masks_compatible(self._free_mask, other._free_mask):
            raise ValueError(
                "device-resident multiply of operands with different pending "
                "projections (free-qubit masks differ): one operand indexes "
                "reduced qubits, the other full width.  Download with "
                ".to_host() (applies the column reduction) and re-upload, or "
                "project both operands with the same stabilizer set."
            )
        assert zero_threshold is not None and zero_threshold > 0, (
            "device-resident multiply requires a positive threshold"
        )
        return self._with(
            torch_core.mul_pairs_cleanup(
                self.x, self.z, self.cr, self.ci,
                other.x, other.z, other.cr, other.ci, zero_threshold,
            ),
            self._free_mask,
        )

    def __mul__(self, other: "DeviceOperator") -> "DeviceOperator":
        return self.multiply(other)

    def perform_rotations(
        self, rotations: Sequence[Tuple[object, Optional[float]]],
        zero_threshold: Optional[float] = 1e-15,
    ) -> "DeviceOperator":
        """Apply a (PauliwordOp, angle) rotation sequence, staying on device
        (dispatch.device_rotation_loop): each Clifford run is one
        ``clifford_scan`` launch."""
        rot_planes = []
        for r, angle in rotations:
            assert r.n_terms == 1, "Only rotation by single Pauliword allowed here"
            assert r.n_qubits == self.n_qubits, "qubit-count mismatch"
            rot_planes.append((r.x_pack[0], r.z_pack[0], angle))
        # A pending projection (zeroed stabilized columns, _free_mask set)
        # survives rotations only when no generator has support on a
        # stabilized column -- rotations are indexed on the FULL qubit range,
        # so a generator touching a zeroed column would silently mix
        # reduced/unreduced semantics.  Check before any device work.
        if self._free_mask is not None:
            keep = pack.pack_bits(
                self._free_mask.reshape(1, -1), self.n_qubits
            )[0]
            for rx_row, rz_row, _ in rot_planes:
                if np.any(rx_row & ~keep) or np.any(rz_row & ~keep):
                    raise ValueError(
                        "rotation generator touches a stabilized (projected-"
                        "out) qubit of this device-resident operator; "
                        "download with .to_host() first"
                    )
        return self._with(
            dispatch.device_rotation_loop(
                self.x, self.z, self.cr, self.ci, rot_planes, zero_threshold
            ),
            self._free_mask,
        )

    def clifford_rotate_project(
        self, rotations, rotated_stabilizers, free_qubit_mask,
        zero_threshold: float = 1e-15,
    ) -> "DeviceOperator":
        """Fused stabilizer-subspace projection, fully device-resident.

        The flagship taper projection (Clifford rotation scan + commuting-term
        filter + eigenvalue sign flips + stabilized-column masking + cleanup)
        on the resident planes, with no operator transfer.  The
        host-in/host-out analog is dispatch.clifford_rotate_project; the
        S3Projection layer routes here when the operator is already resident.

        Args:
            rotations: (PauliwordOp, angle) Clifford rotation sequence.
            rotated_stabilizers: IndependentOp of single-qubit stabilizers
                (signs in coeff_vec give the eigenvalue assignments).
            free_qubit_mask: bool[n_qubits], True at columns to KEEP; the
                planes stay full-width with stabilized columns zeroed (the
                tapered operator tensor identity), to_host() deletes them.
        """
        if self._free_mask is not None:
            raise ValueError(
                "operator already carries a pending projection; chain "
                "projections through .to_host() so the second stabilizer "
                "set indexes the reduced qubits"
            )
        rot = rotated_stabilizers
        rot_planes = [
            (r.x_pack[0], r.z_pack[0], angle) for r, angle in rotations
        ]
        free_qubit_mask = np.asarray(free_qubit_mask, bool)
        rx, rz, ms, neg_x, neg_z, col_keep = dispatch.projection_prep(
            rot_planes, rot.x_pack, rot.z_pack, rot.coeff_vec,
            free_qubit_mask, pack.n_words_for(self.n_qubits),
        )
        planes = torch_core.clifford_project_cleanup(
            self.x, self.z, self.cr, self.ci,
            dispatch._to_dev(rx), dispatch._to_dev(rz),
            torch.tensor(ms, device=config.torch_device()),
            dispatch._to_dev(rot.x_pack), dispatch._to_dev(rot.z_pack),
            dispatch._row_to_dev(neg_x), dispatch._row_to_dev(neg_z),
            dispatch._row_to_dev(col_keep), zero_threshold,
        )
        return self._with(planes, free_qubit_mask)

    def expval(self, psi) -> complex:
        """<psi|O|psi> against a (host) QuantumState: the operator planes
        stay resident; only the state uploads and one complex scalar returns
        (complex, as PauliwordOp.expval: a non-Hermitian operator carries a
        meaningful imaginary part).  The state is deduplicated on the device,
        then the ``expval`` kernel runs."""
        if psi.n_qubits != self.n_qubits:
            raise ValueError(
                f"state has {psi.n_qubits} qubits but the resident operator "
                f"indexes {self.n_qubits}"
                + (
                    " (a pending projection keeps the planes at FULL width; "
                    "expval needs a full-width state, or .to_host() for the "
                    "reduced-qubit operator)"
                    if self._free_mask is not None else ""
                )
            )
        return dispatch.device_expval(
            self.x, self.z, self.cr, self.ci,
            dispatch._to_dev(psi._s_pack), *dispatch._coeff_to_dev(psi._amps),
        )

    def expval_iz(self) -> complex:
        """<0...0| O |0...0>: sum of I/Z-only coefficients (one scalar fetch
        -- the Clifford-simulator reduction, no operator download)."""
        re, im = torch_core.expval_iz_sum(self.x, self.cr, self.ci)
        return complex(float(re), float(im))
