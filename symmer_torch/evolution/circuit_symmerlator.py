"""Heisenberg-picture Clifford(+non-Clifford) circuit simulator.

Parity surface of symmer ``evolution/circuit_symmerlator.py``: each gate
appends (rotation Pauli, angle) to a sequence; evaluation rotates the
observable backwards through the sequence and sums its diagonal (I/Z-only)
coefficients.

The counterpart of ``symmer_tpu/evolution/circuit_symmerlator.py``.  Evaluation
goes through ``PauliwordOp.perform_rotations``: on the device path each run of
Clifford rotations is one launch of the Clifford scan kernel
(``csrc/clifford_scan.cu``) over the packed planes -- the reference loops
gate-by-gate in Python (circuit_symmerlator.py:152-166).
"""
from __future__ import annotations

import re
from typing import List

import numpy as np

from ..operators import PauliwordOp
from ._parse import safe_angle_eval


class CircuitSymmerlator:
    """(reference circuit_symmerlator.py:8-203)"""

    def __init__(self, n_qubits: int) -> None:
        self.n_qubits = n_qubits
        self.sequence = []
        self.gate_map = {
            "x": self.X, "y": self.Y, "z": self.Z,
            "rx": self.RX, "ry": self.RY, "rz": self.RZ,
            "sx": self.sqrtX, "sy": self.sqrtY, "sz": self.sqrtZ,
            "cx": self.CX, "cy": self.CY, "cz": self.CZ,
            "h": self.H, "s": self.S, "sdg": self.Sdag,
            "": self.R, "t": self.T, "tdg": self.Tdag,
            "ccx": self.Toffoli, "swap": self.SWAP,
        }

    def get_rotation_string(self, pauli: str, indices: List[int]) -> PauliwordOp:
        pauli = list(pauli)
        assert len(pauli) == len(indices), "Number of Paulis and indices do not match"
        assert set(pauli).issubset({"I", "X", "Y", "Z"}), (
            "Pauli operators are either I, X, Y or Z."
        )
        R = ["I"] * self.n_qubits
        for i, P in zip(indices, pauli):
            R[i] = P
        return PauliwordOp.from_list(["".join(R)])

    def pi_2_multiple(self, multiple: int) -> float:
        return np.pi / 2 * multiple

    # ------------------------- Clifford gates -----------------------------

    def X(self, index):
        self.sequence.append((self.get_rotation_string("X", [index]), self.pi_2_multiple(2)))

    def Y(self, index):
        self.sequence.append((self.get_rotation_string("Y", [index]), self.pi_2_multiple(2)))

    def Z(self, index):
        self.sequence.append((self.get_rotation_string("Z", [index]), self.pi_2_multiple(2)))

    def H(self, index):
        self.sequence.append((self.get_rotation_string("Z", [index]), self.pi_2_multiple(2)))
        self.sequence.append((self.get_rotation_string("Y", [index]), self.pi_2_multiple(1)))

    def S(self, index):
        self.sequence.append((self.get_rotation_string("Z", [index]), self.pi_2_multiple(1)))

    def Sdag(self, index):
        self.sequence.append((self.get_rotation_string("Z", [index]), self.pi_2_multiple(3)))

    def sqrtX(self, index):
        self.sequence.append((self.get_rotation_string("X", [index]), self.pi_2_multiple(1)))

    def sqrtY(self, index):
        self.sequence.append((self.get_rotation_string("Y", [index]), self.pi_2_multiple(1)))

    def sqrtZ(self, index):
        self.sequence.append((self.get_rotation_string("Z", [index]), self.pi_2_multiple(1)))

    def CX(self, control, target):
        self.sequence.append((self.get_rotation_string("ZX", [control, target]), self.pi_2_multiple(1)))
        self.sequence.append((self.get_rotation_string("ZI", [control, target]), self.pi_2_multiple(3)))
        self.sequence.append((self.get_rotation_string("IX", [control, target]), self.pi_2_multiple(3)))

    def CY(self, control, target):
        self.sequence.append((self.get_rotation_string("ZY", [control, target]), self.pi_2_multiple(1)))
        self.sequence.append((self.get_rotation_string("ZI", [control, target]), self.pi_2_multiple(3)))
        self.sequence.append((self.get_rotation_string("IY", [control, target]), self.pi_2_multiple(3)))

    def CZ(self, control, target):
        self.sequence.append((self.get_rotation_string("ZZ", [control, target]), self.pi_2_multiple(1)))
        self.sequence.append((self.get_rotation_string("ZI", [control, target]), self.pi_2_multiple(3)))
        self.sequence.append((self.get_rotation_string("IZ", [control, target]), self.pi_2_multiple(3)))

    def SWAP(self, qubit_1, qubit_2):
        self.CX(qubit_1, qubit_2)
        self.CX(qubit_2, qubit_1)
        self.CX(qubit_1, qubit_2)

    # ----------------------- non-Clifford gates ---------------------------

    def R(self, pauli: str, indices: List[int], angle: float):
        self.sequence.append((self.get_rotation_string(pauli, indices), -angle))

    def RX(self, index, angle):
        self.R("X", [index], angle)

    def RY(self, index, angle):
        self.R("Y", [index], angle)

    def RZ(self, index, angle):
        self.R("Z", [index], angle)

    def T(self, index):
        """T gate (= e^{-i pi/8 Z} up to global phase) as a non-Clifford
        rotation.  The reference raises NotImplementedError here
        (circuit_symmerlator.py:140-146)."""
        self.RZ(index, -np.pi / 4)

    def Tdag(self, index):
        self.RZ(index, np.pi / 4)

    def Toffoli(self, control_1, control_2, target):
        """Doubly-controlled X via the standard H/T/CX decomposition.

        The reference raises NotImplementedError (circuit_symmerlator.py:143-146).
        """
        c1, c2, t = control_1, control_2, target
        self.H(t)
        self.CX(c2, t)
        self.Tdag(t)
        self.CX(c1, t)
        self.T(t)
        self.CX(c2, t)
        self.Tdag(t)
        self.CX(c1, t)
        self.T(c2)
        self.T(t)
        self.CX(c1, c2)
        self.H(t)
        self.T(c1)
        self.Tdag(c2)
        self.CX(c1, c2)

    # --------------------------- execution --------------------------------

    def apply_sequence(self, operator: PauliwordOp) -> PauliwordOp:
        assert operator.n_qubits == self.n_qubits, (
            "The operator is defined over a different number of qubits"
        )
        return operator.perform_rotations(self.sequence[::-1])

    def evaluate(self, operator: PauliwordOp) -> complex:
        """<0...0| U^dag O U |0...0> = sum of I/Z-only coefficients of the
        back-rotated operator."""
        rotated_op = self.apply_sequence(operator)
        is_diag = ~np.any(rotated_op.x_pack, axis=1)
        return complex(np.sum(rotated_op.coeff_vec[is_diag]))

    @classmethod
    def from_qasm(cls, qasm: str, angle_factor: int = 1) -> "CircuitSymmerlator":
        """Initialise from a QASM (2 or 3) circuit string (reference :168-197)."""
        instructions = [s for s in qasm.split(";\n") if s.strip()]
        instructions.pop(0)  # version line
        inclusions = instructions.pop(0)
        registers = instructions.pop(0)
        n_qubits = int(re.findall(r"\d+", registers)[0])
        self = cls(n_qubits)
        for step in instructions:
            gate_qubits = step.strip().split(" ")
            gate = gate_qubits[0]
            qubits = "".join(gate_qubits[1:])
            qubits = [int(re.findall(r"\d+", q)[0]) for q in qubits.split(",")]
            extract_angle = gate.split("(")
            if len(extract_angle) == 1:
                gate = extract_angle[0]
                angle = None
            else:
                gate, angle = extract_angle
                # restricted arithmetic only: QASM from untrusted sources
                # must not reach eval (see evolution/_parse.py)
                angle = safe_angle_eval(angle[:-1])
            if angle is not None:
                self.gate_map[gate](*qubits, angle=angle_factor * angle)
            else:
                self.gate_map[gate](*qubits)
        return self

    @classmethod
    def from_qiskit(cls, circuit) -> "CircuitSymmerlator":
        from qiskit import qasm3

        return cls.from_qasm(qasm3.dumps(circuit.reverse_bits()), angle_factor=-1)
