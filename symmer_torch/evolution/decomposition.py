"""Circuit <-> PauliwordOp decomposition.

Parity surface of symmer ``evolution/decomposition.py``.  Canonical circuit
interchange here is (a) QASM 2 strings and (b) plain gate-instruction
dictionaries; qiskit is an *optional* export target (``to_qiskit=True``).
"""
from __future__ import annotations

from functools import reduce
from typing import Dict, List, Union

import numpy as np

from ..operators import PauliwordOp, QuantumState
from . import gate_library
from ._parse import safe_angle_eval
from .gate_library import CX, CZ, RX, RY, RZ, U1, Had, S, Sdag, X, Y, Z


def qasm_to_PauliwordOp(qasm: str, reverse=False, combine=True,
                        negate_angles=None):
    """Decompose a QASM2 circuit into a product of gate-library PauliwordOps.

    (reference decomposition.py:15-80)

    Angle convention: by default rotation angles are read in the gate-library
    convention (RZ(t) = e^{+i t Z/2}), matching the reference parser.
    Standard QASM/qiskit defines rz(t) = e^{-i t Z/2}, so parsing
    qiskit-generated QASM — or this module's own ``PauliwordOp_to_QASM``
    export, which emits standard QASM — needs the angles NEGATED.
    ``reverse=True`` does that AND bit-reverses the qubit order (the
    reference's qiskit-consistency mode); ``negate_angles=True`` applies
    only the angle negation (round-tripping our own export, which keeps
    symmer qubit order).  ``negate_angles=None`` follows ``reverse``.
    """
    gate_map = {
        "x": X, "y": Y, "z": Z, "h": Had, "rx": RX, "ry": RY,
        "rz": RZ, "u1": U1, "cz": CZ, "cx": CX, "s": S, "sdg": Sdag,
    }
    gateset = []
    num_qubits = 0
    for gate in qasm.split(";\n")[:-1]:
        gate = gate.strip()
        if not gate:
            continue
        name, *rest = gate.split(" ")
        qubits = rest[0] if rest else ""
        if name == "qreg":
            num_qubits = int(qubits[2:-1])
        if name in ["barrier", "include", "OPENQASM", "qreg", "creg"]:
            continue
        if name.find("(") != -1:
            name, angle = name.split("(")
            # qiskit-generated QASM routinely contains symbolic angle
            # expressions (pi/4, 3*pi/2, -pi, ...): restricted-arithmetic
            # parse only -- eval would execute untrusted circuit files
            angle = safe_angle_eval(angle[:-1])
        else:
            angle = None
        if qubits.find(",") != -1:
            control, target = qubits.split(",")
            control, target = int(control[2:-1]), int(target[2:-1])
        else:
            control, target = -1, int(qubits[2:-1])
        flip = 1
        if negate_angles or (negate_angles is None and reverse):
            flip = -1
        if reverse:
            control, target = num_qubits - 1 - control, num_qubits - 1 - target
        if name in ["x", "y", "z", "h", "s", "sdg"]:
            G = gate_map[name](num_qubits, target)
        elif name in ["cz", "cx"]:
            G = gate_map[name](num_qubits, control, target)
        elif name in ["rx", "ry", "rz", "u1"]:
            G = gate_map[name](num_qubits, target, angle=flip * angle)
        else:
            raise ValueError(f"Gate decomposition {name} not defined")
        gateset.append(G)

    if combine:
        return reduce(lambda x, y: x * y, gateset[::-1]).cleanup()
    return gateset


def PauliwordOp_to_instructions(PwordOp: PauliwordOp) -> Dict[int, Dict[str, List[int]]]:
    """Per-term H/S/CNOT-cascade/RZ instructions for trotterized evolution.

    (reference decomposition.py:86-108)
    """
    circuit_instructions = {}
    Xb, Zb = PwordOp.X_block, PwordOp.Z_block
    for step, (Xv, Zv) in enumerate(zip(Xb, Zb)):
        H_indices = np.where(Xv)[0][::-1]
        S_indices = np.where(Xv & Zv)[0][::-1]
        CNOT_indices = np.where(Xv | Zv)[0][::-1]
        circuit_instructions[step] = {
            "H_indices": H_indices,
            "S_indices": S_indices,
            "CNOT_indices": CNOT_indices,
            "RZ_index": CNOT_indices[-1],
        }
    return circuit_instructions


def PauliwordOp_to_QASM(
    PwordOp: PauliwordOp,
    ref_state: np.ndarray = None,
    trotter_number: int = 1,
    include_barriers: bool = False,
) -> str:
    """Trotterized exponential circuit of the (bound) operator as QASM2.

    Native replacement for the reference's qiskit-only circuit export; angles
    are taken from the operator coefficients (bind_params semantics).  The
    output uses STANDARD QASM angle conventions (rz(t) = e^{-i t Z/2}), so
    it loads correctly into qiskit; to parse it back with
    ``qasm_to_PauliwordOp``, pass ``negate_angles=True`` (see its docstring).
    """
    if isinstance(ref_state, QuantumState):
        assert ref_state.n_terms == 1
        ref_state = ref_state.state_matrix[0]
    n = PwordOp.n_qubits
    lines = ["OPENQASM 2.0", 'include "qelib1.inc"', f"qreg q[{n}]"]
    if ref_state is not None:
        for i in np.where(np.asarray(ref_state) == 1)[0]:
            lines.append(f"x q[{i}]")
    non_identity = PwordOp[np.where(np.any(PwordOp.symp_matrix, axis=1))[0]] \
        if np.any(PwordOp.symp_matrix) else None
    if non_identity is not None and non_identity.n_terms > 0:
        angles = non_identity.coeff_vec.real / trotter_number
        instructions = PauliwordOp_to_instructions(non_identity)
        for _ in range(trotter_number):
            for step, gates in instructions.items():
                if include_barriers:
                    lines.append("barrier")
                for i in gates["S_indices"]:
                    lines.append(f"sdg q[{i}]")
                for i in gates["H_indices"]:
                    lines.append(f"h q[{i}]")
                cascade = list(gates["CNOT_indices"])
                for src, tgt in zip(cascade[:-1], cascade[1:]):
                    lines.append(f"cx q[{src}],q[{tgt}]")
                lines.append(f"rz({-2 * angles[step]}) q[{gates['RZ_index']}]")
                for src, tgt in list(zip(cascade[:-1], cascade[1:]))[::-1]:
                    lines.append(f"cx q[{src}],q[{tgt}]")
                for i in gates["H_indices"]:
                    lines.append(f"h q[{i}]")
                for i in gates["S_indices"]:
                    lines.append(f"s q[{i}]")
    return ";\n".join(lines) + ";\n"


def PauliwordOp_to_QuantumCircuit(
    PwordOp: PauliwordOp,
    ref_state: np.ndarray = None,
    basis_change_indices: Dict[str, List[int]] = {"X_indices": [], "Y_indices": []},
    trotter_number: int = 1,
    bind_params: bool = True,
    include_barriers: bool = True,
    parameter_label: str = "P",
):
    """Trotterized qiskit circuit of the exponentiated operator.

    Requires qiskit (optional dependency); for a native interchange format use
    :func:`PauliwordOp_to_QASM` or :func:`PauliwordOp_to_instructions`.
    (reference decomposition.py:110-203)
    """
    from qiskit.circuit import ParameterVector, QuantumCircuit

    if isinstance(ref_state, QuantumState):
        assert ref_state.n_terms == 1
        ref_state = ref_state.state_matrix[0]

    def qiskit_ordering(indices):
        return PwordOp.n_qubits - 1 - indices

    qc = QuantumCircuit(PwordOp.n_qubits)
    if ref_state is not None:
        for i in qiskit_ordering(np.where(np.asarray(ref_state) == 1)[0]):
            qc.x(i)

    non_identity = PwordOp[np.where(np.any(PwordOp.symp_matrix, axis=1))[0]] \
        if np.any(PwordOp.symp_matrix) else PwordOp[[]]

    if non_identity.n_terms > 0:

        def CNOT_cascade(cascade_indices, reverse=False):
            index_pairs = list(zip(cascade_indices[:-1], cascade_indices[1:]))
            if reverse:
                index_pairs = index_pairs[::-1]
            for source, target in index_pairs:
                qc.cx(source, target)

        def circuit_from_step(angle, H_indices, S_indices, CNOT_indices, RZ_index):
            for i in S_indices:
                qc.sdg(i)
            for i in H_indices:
                qc.h(i)
            CNOT_cascade(CNOT_indices)
            qc.rz(-2 * angle, RZ_index)
            CNOT_cascade(CNOT_indices, reverse=True)
            for i in H_indices:
                qc.h(i)
            for i in S_indices:
                qc.s(i)

        if bind_params:
            angles = non_identity.coeff_vec.real / trotter_number
        else:
            angles = np.array(ParameterVector(parameter_label, non_identity.n_terms)) / trotter_number

        instructions = PauliwordOp_to_instructions(non_identity)
        assert len(angles) == len(instructions), (
            "Number of parameters does not match the circuit instructions"
        )
        for _ in range(trotter_number):
            for step, gate_indices in instructions.items():
                qiskit_gate_indices = [
                    qiskit_ordering(np.asarray(indices))
                    for indices in gate_indices.values()
                ]
                if include_barriers:
                    qc.barrier()
                circuit_from_step(angles[step], *qiskit_gate_indices)

    if include_barriers:
        qc.barrier()
    for i in basis_change_indices["Y_indices"]:
        qc.s(qiskit_ordering(i))
    for i in basis_change_indices["X_indices"]:
        qc.h(qiskit_ordering(i))
    return qc
