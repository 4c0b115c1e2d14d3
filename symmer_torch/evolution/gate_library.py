"""Gate library: common gates expressed as PauliwordOps.

(parity surface of symmer ``evolution/gate_library.py``)
"""
from __future__ import annotations

import numpy as np

from ..operators import PauliwordOp
from .exponentiation import trotter


def I(n_qubits: int) -> PauliwordOp:
    return PauliwordOp.from_dictionary({"I" * n_qubits: 1})


def _single(letter: str, n_qubits: int, index: int) -> PauliwordOp:
    s = ["I"] * n_qubits
    s[index] = letter
    return PauliwordOp.from_dictionary({"".join(s): 1})


def X(n_qubits: int, index: int) -> PauliwordOp:
    return _single("X", n_qubits, index)


def Y(n_qubits: int, index: int) -> PauliwordOp:
    return _single("Y", n_qubits, index)


def Z(n_qubits: int, index: int) -> PauliwordOp:
    return _single("Z", n_qubits, index)


def Had(n_qubits: int, index: int) -> PauliwordOp:
    return Z(n_qubits, index).multiply_by_constant(1 / np.sqrt(2)) + X(
        n_qubits, index
    ).multiply_by_constant(1 / np.sqrt(2))


def CZ(n_qubits: int, control: int, target: int) -> PauliwordOp:
    ZI = Z(n_qubits, control)
    IZ = Z(n_qubits, target)
    ZZ = ZI * IZ
    CZ_exp = (ZZ - IZ - ZI).multiply_by_constant(np.pi / 4)
    return trotter(CZ_exp.multiply_by_constant(1j), trotnum=1).multiply_by_constant(
        np.sqrt(1j)
    )


def CX(n_qubits: int, control: int, target: int) -> PauliwordOp:
    _Had = Had(n_qubits, target)
    return _Had * CZ(n_qubits, control, target) * _Had


def CY(n_qubits: int, control: int, target: int) -> PauliwordOp:
    _Had = Had(n_qubits, target)
    _S = S(n_qubits, target)
    return _S * _Had * CZ(n_qubits, control, target) * _Had * _S.dagger


def RX(n_qubits: int, index: int, angle: float) -> PauliwordOp:
    return trotter(X(n_qubits, index).multiply_by_constant(1j * angle / 2))


def RY(n_qubits: int, index: int, angle: float) -> PauliwordOp:
    return trotter(Y(n_qubits, index).multiply_by_constant(1j * angle / 2))


def RZ(n_qubits: int, index: int, angle: float) -> PauliwordOp:
    return trotter(Z(n_qubits, index).multiply_by_constant(1j * angle / 2))


def U1(n_qubits: int, index: int, angle: float) -> PauliwordOp:
    return RZ(n_qubits, index, angle).multiply_by_constant(np.exp(1j * angle / 2))


def S(n_qubits: int, index: int) -> PauliwordOp:
    return RZ(n_qubits, index, -np.pi / 2).multiply_by_constant(np.sqrt(1j))


def Sdag(n_qubits: int, index: int) -> PauliwordOp:
    """diag(1, -i) — the inverse of S (the QASM 'sdg' gate, which the
    trotterized Y-basis-change export emits)."""
    return RZ(n_qubits, index, np.pi / 2).multiply_by_constant(np.sqrt(-1j))
