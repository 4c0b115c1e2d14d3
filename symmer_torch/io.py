"""Checkpoint / serialisation helpers.

The reference's only serialisation is the (real, imag)-tuple dictionaries
(symmer ``operators/utils.py:401-427``) written ad hoc by the CLI and
ADAPT-VQE.  Here the same JSON-safe format gets first-class save/load
round trips for operators and states.
"""
from __future__ import annotations

import json
from typing import Union

from .operators import PauliwordOp, QuantumState
from .operators.utils import safe_PauliwordOp_to_dict, safe_QuantumState_to_dict


def save_operator(op: PauliwordOp, path: str) -> None:
    with open(path, "w") as f:
        json.dump(
            {"type": "PauliwordOp", "n_qubits": op.n_qubits,
             "terms": safe_PauliwordOp_to_dict(op)},
            f,
        )


def load_operator(path: str) -> PauliwordOp:
    with open(path) as f:
        data = json.load(f)
    assert data.get("type") == "PauliwordOp", "not a PauliwordOp checkpoint"
    return PauliwordOp.from_dictionary(
        {k: complex(v[0], v[1]) for k, v in data["terms"].items()}
    )


def save_state(psi: QuantumState, path: str) -> None:
    with open(path, "w") as f:
        json.dump(
            {"type": "QuantumState", "n_qubits": psi.n_qubits,
             "vec_type": psi.vec_type, "amplitudes": safe_QuantumState_to_dict(psi)},
            f,
        )


def load_state(path: str) -> QuantumState:
    with open(path) as f:
        data = json.load(f)
    assert data.get("type") == "QuantumState", "not a QuantumState checkpoint"
    psi = QuantumState.from_dictionary(
        {k: complex(v[0], v[1]) for k, v in data["amplitudes"].items()}
    )
    psi.vec_type = data.get("vec_type", "ket")
    return psi
