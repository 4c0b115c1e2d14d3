"""Pauli exponentials (parity surface of symmer ``evolution/exponentiation.py``)."""
from __future__ import annotations

from functools import reduce

import numpy as np

from ..operators import PauliwordOp


def exponentiate_single_Pop(P: PauliwordOp) -> PauliwordOp:
    """e^P = cosh(c) I + sinh(c) P for a single Pauli term with coefficient c.

    (reference exponentiation.py:6-24; to implement e^{i theta P} the
    coefficient of P must be i*theta)
    """
    assert P.n_terms == 1, "Can only exponentiate single Pauli terms"
    c = P.coeff_vec[0]
    identity = PauliwordOp.from_planes(
        np.zeros_like(P.x_pack), np.zeros_like(P.z_pack),
        [np.cosh(c)], P.n_qubits,
    )
    return identity + PauliwordOp.from_planes(
        P.x_pack, P.z_pack, [np.sinh(c)], P.n_qubits
    )


def trotter(op: PauliwordOp, trotnum: int = 1) -> PauliwordOp:
    """Product of single-term exponentials; exact for commuting operators.

    (reference exponentiation.py:26-38)
    """
    op_copy = op.multiply_by_constant(1 / trotnum)
    factors = [exponentiate_single_Pop(op_copy[i]) for i in range(op_copy.n_terms)] * trotnum
    return reduce(lambda x, y: x * y, factors)


def truncated_exponential(op: PauliwordOp, truncate_at: int = 10) -> PauliwordOp:
    """Taylor expansion of e^op truncated at the given order.

    The reference raises NotImplementedError (exponentiation.py:40); provided
    here since the packed multiply makes it cheap.
    """
    identity = PauliwordOp.from_list(["I" * op.n_qubits], [1])
    out = identity
    power = identity
    fact = 1.0
    for k in range(1, truncate_at + 1):
        power = (power * op).cleanup()
        fact *= k
        out = out + power.multiply_by_constant(1 / fact)
    return out.cleanup()
