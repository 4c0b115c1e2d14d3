"""Approximate layer (parity surface of symmer.approximate)."""
from .tensor_network import (  # noqa: F401
    MPOOp,
    get_MPO,
    find_groundstate_dmrg,
    find_groundstate_quimb,
    coefflist_to_complex,
)
