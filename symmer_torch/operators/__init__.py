"""Operator algebra layer (the ported part of symmer_tpu.operators)."""
import numpy as np

from .utils import *  # noqa: F401,F403
from .base import (  # noqa: F401
    PauliwordOp,
    QuantumState,
    change_of_basis_XY_to_Z,
    get_PauliwordOp_projector,
    get_ij_operator,
    single_term_expval,
)
from .device_op import DeviceOperator  # noqa: F401
from .independent_op import IndependentOp  # noqa: F401
from .anticommuting_op import AntiCommutingOp  # noqa: F401
from .noncontextual_op import NoncontextualOp, NoncontextualSolver  # noqa: F401


def from_numpy_planes(x_pack, z_pack, coeff_vec, n_qubits) -> PauliwordOp:
    """Build a PauliwordOp from packed numpy planes, e.g. those of a
    ``symmer_tpu`` operator (``op.x_pack, op.z_pack, op.coeff_vec,
    op.n_qubits``): both packages use the same layout, uint64[n_terms,
    ceil(n_qubits / 64)] with qubit q at bit q % 64 of word q // 64.  The
    planes are copied, so the result shares no memory with the caller."""
    x = np.array(x_pack, dtype=np.uint64, ndmin=2)
    z = np.array(z_pack, dtype=np.uint64, ndmin=2)
    c = np.array(coeff_vec, dtype=complex, ndmin=1)
    from ..kernels.pack import n_words_for

    if x.shape != z.shape or x.ndim != 2:
        raise ValueError(f"plane shapes differ: {x.shape} vs {z.shape}")
    if x.shape[1] != n_words_for(n_qubits):
        raise ValueError(
            f"{x.shape[1]} words per row, {n_qubits} qubits need "
            f"{n_words_for(n_qubits)}"
        )
    if c.shape != (x.shape[0],):
        raise ValueError(f"{c.shape[0]} coefficients for {x.shape[0]} terms")
    return PauliwordOp.from_planes(x, z, c, n_qubits)


def from_numpy_state(s_pack, amps, n_qubits, vec_type: str = "ket") -> QuantumState:
    """Build a QuantumState from packed numpy basis rows and amplitudes, e.g.
    those of a ``symmer_tpu`` state (``psi._s_pack, psi._amps,
    psi.n_qubits``): both packages pack a basis row as uint64[ceil(n_qubits
    / 64)] with qubit q at bit q % 64 of word q // 64.  The arrays are
    copied, so the result shares no memory with the caller."""
    s = np.array(s_pack, dtype=np.uint64, ndmin=2)
    a = np.array(amps, dtype=complex, ndmin=1)
    from ..kernels.pack import n_words_for

    if s.shape[1] != n_words_for(n_qubits):
        raise ValueError(
            f"{s.shape[1]} words per row, {n_qubits} qubits need "
            f"{n_words_for(n_qubits)}"
        )
    if a.shape != (s.shape[0],):
        raise ValueError(f"{a.shape[0]} amplitudes for {s.shape[0]} basis rows")
    return QuantumState.from_planes(s, a, n_qubits, vec_type)
