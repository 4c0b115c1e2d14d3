"""Evolution/circuits layer (parity surface of symmer.evolution)."""
from .exponentiation import trotter, exponentiate_single_Pop, truncated_exponential  # noqa: F401
from .gate_library import *  # noqa: F401,F403
from .utils import get_CNOT_connectivity_graph, topology_match_score  # noqa: F401
from .decomposition import (  # noqa: F401
    qasm_to_PauliwordOp,
    PauliwordOp_to_QASM,
    PauliwordOp_to_instructions,
    PauliwordOp_to_QuantumCircuit,
)
from .circuit_symmerlator import CircuitSymmerlator  # noqa: F401
from .variational_optimization import VQE_Driver, ADAPT_VQE  # noqa: F401
