"""Evolution layer: the parts the projection needs (Pauli exponentials and
the gate library)."""
from .exponentiation import trotter, exponentiate_single_Pop, truncated_exponential  # noqa: F401
from .gate_library import *  # noqa: F401,F403
