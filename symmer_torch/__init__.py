"""symmer-torch: the PyTorch/CUDA port of symmer-tpu.

Symplectic Pauli-operator algebra and qubit-subspace reduction on PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper.  Ported so far: Z2
tapering (``QubitTapering(H).taper_it(..., aux_operator=H.to_device())``),
the state layer (``PauliwordOp.expval``, ``DeviceOperator.expval``, operator
action on states), the noncontextual machinery (``NoncontextualOp``,
``AntiCommutingOp``), contextual-subspace projection
(``ContextualSubspace``), ``QubitSubspaceManager`` and the Lanczos
eigensolvers (``utils.exact_gs_energy_device``,
``utils.exact_lowest_states_device``).
"""
__version__ = "0.1.0"

from .config import config  # noqa: F401
from .operators import DeviceOperator, PauliwordOp, QuantumState  # noqa: F401
from .projection import ContextualSubspace, QubitSubspaceManager, QubitTapering  # noqa: F401
