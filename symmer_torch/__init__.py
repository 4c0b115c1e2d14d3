"""symmer-torch: the PyTorch/CUDA port of symmer-tpu.

Symplectic Pauli-operator algebra and Z2-symmetry qubit tapering on PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper.  This first slice ports the
tapering main path: ``QubitTapering(H).taper_it(..., aux_operator=H.to_device())``.
"""
__version__ = "0.1.0"

from .config import config  # noqa: F401
from .operators import DeviceOperator, PauliwordOp, QuantumState  # noqa: F401
from .projection import QubitTapering  # noqa: F401
