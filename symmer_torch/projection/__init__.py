"""Projection layer: Z2-symmetry tapering, the contextual subspace and the
subspace manager that chains them."""
from .utils import *  # noqa: F401,F403
from .base import S3Projection  # noqa: F401
from .qubit_tapering import QubitTapering  # noqa: F401
from .contextual_subspace import ContextualSubspace  # noqa: F401
from .qubit_subspace_manager import QubitSubspaceManager  # noqa: F401
