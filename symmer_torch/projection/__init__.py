"""Projection layer: Z2-symmetry tapering and the contextual subspace."""
from .utils import *  # noqa: F401,F403
from .base import S3Projection  # noqa: F401
from .qubit_tapering import QubitTapering  # noqa: F401
from .contextual_subspace import ContextualSubspace  # noqa: F401
