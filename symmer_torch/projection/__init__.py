"""Projection layer: Z2-symmetry qubit tapering."""
from .base import S3Projection  # noqa: F401
from .qubit_tapering import QubitTapering  # noqa: F401
