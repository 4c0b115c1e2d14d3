"""Global configuration for symmer-torch.

Backends
--------
``host``    packed-uint64 numpy / native C++ kernels (fast for tiny operators:
            kernel launch and transfer latency dominate below ~10^4 term-words).
``device``  torch kernels on ``config.device``: hand-written CUDA kernels
            plus plain torch ops on a CUDA device, the plain torch versions of
            the same kernels on the CPU device.
``auto``    pick per call by problem size (term count x word count).

Coefficients are float64 on every path (Hopper has native FP64), so the
device path matches the host path to ~1e-15 relative without emulation.

``device`` is a ``torch.device`` (default ``"cuda"``).  A device path never
falls back to the CPU: when ``device`` is CUDA and no CUDA device is present,
:meth:`SymmerTorchConfig.torch_device` raises.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch


@dataclass
class SymmerTorchConfig:
    # 'auto' | 'host' | 'device'
    backend: str = "auto"
    # torch device of the device path
    device: torch.device = field(default_factory=lambda: torch.device("cuda"))
    # number of term-words above which 'auto' dispatches to the device path
    device_threshold: int = 1 << 16
    # number of significant figures when printing operators/states
    sigfig: int = 3
    # zero threshold used by cleanup when not explicitly specified
    zero_threshold: float = 1e-15
    # |angle*2/pi - round(...)| below this counts as a Clifford rotation
    # (batched into the term-count-preserving scan / fused projection).
    # 1e-10 absorbs accumulated f64 rounding of exact multiples while still
    # treating genuinely different angles (e.g. float32(pi/2), 4e-8 off) as
    # non-Clifford; raise it if your angles come from f32 sources.
    clifford_angle_tol: float = 1e-10

    def __setattr__(self, name, value):
        if name == "device":
            value = torch.device(value)
        super().__setattr__(name, value)

    def use_device_io(self, work_items: int) -> bool:
        """Dispatch rule of the host-in/host-out kernel calls: a plain size
        threshold on the work (term-words), ``backend`` overriding it."""
        if self.backend == "device":
            return True
        if self.backend == "host":
            return False
        return work_items >= self.device_threshold

    def torch_device(self) -> torch.device:
        """The device of the device path; raises when it is CUDA and no CUDA
        device is present (no silent CPU fallback)."""
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "symmer_torch: config.device is CUDA but torch.cuda.is_available() "
                "is False; set config.device = 'cpu' to run the device path on "
                "the CPU, or config.backend = 'host'"
            )
        return self.device


config = SymmerTorchConfig()
