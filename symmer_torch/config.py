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

import contextlib
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
    # assignments per chunk of the host brute-force noncontextual search
    # (bounds its (chunk, n_terms) intermediates)
    brute_force_host_chunk: int = 1 << 20
    # largest qubit count for which QubitSubspaceManager's auto-reference
    # uses the exact Lanczos on the card (utils.exact_gs_energy_device)
    # instead of DMRG; beyond it, and on the CPU device, DMRG
    lanczos_ref_max_qubits: int = 18
    # optional parallel.mesh.Mesh (set via symmer_torch.use_mesh): large
    # operator kernels shard the term axis over it and the noncontextual
    # brute-force search shards the assignment axis; None = one device
    mesh: object = None
    # minimum term count before a mesh-sharded kernel is preferred over the
    # single-device path
    mesh_threshold: int = 1 << 15

    def __setattr__(self, name, value):
        if name == "device":
            value = torch.device(value)
        super().__setattr__(name, value)

    def use_device_io(self, work_items: int) -> bool:
        """Dispatch rule of the host-in/host-out kernel calls: a plain size
        threshold on the work (term-words), ``backend`` overriding it.
        Under 'device' it raises, as :meth:`torch_device` does, when the
        device is absent, whatever the size: a call that the caller then
        keeps on the host for its size does not hide a missing card."""
        if self.backend == "device":
            self.torch_device()
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


@contextlib.contextmanager
def use_mesh(mesh=None, n_devices: int = None, axis_name: str = "terms"):
    """Route large operator kernels through a device mesh within the block.

    ``with symmer_torch.use_mesh():`` shards over every local device of
    ``config.device``'s type (parallel.mesh.get_mesh); pass an explicit
    ``parallel.mesh.Mesh`` (e.g. ``Mesh(["cuda:0"] * 4)``) or ``n_devices``
    to choose.  The previous mesh comes back on exit."""
    if mesh is None:
        from .parallel.mesh import get_mesh

        mesh = get_mesh(n_devices, axis_name)
    prev = config.mesh
    config.mesh = mesh
    try:
        yield mesh
    finally:
        config.mesh = prev
