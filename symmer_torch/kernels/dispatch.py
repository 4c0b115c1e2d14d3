"""Host/device dispatch for the symplectic kernels.

The torch counterpart of ``symmer_tpu/kernels/dispatch.py``, with the same
host-in/host-out signatures: the functions here take host uint64 planes and
complex coefficients and return the same.  By problem size (see
:data:`symmer_torch.config.config`) each call runs either on the host
(packed numpy / native C++, :mod:`np_core`) or on ``config.device`` through
:mod:`torch_core` and the hand-written CUDA kernels (:mod:`cuda`).

Boundary conventions:
  - planes: host uint64 -> device int64, a bit-identical view;
  - coefficients: host complex -> split (re, im) float64 planes on device.

Every entry runs on the device above its size rule
(:meth:`SymmerTorchConfig.use_device_io`, or always under
``backend="device"``), except that ``anticommutes``, ``apply_state`` and
``apply_bra`` stay on the host below ``DEVICE_FLOOR`` term-words even under
``backend="device"``: flows call them thousands of times on tiny inputs.
``is_noncontextual`` needs a minimum row count and returns None below it,
so the caller runs the host adjacency path.

Under ``symmer_torch.use_mesh`` and above ``config.mesh_threshold`` terms,
``cleanup``, ``multiply_cleanup``, ``perform_rotations``,
``clifford_rotate_project`` and ``expval`` split the term axis over the mesh
(parallel/sharded.py) before the host/device decision, as symmer_tpu's
dispatch does; a mesh that cannot run the exchange, or a buffer overflow,
leaves the call to the single-device path.
States are deduplicated on the device before ``expval`` and
``inner_product``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import config
from ..parallel import sharded
from ..parallel.mesh import check_devices
from ..profiling import kernel_stats
from . import cuda, np_core, state_core, torch_core, torch_state
from .rotations import (  # noqa: F401
    is_clifford_angle, projection_prep, segment_rotation_indices, segment_rotations,
    stabilizer_masks,
)

Planes = Tuple[np.ndarray, np.ndarray, np.ndarray]

# the anticommutation test of one candidate term (the noncontextual sweep)
# and the state actions on a 1-16-row state (the taper's state projection)
# come thousands of times per flow; below this many term-words their device
# version, a chain of small kernels plus an upload and a download, takes
# milliseconds where the host takes microseconds
DEVICE_FLOOR = 1 << 12


def _to_dev(x64: np.ndarray) -> torch.Tensor:
    """Host uint64 planes -> int64 planes on ``config.device`` (a copy)."""
    a = np.ascontiguousarray(x64, dtype=np.uint64).view(np.int64)
    return torch.tensor(a, device=config.torch_device())


def _row_to_dev(row: np.ndarray) -> torch.Tensor:
    return _to_dev(np.asarray(row, np.uint64).reshape(1, -1))[0]


def _coeff_to_dev(c: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
    """complex host coefficients -> (re, im) float64 device planes."""
    c = np.asarray(c, dtype=complex)
    dev = config.torch_device()
    return (
        torch.tensor(np.ascontiguousarray(c.real, np.float64), device=dev),
        torch.tensor(np.ascontiguousarray(c.imag, np.float64), device=dev),
    )


def _planes_from_dev(x, z, cr, ci) -> Planes:
    """Device planes -> host (uint64, uint64, complex128)."""
    xh = x.cpu().numpy().view(np.uint64)
    zh = z.cpu().numpy().view(np.uint64)
    return xh, zh, cr.cpu().numpy() + 1j * ci.cpu().numpy()


def _try_mesh(kind: str, T: int, runner):
    """Run on ``config.mesh`` when one is set and the problem has at least
    ``config.mesh_threshold`` terms; returns host planes (or a value), or
    None: the caller continues on the single-device path (also the
    overflow fallback)."""
    if config.mesh is None or T < config.mesh_threshold:
        return None
    check_devices(config.mesh, config.torch_device())
    out = runner(config.mesh)
    if out is not None:
        kernel_stats.record(kind, device=True, mesh=True)
    return out


def cleanup(x, z, c, zero_threshold: Optional[float]) -> Planes:
    T, W = x.shape
    if zero_threshold is not None:
        out = _try_mesh("cleanup", T,
                        lambda mesh: sharded.cleanup(x, z, c, zero_threshold, mesh))
        if out is not None:
            return out
    if not config.use_device_io(T * W):
        kernel_stats.record("cleanup", device=False)
        return np_core.cleanup(x, z, c, zero_threshold)
    kernel_stats.record("cleanup", device=True)
    return _planes_from_dev(*torch_core.cleanup_sorted(
        _to_dev(x), _to_dev(z), *_coeff_to_dev(c), zero_threshold
    ))


def multiply_cleanup(x1, z1, c1, x2, z2, c2, zero_threshold: Optional[float]) -> Planes:
    M1, W = x1.shape
    M2 = x2.shape[0]
    if zero_threshold is not None:
        # the sharded axis is op1's terms, but the term count worth sharding
        # is the product's, M1 * M2
        out = _try_mesh("multiply", M1 * M2, lambda mesh: sharded.multiply_cleanup(
            x1, z1, c1, x2, z2, c2, zero_threshold, mesh))
        if out is not None:
            return out
    if not config.use_device_io(M1 * M2 * W):
        kernel_stats.record("multiply", device=False)
        return np_core.multiply_cleanup_host(
            x1, z1, c1, x2, z2, c2, zero_threshold
        )
    kernel_stats.record("multiply", device=True)
    # no padding rows: zero_threshold=None keeps exact zeros (dedup only), as
    # on the host path
    return _planes_from_dev(*torch_core.mul_pairs_cleanup(
        _to_dev(x1), _to_dev(z1), *_coeff_to_dev(c1),
        _to_dev(x2), _to_dev(z2), *_coeff_to_dev(c2), zero_threshold,
    ))


def anticommutes(x1, z1, x2, z2) -> np.ndarray:
    M1, W = x1.shape
    M2 = x2.shape[0]
    if not config.use_device_io(M1 * M2 * W) or M1 * M2 * W < DEVICE_FLOOR:
        kernel_stats.record("anticommutes", device=False)
        return np_core.anticommutes(x1, z1, x2, z2)
    kernel_stats.record("anticommutes", device=True)
    out = cuda.anticommutes(_to_dev(x1), _to_dev(z1), _to_dev(x2), _to_dev(z2))
    return out.cpu().numpy()


def qubitwise_commutes(x1, z1, x2, z2) -> np.ndarray:
    """Termwise QWC adjacency (hot for clique_cover('QWC') measurement
    grouping); the device path is plain torch."""
    M1, W = x1.shape
    M2 = x2.shape[0]
    if not config.use_device_io(M1 * M2 * W):
        kernel_stats.record("qubitwise_commutes", device=False)
        return np_core.qubitwise_commutes(x1, z1, x2, z2)
    kernel_stats.record("qubitwise_commutes", device=True)
    out = torch_core.qubitwise_commutes(_to_dev(x1), _to_dev(z1), _to_dev(x2), _to_dev(z2))
    return out.cpu().numpy()


def perform_rotations(
    x, z, c,
    rotations: Sequence[Tuple[np.ndarray, np.ndarray, Optional[float]]],
    zero_threshold: Optional[float] = 1e-15,
) -> Planes:
    """Apply a sequence of single-Pauli rotations (xr, zr, angle) left-to-right.

    Clifford runs are batched into one scan (one kernel launch on the card);
    the sequence is broken at non-Clifford rotations, which grow the term
    count and trigger a cleanup (mirrors symmer base.py:1163-1186 semantics,
    where a cleanup follows every rotation -- Clifford rotations cannot
    create duplicates so deferring their cleanup is exact).
    """
    T, W = x.shape
    if zero_threshold is not None:
        out = _try_mesh("perform_rotations", T, lambda mesh: sharded.perform_rotations(
            x, z, c, rotations, zero_threshold, mesh))
        if out is not None:
            return out
    use_dev = config.use_device_io(max(1, len(rotations)) * T * W)
    kernel_stats.record("perform_rotations", device=use_dev)
    if not use_dev:
        # consecutive Clifford rotations run as ONE native sequence call
        # (term-count preserving, no intermediate cleanup); non-Clifford
        # steps run the fused native rotate+dedup
        for kind, i, j, ms in segment_rotation_indices(rotations):
            if kind == "nonclifford":
                xr, zr, angle = rotations[i]
                x, z, c = np_core.rotate_single_cleanup(
                    x, z, c, xr, zr, angle, zero_threshold
                )
            else:
                rx = np.asarray([rotations[k][0] for k in range(i, j)])
                rz = np.asarray([rotations[k][1] for k in range(i, j)])
                x, z, c = np_core.clifford_sequence(
                    x, z, c, rx, rz,
                    np.asarray([m % 4 for m in ms], np.int64),
                )
        return np_core.cleanup(x, z, c, zero_threshold)
    return _planes_from_dev(*device_rotation_loop(
        _to_dev(x), _to_dev(z), *_coeff_to_dev(c), rotations, zero_threshold
    ))


def device_rotation_loop(dx, dz, dcr, dci, rotations, zero_threshold):
    """Rotation sequence on planes already on the device.

    Every Clifford run is one ``clifford_scan`` launch, every non-Clifford
    rotation a rotate+cleanup; a final cleanup compacts the result.  Shared
    by the host-boundary dispatch and DeviceOperator.  Returns the device
    planes (dx, dz, dcr, dci) of the surviving terms.
    """
    dev = dx.device
    W = dx.shape[1]
    for kind, *seg in segment_rotations(rotations):
        if kind == "clifford":
            rx, rz, ms = seg
            dx, dz, dcr, dci = cuda.clifford_scan(
                dx, dz, dcr, dci, _to_dev(rx), _to_dev(rz),
                torch.tensor(ms, dtype=torch.int64, device=dev),
            )
            continue
        xr, zr, angle = seg
        a = complex(angle).real
        dx, dz, dcr, dci = torch_core.rotate_nonclifford_cleanup(
            dx, dz, dcr, dci, _row_to_dev(xr), _row_to_dev(zr),
            float(np.cos(a)), float(np.sin(a)), zero_threshold,
        )
        if dx.shape[0] == 0:
            # n_valid = max(n, 1): a fully cancelled step continues from one
            # zero-coefficient identity row (which the final cleanup drops
            # under a threshold and keeps under zero_threshold=None)
            dx = torch.zeros((1, W), dtype=torch.int64, device=dev)
            dz = torch.zeros_like(dx)
            dcr = torch.zeros(1, dtype=torch.float64, device=dev)
            dci = torch.zeros_like(dcr)
    return torch_core.cleanup_sorted(dx, dz, dcr, dci, zero_threshold)


def is_noncontextual(x, z) -> Optional[bool]:
    """Device noncontextuality check; returns None below the size rule (the
    caller then runs the host adjacency path).

    The M x M adjacency is built on the device by the ``anticommutes``
    kernel and tested there (torch_core.check_noncontextual_adj): it never
    reaches host memory, and one bool returns.  The device pays a few
    launches and two syncs, so it takes at least 1024 rows under
    backend='device' and 4096 under 'auto'."""
    M, W = x.shape
    min_rows = 1024 if config.backend == "device" else 4096
    if M < min_rows or not config.use_device_io(M * M * W):
        return None
    kernel_stats.record("is_noncontextual", device=True)
    xd, zd = _to_dev(x), _to_dev(z)
    adj = ~cuda.anticommutes(xd, zd, xd, zd)
    return bool(torch_core.check_noncontextual_adj(adj))


def clifford_rotate_project(
    x, z, c,
    rotations: Sequence[Tuple[np.ndarray, np.ndarray, Optional[float]]],
    stab_x, stab_z, stab_signs,
    free_qubit_mask: np.ndarray,
    zero_threshold: float,
) -> Planes:
    """Fused flagship projection: Clifford rotations + stabilizer projection +
    cleanup in one device pass (one upload, one download).

    Callers must have verified every rotation angle is Clifford
    (is_clifford_angle).

    Args:
        x, z, c: host uint64 planes + complex coefficients.
        rotations: (xr, zr, angle) with angle a pi/2 multiple (None = +1).
        stab_x, stab_z: uint64[S, w] single-qubit rotated stabilizer planes.
        stab_signs: float[S] eigenvalue assignments in {+1, -1, 0}.
        free_qubit_mask: bool[n_qubits], True at columns to keep.
        zero_threshold: cleanup threshold.

    Returns host planes with stabilized columns ZEROED (not deleted) --
    the caller deletes the columns, cf. reference projection/base.py:75-77.
    """
    out = _try_mesh("clifford_rotate_project", x.shape[0],
                    lambda mesh: sharded.clifford_rotate_project(
                        x, z, c, rotations, stab_x, stab_z, stab_signs, free_qubit_mask,
                        zero_threshold, mesh))
    if out is not None:
        return out
    kernel_stats.record("clifford_rotate_project", device=True)
    rx, rz, ms, neg_x, neg_z, col_keep = projection_prep(
        rotations, stab_x, stab_z, stab_signs, free_qubit_mask, x.shape[1]
    )
    return _planes_from_dev(*torch_core.clifford_project_cleanup(
        _to_dev(x), _to_dev(z), *_coeff_to_dev(c),
        _to_dev(rx), _to_dev(rz),
        torch.tensor(ms, dtype=torch.int64, device=config.torch_device()),
        _to_dev(stab_x), _to_dev(stab_z),
        _row_to_dev(neg_x), _row_to_dev(neg_z), _row_to_dev(col_keep),
        zero_threshold,
    ))


def _scalar(re: torch.Tensor, im: torch.Tensor) -> complex:
    return complex(float(re), float(im))


def _state_to_dev(s_pack, amps):
    return (_to_dev(s_pack), *_coeff_to_dev(amps))


def _state_from_dev(bits, ar, ai):
    """Device state -> host (uint64 rows, complex amplitudes)."""
    return bits.cpu().numpy().view(np.uint64), ar.cpu().numpy() + 1j * ai.cpu().numpy()


def device_expval(x, z, cr, ci, s, ar, ai) -> complex:
    """<psi|O|psi> on device planes: the state is deduplicated first (the
    ``expval`` kernel pairs each target with one row), then one kernel."""
    s, ar, ai = torch_state.cleanup_state(s, ar, ai)
    return _scalar(*cuda.expval(x, z, cr, ci, s, ar, ai))


def expval(x, z, c, s_pack, amps) -> complex:
    """<psi|O|psi> with host/device dispatch; on the mesh above
    ``config.mesh_threshold`` terms (a term-sharded sum)."""
    T, W = x.shape
    B = s_pack.shape[0]
    out = _try_mesh("expval", T, lambda mesh: sharded.expval(x, z, c, s_pack, amps, mesh))
    if out is not None:
        return out
    if not config.use_device_io(T * B * W):
        kernel_stats.record("expval", device=False)
        return state_core.expval(x, z, c, s_pack, amps)
    kernel_stats.record("expval", device=True)
    return device_expval(_to_dev(x), _to_dev(z), *_coeff_to_dev(c), *_state_to_dev(s_pack, amps))


def apply_bra(s_pack, amps, x, z, c, zero_threshold):
    """<psi|O (packed planes in, deduplicated packed bra out) with host/device
    dispatch; the device path never builds the B*T product rows on the
    host."""
    T, W = x.shape
    B = s_pack.shape[0]
    if not config.use_device_io(T * B * W) or T * B * W < DEVICE_FLOOR:
        kernel_stats.record("apply_bra", device=False)
        bits, out = state_core.apply_to_bra(s_pack, amps, x, z, c)
        return state_core.cleanup_state(bits, out, zero_threshold)
    kernel_stats.record("apply_bra", device=True)
    bits, ar, ai = torch_state.apply_to_bra(
        *_state_to_dev(s_pack, amps), _to_dev(x), _to_dev(z), *_coeff_to_dev(c)
    )
    return _state_from_dev(*torch_state.cleanup_state(bits, ar, ai, zero_threshold))


def inner_product(s_bra, amp_bra, s_ket, amp_ket) -> complex:
    """<bra|ket> (bra amplitudes pre-conjugated) with host/device dispatch;
    both states are deduplicated on the device first."""
    B1, W = s_bra.shape
    B2 = s_ket.shape[0]
    if not config.use_device_io((B1 + B2) * W):
        kernel_stats.record("inner_product", device=False)
        return state_core.inner_product(s_bra, amp_bra, s_ket, amp_ket)
    kernel_stats.record("inner_product", device=True)
    bra = torch_state.cleanup_state(*_state_to_dev(s_bra, amp_bra))
    ket = torch_state.cleanup_state(*_state_to_dev(s_ket, amp_ket))
    return _scalar(*torch_state.inner_product_sorted(*bra, *ket))


def apply_state(x, z, c, s_pack, amps, zero_threshold):
    """O|psi> (packed planes in, deduplicated packed state out) with
    host/device dispatch; the device path never builds the T*B product rows
    on the host."""
    T, W = x.shape
    B = s_pack.shape[0]
    if not config.use_device_io(T * B * W) or T * B * W < DEVICE_FLOOR:
        kernel_stats.record("apply_state", device=False)
        bits, out = state_core.apply_to_ket(x, z, c, s_pack, amps)
        return state_core.cleanup_state(bits, out, zero_threshold)
    kernel_stats.record("apply_state", device=True)
    bits, ar, ai = torch_state.apply_to_ket(
        _to_dev(x), _to_dev(z), *_coeff_to_dev(c), *_state_to_dev(s_pack, amps)
    )
    return _state_from_dev(*torch_state.cleanup_state(bits, ar, ai, zero_threshold))
