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

Entries not yet ported to the device (``qubitwise_commutes``,
``is_noncontextual``, ``expval``, ``apply_state``, ``apply_bra``,
``inner_product``) keep the host implementation and record ``device=False``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import config
from ..profiling import kernel_stats
from . import cuda, np_core, pack, state_core, torch_core

Planes = Tuple[np.ndarray, np.ndarray, np.ndarray]


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


def cleanup(x, z, c, zero_threshold: Optional[float]) -> Planes:
    T, W = x.shape
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
    if not config.use_device_io(M1 * M2 * W):
        kernel_stats.record("anticommutes", device=False)
        return np_core.anticommutes(x1, z1, x2, z2)
    kernel_stats.record("anticommutes", device=True)
    out = cuda.anticommutes(_to_dev(x1), _to_dev(z1), _to_dev(x2), _to_dev(z2))
    return out.cpu().numpy()


def qubitwise_commutes(x1, z1, x2, z2) -> np.ndarray:
    """Termwise QWC adjacency.  Not yet ported to the device: host path."""
    kernel_stats.record("qubitwise_commutes", device=False)
    return np_core.qubitwise_commutes(x1, z1, x2, z2)


def is_clifford_angle(angle, tol: float = None):
    """Return the pi/2 multiple m if the angle is Clifford, else None.

    The tolerance (default ``config.clifford_angle_tol``) is on the MULTIPLE,
    not the angle: an exact multiple accumulated in f64 (e.g. 250*pi/2)
    carries ~1e-14 of rounding, and misclassifying it breaks Clifford-run
    batching AND the fused device projection."""
    if angle is None:
        return 1
    if tol is None:
        tol = config.clifford_angle_tol
    angle = complex(angle).real
    multiple = angle * 2 / np.pi
    m = round(multiple)
    return m if abs(m - multiple) <= tol else None


def segment_rotation_indices(rotations):
    """Yield ('clifford', i, j, multiples) index ranges for maximal Clifford
    runs and ('nonclifford', k, None, None) singles, in order.  The one
    run-breaking rule shared by the device loop and the packed-host path."""
    i, n = 0, len(rotations)
    while i < n:
        if is_clifford_angle(rotations[i][2]) is not None:
            j, ms = i, []
            while j < n:
                mj = is_clifford_angle(rotations[j][2])
                if mj is None:
                    break
                ms.append(mj)
                j += 1
            yield ("clifford", i, j, ms)
            i = j
        else:
            yield ("nonclifford", i, None, None)
            i += 1


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
    for kind, i, j, ms in segment_rotation_indices(rotations):
        if kind == "clifford":
            dx, dz, dcr, dci = cuda.clifford_scan(
                dx, dz, dcr, dci,
                _to_dev(np.stack([rotations[k][0] for k in range(i, j)])),
                _to_dev(np.stack([rotations[k][1] for k in range(i, j)])),
                torch.tensor(ms, dtype=torch.int64, device=dev),
            )
            continue
        xr, zr, angle = rotations[i]
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
    """Device noncontextuality check.  Not yet ported to the device: returns
    None, so the caller runs the host adjacency path."""
    kernel_stats.record("is_noncontextual", device=False)
    return None


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


def stabilizer_masks(stab_x, stab_z, stab_signs, free_qubit_mask):
    """OR masks of the rotated single-qubit stabilizers, the ONE definition
    of the projection's sign/filter semantics (device, host-fused and native
    paths all consume it): (zmask, xmask) for the packed one-XOR commute
    filter, (neg_x, neg_z) for the -1-eigenvalue sign-flip parity (a 0
    assignment behaves as +1, reference base.py:67-72), and the packed
    free-column keep mask."""
    W = stab_x.shape[1]
    zmask = np.bitwise_or.reduce(stab_z, axis=0)
    xmask = np.bitwise_or.reduce(stab_x, axis=0)
    neg = np.real(np.asarray(stab_signs)) < 0
    if neg.any():
        neg_x = np.bitwise_or.reduce(stab_x[neg], axis=0)
        neg_z = np.bitwise_or.reduce(stab_z[neg], axis=0)
    else:
        neg_x = np.zeros(W, np.uint64)
        neg_z = np.zeros(W, np.uint64)
    col_keep = pack.pack_bits(np.asarray(free_qubit_mask).reshape(1, -1))[0]
    return zmask, xmask, neg_x, neg_z, col_keep


def projection_prep(rotations, stab_x, stab_z, stab_signs, free_qubit_mask, W64):
    """Host-side prep for the fused projection: packed Clifford rotation
    planes uint64[D, W64] + their pi/2 multiples, plus the
    ``stabilizer_masks`` sign/column masks."""
    ms = []
    for _, _, angle in rotations:
        m = is_clifford_angle(angle)
        assert m is not None, "fused projection requires Clifford angles"
        ms.append(m)
    rx = np.asarray([xr for xr, _, _ in rotations], np.uint64).reshape(len(ms), W64)
    rz = np.asarray([zr for _, zr, _ in rotations], np.uint64).reshape(len(ms), W64)
    _, _, neg_x, neg_z, col_keep = stabilizer_masks(
        stab_x, stab_z, stab_signs, free_qubit_mask
    )
    return rx, rz, np.asarray(ms, np.int64), neg_x, neg_z, col_keep


def expval(x, z, c, s_pack, amps) -> complex:
    """<psi|O|psi>.  Not yet ported to the device: host path."""
    kernel_stats.record("expval", device=False)
    return state_core.expval(x, z, c, s_pack, amps)


def apply_bra(s_pack, amps, x, z, c, zero_threshold):
    """<psi|O (packed planes in, deduplicated packed bra out).  Not yet
    ported to the device: host path."""
    kernel_stats.record("apply_bra", device=False)
    bits, out = state_core.apply_to_bra(s_pack, amps, x, z, c)
    return state_core.cleanup_state(bits, out, zero_threshold)


def inner_product(s_bra, amp_bra, s_ket, amp_ket) -> complex:
    """<bra|ket> (bra amplitudes pre-conjugated).  Not yet ported to the
    device: host path."""
    kernel_stats.record("inner_product", device=False)
    return state_core.inner_product(s_bra, amp_bra, s_ket, amp_ket)


def apply_state(x, z, c, s_pack, amps, zero_threshold):
    """O|psi> (packed planes in, deduplicated packed state out).  Not yet
    ported to the device: host path."""
    kernel_stats.record("apply_state", device=False)
    bits, out = state_core.apply_to_ket(x, z, c, s_pack, amps)
    return state_core.cleanup_state(bits, out, zero_threshold)
