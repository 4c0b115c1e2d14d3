"""Host-side decisions about rotation sequences and stabilizer projections,
shared by the single-device routes (kernels/dispatch.py), the mesh drivers
(parallel/sharded.py) and the host paths: which angles are Clifford, how a
sequence splits into Clifford runs and single non-Clifford rotations, and
the packed masks of the fused projection."""
from __future__ import annotations

import numpy as np

from ..config import config
from . import pack


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
    run-breaking rule shared by the device loop, the mesh driver and the
    packed-host path."""
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


def segment_rotations(rotations):
    """Packed view of :func:`segment_rotation_indices`: ('clifford', rx
    uint64[D, W], rz uint64[D, W], multiples int64[D]) for a run and
    ('nonclifford', xr, zr, angle) for a single rotation."""
    for kind, i, j, ms in segment_rotation_indices(rotations):
        if kind == "clifford":
            yield ("clifford", np.stack([rotations[k][0] for k in range(i, j)]),
                   np.stack([rotations[k][1] for k in range(i, j)]), np.asarray(ms, np.int64))
        else:
            yield ("nonclifford", *rotations[i])


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
