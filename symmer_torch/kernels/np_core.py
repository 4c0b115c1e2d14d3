"""Host (packed-numpy) implementations of the symplectic kernels.

These are the *small-operator* execution path: below ``config.device_threshold``
term-words, kernel launch latency exceeds the arithmetic cost, so the packed
uint64 numpy kernels here are the fast choice.  The device (torch/CUDA)
implementations in :mod:`symmer_torch.kernels.torch_core` share identical
semantics and are cross-tested against these.

Semantics mirror the reference implementation:
  - multiply phases:  symmer ``operators/base.py:764-794`` / ``utils.py:429-470``
    (phase convention of https://doi.org/10.1103/PhysRevA.68.042318)
  - commutation:      symmer ``operators/base.py:938-971``
  - cleanup:          symmer ``operators/utils.py:230-279``
  - Clifford/non-Clifford rotation: symmer ``operators/base.py:1090-1161``
    (with the negative-angle Clifford sign corrected: we reduce the pi/2
    multiple mod 4, whereas the reference tests ``int_part in [2,3]`` and
    mis-signs e.g. angle=-pi/2).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

Planes = Tuple[np.ndarray, np.ndarray, np.ndarray]  # (x_pack, z_pack, coeffs)

_I4 = np.array([1, 1j, -1, -1j])


def y_count(x_pack: np.ndarray, z_pack: np.ndarray) -> np.ndarray:
    """Number of Y positions per term (popcount of X AND Z)."""
    return np.bitwise_count(x_pack & z_pack).sum(axis=1).astype(np.int64)


def multiply(
    x1: np.ndarray, z1: np.ndarray, c1: np.ndarray,
    x2: np.ndarray, z2: np.ndarray, c2: np.ndarray,
) -> Planes:
    """All-pairs Pauli product (left index outer): rows ordered (i*M2 + j).

    Returns un-deduplicated planes; compose with :func:`cleanup`.
    Routes through the native C++ kernel when available (streams each output
    row once; the numpy branch materialises three (M1, M2, W) popcount
    temporaries).
    """
    try:
        from ..native import gf2core
    except Exception:  # pragma: no cover
        gf2core = None
    if gf2core is not None and x1.shape[0] * x2.shape[0] >= 1024:
        return gf2core.mul_pairs(
            x1, z1, np.asarray(c1, np.complex128),
            x2, z2, np.asarray(c2, np.complex128),
        )
    M1, M2 = x1.shape[0], x2.shape[0]
    xo = x1[:, None, :] ^ x2[None, :, :]
    zo = z1[:, None, :] ^ z2[None, :, :]
    y_in = y_count(x1, z1)[:, None] + y_count(x2, z2)[None, :]
    y_out = np.bitwise_count(xo & zo).sum(axis=2).astype(np.int64)
    # (-1)^{X1.Z2}: anticommutation bookkeeping of the symplectic product
    x1z2 = np.bitwise_count(x1[:, None, :] & z2[None, :, :]).sum(axis=2).astype(np.int64)
    sign = 1 - 2 * (x1z2 & 1)
    phase = sign * _I4[(3 * y_in + y_out) % 4]
    W = x1.shape[1]
    coeffs = (phase * np.outer(c1, c2)).reshape(-1)
    return xo.reshape(-1, W), zo.reshape(-1, W), coeffs


def multiply_single(
    x1: np.ndarray, z1: np.ndarray, c1: np.ndarray,
    xr: np.ndarray, zr: np.ndarray, cr: complex,
) -> Planes:
    """Multiply an operator (M terms) by a single Pauli term from the right."""
    xr = xr.reshape(1, -1); zr = zr.reshape(1, -1)
    xo = x1 ^ xr
    zo = z1 ^ zr
    y_in = y_count(x1, z1) + int(y_count(xr, zr)[0])
    y_out = y_count(xo, zo)
    x1z2 = np.bitwise_count(x1 & zr).sum(axis=1).astype(np.int64)
    sign = 1 - 2 * (x1z2 & 1)
    phase = sign * _I4[(3 * y_in + y_out) % 4]
    return xo, zo, phase * c1 * cr


def cleanup(
    x: np.ndarray, z: np.ndarray, c: np.ndarray,
    zero_threshold: Optional[float] = None,
) -> Planes:
    """Deduplicate rows, accumulating coefficients; drop |coeff|<=threshold.

    Uses the C++ hash dedup when available (first-occurrence order, matching
    the reference's Rust ``unordered_unique``); falls back to a sort-based
    ``np.unique``.
    """
    if x.shape[0] == 0:
        return x, z, c
    from .pack import hstack_words

    joint = hstack_words(x, z)
    try:
        from ..native import gf2core
    except Exception:  # pragma: no cover
        gf2core = None
    if gf2core is not None:
        # fused single pass: unique rows + coefficient accumulation (saves
        # the fancy-index row gather and np.add.at of the two-step form)
        uniq, c_out = gf2core.cleanup_rows(joint, np.asarray(c, complex))
    else:
        uniq, inverse = np.unique(joint, axis=0, return_inverse=True)
        inverse = inverse.reshape(-1)
        c_out = np.zeros(uniq.shape[0], dtype=np.result_type(c.dtype, np.complex64))
        np.add.at(c_out, inverse, c)
    W = x.shape[1]
    xo, zo = uniq[:, :W], uniq[:, W:]
    if zero_threshold is not None:
        keep = np.abs(c_out) > zero_threshold
        xo, zo, c_out = xo[keep], zo[keep], c_out[keep]
    return np.ascontiguousarray(xo), np.ascontiguousarray(zo), c_out


def anticommutes(
    x1: np.ndarray, z1: np.ndarray,
    x2: np.ndarray, z2: np.ndarray,
    chunk: int = 1 << 26,
) -> np.ndarray:
    """Termwise *anti*commutation matrix: True where terms anticommute.

    parity( popcount(x1&z2) + popcount(z1&x2) ) over packed words; chunked to
    bound the (M1, M2, W) broadcast memory.

    Native fast path: the symplectic product is one GF(2) matmul on the
    concatenated planes -- rows1 = [x1|z1], rows2 = [z2|x2] -- so the C++
    popcount-parity kernel computes it directly.
    """
    M1, M2, W = x1.shape[0], x2.shape[0], x1.shape[1]
    from ..native import gf2core

    if gf2core is not None and M1 * M2 * W > (1 << 18):
        rows1 = np.hstack([x1, z1])
        rows2 = np.hstack([z2, x2])
        return gf2core.matmul_gf2(rows1, rows2)
    out = np.empty((M1, M2), dtype=bool)
    rows_per_chunk = max(1, chunk // max(1, M2 * W * 8))
    for i0 in range(0, M1, rows_per_chunk):
        i1 = min(M1, i0 + rows_per_chunk)
        a = np.bitwise_count(x1[i0:i1, None, :] & z2[None, :, :]).sum(axis=2)
        b = np.bitwise_count(z1[i0:i1, None, :] & x2[None, :, :]).sum(axis=2)
        out[i0:i1] = ((a + b) & 1).astype(bool)
    return out


def commutes(x1, z1, x2, z2) -> np.ndarray:
    return ~anticommutes(x1, z1, x2, z2)


def qubitwise_commutes(
    x1: np.ndarray, z1: np.ndarray,
    x2: np.ndarray, z2: np.ndarray,
    chunk: int = 1 << 26,
) -> np.ndarray:
    """Termwise qubitwise-commutation matrix: True where on every qubit the
    two terms are equal or at least one acts trivially.

    Packed formulation (reference base.py:985-1009 broadcasts boolean
    blocks): difference bits masked to the joint support must vanish --
    chunked over the row axis to bound the (M1, M2, W) broadcast.
    """
    M1, M2, W = x1.shape[0], x2.shape[0], x1.shape[1]
    from ..native import gf2core

    if gf2core is not None:
        return gf2core.qwc_matrix(x1, z1, x2, z2)
    n1 = x1 | z1
    n2 = x2 | z2
    out = np.empty((M1, M2), dtype=bool)
    rows_per_chunk = max(1, chunk // max(1, M2 * W * 8))
    for i0 in range(0, M1, rows_per_chunk):
        i1 = min(M1, i0 + rows_per_chunk)
        diff = (
            (x1[i0:i1, None, :] ^ x2[None, :, :])
            | (z1[i0:i1, None, :] ^ z2[None, :, :])
        ) & n1[i0:i1, None, :] & n2[None, :, :]
        out[i0:i1] = ~np.any(diff, axis=2)
    return out


def anticommutes_single(x, z, xr, zr) -> np.ndarray:
    """Anticommutation of each term with a single Pauli -> bool[M]."""
    xr = xr.reshape(-1); zr = zr.reshape(-1)
    a = np.bitwise_count(x & zr).sum(axis=1) + np.bitwise_count(z & xr).sum(axis=1)
    return (a & 1).astype(bool)


def clifford_phase_factor(int_part: int) -> complex:
    """Phase factor applied to -iPQ (resp. P) under R(m*pi/2) conjugation.

    m mod 4 == 0: P ; 1: -iPQ ; 2: -P ; 3: +iPQ.
    """
    m = int_part % 4
    return {0: 1, 1: -1j, 2: -1, 3: 1j}[m]


def rotate_single(
    x: np.ndarray, z: np.ndarray, c: np.ndarray,
    xr: np.ndarray, zr: np.ndarray,
    angle: Optional[float] = None,
    clifford_threshold: float = 1e-18,
) -> Tuple[Planes, bool]:
    """Conjugate the operator by R(t) = e^{i t/2 Q} for a single Pauli Q.

    Returns ``((x, z, c), needs_cleanup)``.  Commuting terms are untouched;
    anticommuting terms map to cos(t) P + sin(t)(-iPQ).  When t is a multiple
    of pi/2 the rotation is Clifford and term count is preserved.
    """
    if angle is None:
        angle = np.pi / 2
    angle = complex(angle).real

    multiple = angle * 2 / np.pi
    int_part = round(multiple)
    is_clifford = abs(int_part - multiple) <= clifford_threshold

    if is_clifford:
        from ..native import gf2core

        if gf2core is not None:
            # single in-place C++ pass (copies first: callers own the input
            # planes); the numpy branch below re-stacks four row subsets and
            # pays ~10x in temporaries
            x_o = np.ascontiguousarray(x, np.uint64).copy()
            z_o = np.ascontiguousarray(z, np.uint64).copy()
            c_o = np.ascontiguousarray(c, np.complex128).copy()
            gf2core.clifford_rotate_inplace(
                x_o, z_o, c_o, xr, zr, int_part % 4
            )
            return (x_o, z_o, c_o), False

    ac = anticommutes_single(x, z, xr, zr)
    if not ac.any():
        return (x, z, c), False

    x_c, z_c, c_c = x[~ac], z[~ac], c[~ac]
    x_a, z_a, c_a = x[ac], z[ac], c[ac]

    if is_clifford:
        m = int_part % 4
        if m == 0:
            x_n, z_n, c_n = x_a, z_a, c_a
        else:
            if m == 2:
                x_n, z_n, c_n = x_a, z_a, -c_a
            else:
                x_n, z_n, c_n = multiply_single(x_a, z_a, c_a, xr, zr, 1.0)
                c_n = c_n * (-1j if m == 1 else 1j)
        return (
            np.vstack([x_n, x_c]),
            np.vstack([z_n, z_c]),
            np.concatenate([c_n, c_c]),
        ), False
    else:
        x_m, z_m, c_m = multiply_single(x_a, z_a, c_a, xr, zr, 1.0)
        return (
            np.vstack([x_c, x_a, x_m]),
            np.vstack([z_c, z_a, z_m]),
            np.concatenate([c_c, c_a * np.cos(angle), c_m * (-1j * np.sin(angle))]),
        ), True


def clifford_sequence(
    x: np.ndarray, z: np.ndarray, c: np.ndarray,
    rx: np.ndarray, rz: np.ndarray, m4s: np.ndarray,
) -> Planes:
    """Apply a run of CLIFFORD rotations (pi/2 multiples ``m4s``) in one
    native call -- the host analog of the device clifford_scan.  Falls back
    to the per-rotation path without the native library.  Term count is
    preserved; no cleanup is needed."""
    try:
        from ..native import gf2core
    except Exception:  # pragma: no cover
        gf2core = None
    if gf2core is not None:
        x_o = np.ascontiguousarray(x, np.uint64).copy()
        z_o = np.ascontiguousarray(z, np.uint64).copy()
        c_o = np.ascontiguousarray(c, np.complex128).copy()
        gf2core.clifford_rotate_sequence_inplace(x_o, z_o, c_o, rx, rz, m4s)
        return x_o, z_o, c_o
    for d in range(len(m4s)):
        (x, z, c), _ = rotate_single(
            x, z, c, rx[d], rz[d], int(m4s[d]) * np.pi / 2
        )
    return x, z, c


def multiply_cleanup_host(
    x1: np.ndarray, z1: np.ndarray, c1: np.ndarray,
    x2: np.ndarray, z2: np.ndarray, c2: np.ndarray,
    zero_threshold: Optional[float] = None,
) -> Planes:
    """:func:`multiply` composed with :func:`cleanup` -- the host analog of
    the fused device mul_pairs_cleanup (jx_core): product rows go straight
    into the native dedup table and the m1*m2 row set never materialises."""
    try:
        from ..native import gf2core
    except Exception:  # pragma: no cover
        gf2core = None
    if gf2core is not None and x1.shape[0] * x2.shape[0] >= 1024:
        xo, zo, co = gf2core.mul_pairs_cleanup(
            x1, z1, np.asarray(c1, complex), x2, z2, np.asarray(c2, complex)
        )
        if zero_threshold is not None:
            keep = np.abs(co) > zero_threshold
            xo, zo, co = xo[keep], zo[keep], co[keep]
        return xo, zo, co
    xo, zo, co = multiply(x1, z1, c1, x2, z2, c2)
    return cleanup(xo, zo, co, zero_threshold)


def rotate_single_cleanup(
    x: np.ndarray, z: np.ndarray, c: np.ndarray,
    xr: np.ndarray, zr: np.ndarray,
    angle: Optional[float],
    zero_threshold: Optional[float] = None,
) -> Planes:
    """``rotate_single`` composed with :func:`cleanup` -- the host analog of
    the fused device rotate+cleanup (jx_core.rotate_nonclifford_cleanup).

    Non-Clifford angles route through the single-pass native kernel when
    available (the doubled row set never materialises); Clifford angles are
    term-count-preserving and skip the cleanup entirely.
    """
    try:
        from ..native import gf2core
    except Exception:  # pragma: no cover
        gf2core = None
    if angle is not None and gf2core is not None and x.shape[0] >= 64:
        a = complex(angle).real
        multiple = a * 2 / np.pi
        if abs(round(multiple) - multiple) > 1e-18:  # genuinely non-Clifford
            xo, zo, co = gf2core.rotate_nonclifford_cleanup(
                x, z, np.asarray(c, complex), xr, zr, a
            )
            if zero_threshold is not None:
                keep = np.abs(co) > zero_threshold
                xo, zo, co = xo[keep], zo[keep], co[keep]
            return xo, zo, co
    (xo, zo, co), needs = rotate_single(x, z, c, xr, zr, angle)
    if needs:
        xo, zo, co = cleanup(xo, zo, co, zero_threshold)
    return xo, zo, co


def tensor(
    x1: np.ndarray, z1: np.ndarray, c1: np.ndarray, nq1: int,
    x2: np.ndarray, z2: np.ndarray, c2: np.ndarray, nq2: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Tensor product (left (x) right), all term pairs, left index outer."""
    from .pack import unpack_bits, pack_bits

    nq = nq1 + nq2
    xb = np.hstack([
        np.repeat(unpack_bits(x1, nq1), x2.shape[0], axis=0),
        np.tile(unpack_bits(x2, nq2), (x1.shape[0], 1)),
    ])
    zb = np.hstack([
        np.repeat(unpack_bits(z1, nq1), z2.shape[0], axis=0),
        np.tile(unpack_bits(z2, nq2), (z1.shape[0], 1)),
    ])
    # phase: terms are I-padded so the product of the two paddings is phaseless,
    # i.e. coefficients simply multiply (Y counts add, no sign change)
    coeffs = np.outer(c1, c2).reshape(-1)
    return pack_bits(xb, nq), pack_bits(zb, nq), coeffs, nq
