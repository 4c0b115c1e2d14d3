"""Plain-torch versions of the device programs on the taper path.

Counterpart of ``symmer_tpu/kernels/jx_core.py``.  Layout:

  - planes ``x, z : int64[T, W]``, the bit-identical view of the host
    ``uint64[T, W]`` words (``W = ceil(n_qubits / 64)``);
  - coefficients as split ``float64`` planes ``cr, ci``.

Pauli phases are powers of i times a sign, so phase application is lane
swaps and negations.  Every function runs on whatever device its tensors live
on.  ``anticommutes`` and ``clifford_scan`` here are the plain versions of
the hand-written CUDA kernels: the composite functions below call them
through :mod:`symmer_torch.kernels.cuda`, which launches the kernel for a
CUDA tensor and uses the plain version for a CPU tensor.

torch has no popcount, no xor-reduction and no multi-key sort, so:

  - popcount is a SWAR bit count on 32-bit halves of each word (every value
    stays non-negative, so no int64 overflow and arithmetic ``>>`` is masked);
  - the row signature is four 32-bit lanes (128 bits), combined by a sum
    modulo 2**32 instead of an xor fold;
  - the cleanup sorts are stable single-key sorts (a lexsort), and the
    segment sums are ``torch.segment_reduce``: each segment summed in order,
    never by differences of prefix sums and never with atomics.

No function pads to a bucket: torch runs eagerly, so arrays hold exactly the
valid rows.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import cuda

Planes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

_MASK32 = 0xFFFFFFFF
# odd multipliers below 2**31, so a product with a 32-bit value stays inside
# int64 (the mod-2**32 product is then exact; no reliance on wrap-around)
_HASH_MULT = (0x1E3779B1, 0x045D9F3B, 0x2C1B3C6D, 0x297A2D39)
_HASH_INIT = (0x811C9DC5, 0xDEADBEEF, 0x1B873593, 0x165667B1)
_MIX1, _MIX2 = 0x7FEB352D, 0x6C8E9CF5
# elements per chunk of the (M1, M2, W) anticommutation broadcast
_AC_CHUNK = 1 << 25


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    """Bit count of non-negative values below 2**32 (int64 in, int64 out)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = v + (v >> 8)
    v = v + (v >> 16)
    return v & 0x3F


def popcount(a: torch.Tensor) -> torch.Tensor:
    """Bit count of each int64 word (as its uint64 bit pattern)."""
    return _popcount32(a & _MASK32) + _popcount32((a >> 32) & _MASK32)


def parity64(a: torch.Tensor) -> torch.Tensor:
    """Parity of the bit count of each int64 word -> int64 in {0, 1}."""
    v = (a ^ (a >> 32)) & _MASK32
    for s in (16, 8, 4, 2, 1):
        v = v ^ (v >> s)
    return v & 1


def y_count(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return popcount(x & z).sum(-1)


def parity_and(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """parity(popcount(a & b)) along the word axis -> int64 in {0, 1}."""
    return parity64(a & b).sum(-1) & 1


def apply_i_pow(k: torch.Tensor, re: torch.Tensor, im: torch.Tensor):
    """(re, im) * i^k for an integer tensor k (broadcastable with re/im)."""
    k = k % 4
    out_re = torch.where(
        k == 0, re, torch.where(k == 1, -im, torch.where(k == 2, -re, im))
    )
    out_im = torch.where(
        k == 0, im, torch.where(k == 1, re, torch.where(k == 2, -im, -re))
    )
    return out_re, out_im


def mul_single(x, z, cr, ci, xr, zr):
    """Multiply every term by one Pauli (row vectors xr, zr) from the right."""
    xo = x ^ xr[None, :]
    zo = z ^ zr[None, :]
    y_in = y_count(x, z) + y_count(xr, zr)
    y_out = y_count(xo, zo)
    sign = (1 - 2 * parity_and(x, zr[None, :])).to(cr.dtype)
    pr, pi = apply_i_pow(3 * y_in + y_out, cr * sign, ci * sign)
    return xo, zo, pr, pi


def anticommutes_single(x, z, xr, zr) -> torch.Tensor:
    a = parity_and(x, zr[None, :]) + parity_and(z, xr[None, :])
    return (a & 1).bool()


def anticommutes(x1, z1, x2, z2) -> torch.Tensor:
    """bool[M1, M2]: True where term pairs anticommute.

    Plain version of the ``anticommutes`` CUDA kernel
    (``csrc/anticommutes.cu``); chunked over rows of the first operand to
    bound the (M1, M2, W) broadcast."""
    M1, W = x1.shape
    M2 = x2.shape[0]
    out = torch.empty((M1, M2), dtype=torch.bool, device=x1.device)
    rows = max(1, _AC_CHUNK // max(1, M2 * W))
    for i0 in range(0, M1, rows):
        i1 = min(M1, i0 + rows)
        t = (x1[i0:i1, None, :] & z2[None]) ^ (z1[i0:i1, None, :] & x2[None])
        out[i0:i1] = (parity64(t).sum(-1) & 1).bool()
    return out


def clifford_scan(x, z, cr, ci, rx, rz, rm):
    """Apply a sequence of Clifford rotations R_k(m_k * pi/2) in order.

    Plain version of the ``clifford_scan`` CUDA kernel
    (``csrc/clifford_scan.cu``).

    Args:
        x, z: int64[T, W]; cr, ci: float64[T].
        rx, rz: int64[D, W] rotation Pauli planes.
        rm: int64[D] pi/2 multiples (mod 4 semantics on anticommuting terms:
            0:+P 1:-iPQ 2:-P 3:+iPQ).
    Returns:
        rotated (x, z, cr, ci) -- the term count is preserved.
    """
    for xr, zr, m in zip(rx, rz, rm.tolist()):
        m4 = m % 4
        if m4 == 0:
            continue
        ac = anticommutes_single(x, z, xr, zr)
        if m4 == 2:
            cr = torch.where(ac, -cr, cr)
            ci = torch.where(ac, -ci, ci)
            continue
        xm, zm, mr, mi = mul_single(x, z, cr, ci, xr, zr)
        # m4 == 1: -i * (mr + i mi); m4 == 3: +i * (mr + i mi)
        nr, ni = (mi, -mr) if m4 == 1 else (-mi, mr)
        x = torch.where(ac[:, None], xm, x)
        z = torch.where(ac[:, None], zm, z)
        cr = torch.where(ac, nr, cr)
        ci = torch.where(ac, ni, ci)
    return x, z, cr, ci


def _position_constants(n_cols: int, init: int) -> np.ndarray:
    posc = (np.arange(n_cols, dtype=np.uint64) + np.uint64(init)) * np.uint64(0x9E3779B9)
    posc &= np.uint64(_MASK32)
    return (posc ^ (posc >> np.uint64(16))).astype(np.int64)


def row_signature(x: torch.Tensor, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """128-bit signature of each packed row, as two int64 sort keys.

    Four 32-bit lanes, each a tabulation-style hash: every 32-bit half-word
    is keyed by a lane- and position-specific constant, sent through
    multiply-xorshift rounds and summed modulo 2**32 along the row.  The
    chance that any two of n distinct rows share all four lanes is about
    n**2 / 2**129 (1e-28 at n = 2**20), so grouping by the signature is
    grouping by the row (the argument of jx_core.py:39-45).  The bits differ
    from jx_core.row_hashes; only the grouping they induce matters.
    """
    T, W = x.shape
    words = torch.cat([x, z], dim=1)
    halves = torch.stack(
        [words & _MASK32, (words >> 32) & _MASK32], dim=-1
    ).reshape(T, 4 * W)
    lanes = []
    for mult, init in zip(_HASH_MULT, _HASH_INIT):
        posc = torch.from_numpy(_position_constants(4 * W, init)).to(x.device)
        v = ((halves ^ posc[None, :]) * mult) & _MASK32
        v = ((v ^ (v >> 15)) * _MIX1) & _MASK32
        v = ((v ^ (v >> 13)) * _MIX2) & _MASK32
        v = v ^ (v >> 16)
        lanes.append(v.sum(dim=1) & _MASK32)
    # (h - 2**31) * 2**32 + h' spans int64 exactly: two lanes per key
    ka = (lanes[0] - (1 << 31)) * (1 << 32) + lanes[1]
    kb = (lanes[2] - (1 << 31)) * (1 << 32) + lanes[3]
    return ka, kb


def _lexsort(ka: torch.Tensor, kb: torch.Tensor) -> torch.Tensor:
    """Permutation sorting by (ka, kb); equal keys keep their input order."""
    perm = torch.argsort(kb, stable=True)
    return perm[torch.argsort(ka[perm], stable=True)]


def cleanup_sorted(x, z, cr, ci, zero_threshold: Optional[float] = None) -> Planes:
    """Deduplicate terms: sort by the row signature, sum each group.

    Args:
        x, z: int64[T, W] planes; cr, ci: float64[T].
        zero_threshold: terms with |coeff| <= threshold are dropped; None
            deduplicates only (exact zeros kept).

    Returns:
        (x, z, cr, ci) of the surviving terms, in signature order.  Within a
        group the coefficients are summed sequentially in input order (the
        sorts are stable), never by subtraction.
    """
    T = x.shape[0]
    if T == 0:
        return x, z, cr, ci
    ka, kb = row_signature(x, z)
    perm = _lexsort(ka, kb)
    kas, kbs = ka[perm], kb[perm]
    new = torch.ones(T, dtype=torch.bool, device=x.device)
    new[1:] = (kas[1:] != kas[:-1]) | (kbs[1:] != kbs[:-1])
    starts = new.nonzero().squeeze(1)
    lengths = torch.diff(starts, append=starts.new_full((1,), T))
    c = torch.stack([cr[perm], ci[perm]], dim=1)
    sums = torch.segment_reduce(c, "sum", lengths=lengths, axis=0)
    rep = perm[starts]
    if zero_threshold is not None:
        keep = (torch.hypot(sums[:, 0], sums[:, 1]) > zero_threshold).nonzero().squeeze(1)
        rep, sums = rep[keep], sums[keep]
    return x[rep], z[rep], sums[:, 0].contiguous(), sums[:, 1].contiguous()


def mul_pairs_cleanup(x1, z1, cr1, ci1, x2, z2, cr2, ci2,
                      zero_threshold: Optional[float] = None) -> Planes:
    """All-pairs product (rows ordered i*M2+j) followed by cleanup_sorted.

    Phase of each product: (-1)^{popc(x1&z2)} * i^{3(y1+y2) + y_out}
    (np_core.multiply)."""
    M1, W = x1.shape
    M2 = x2.shape[0]
    xo = (x1[:, None, :] ^ x2[None, :, :]).reshape(M1 * M2, W)
    zo = (z1[:, None, :] ^ z2[None, :, :]).reshape(M1 * M2, W)
    y_in = (y_count(x1, z1)[:, None] + y_count(x2, z2)[None, :]).reshape(-1)
    y_out = y_count(xo, zo)
    sign = 1 - 2 * (
        popcount(x1[:, None, :] & z2[None, :, :]).sum(-1) & 1
    ).reshape(-1).to(cr1.dtype)
    pr = (cr1[:, None] * cr2[None, :] - ci1[:, None] * ci2[None, :]).reshape(-1)
    pi = (cr1[:, None] * ci2[None, :] + ci1[:, None] * cr2[None, :]).reshape(-1)
    pr, pi = apply_i_pow(3 * y_in + y_out, pr * sign, pi * sign)
    return cleanup_sorted(xo, zo, pr, pi, zero_threshold)


def rotate_nonclifford_cleanup(x, z, cr, ci, xr, zr, cos_t: float, sin_t: float,
                               zero_threshold: Optional[float] = None) -> Planes:
    """Conjugation by e^{i t/2 Q} for a non-Clifford angle t, then cleanup.

    Commuting terms are untouched; each anticommuting term P becomes
    cos(t) P + sin(t) (-i P Q).  Only anticommuting terms produce a PQ row,
    as on the host path (np_core.rotate_single).
    """
    ac = anticommutes_single(x, z, xr, zr)
    first_r = torch.where(ac, cr * cos_t, cr)
    first_i = torch.where(ac, ci * cos_t, ci)
    ia = ac.nonzero().squeeze(1)
    xm, zm, mr, mi = mul_single(x[ia], z[ia], cr[ia], ci[ia], xr, zr)
    # -i sin(t) * (mr + i mi): the exact i^3 swap, then the scale by sin
    second_r, second_i = mi * sin_t, -mr * sin_t
    return cleanup_sorted(
        torch.cat([x, xm]), torch.cat([z, zm]),
        torch.cat([first_r, second_r]), torch.cat([first_i, second_i]),
        zero_threshold,
    )


def clifford_project_cleanup(x, z, cr, ci, rx, rz, rm, stab_x, stab_z,
                             neg_x, neg_z, col_keep,
                             zero_threshold: Optional[float]) -> Planes:
    """Fused stabilizer-subspace projection (jx_core.clifford_project_cleanup).

    Clifford rotation scan, removal of terms anticommuting with any rotated
    (single-qubit) stabilizer, eigenvalue sign flips, zeroing of the
    stabilized columns and cleanup.

    Args:
        x, z: int64[T, W]; cr, ci: float64[T].
        rx, rz: int64[D, W] Clifford rotations, rm: int64[D] pi/2 multiples
            (D == 0 skips the scan).
        stab_x, stab_z: int64[S, W] rotated single-qubit stabilizers.
        neg_x, neg_z: int64[W] OR of the stabilizers with eigenvalue -1.
        col_keep: int64[W] mask of the free qubit columns.
    Returns:
        (x, z, cr, ci) with stabilized columns zeroed.
    """
    if rx.shape[0]:
        x, z, cr, ci = cuda.clifford_scan(x, z, cr, ci, rx, rz, rm)
    keep = ~cuda.anticommutes(x, z, stab_x, stab_z).any(dim=1)
    ik = keep.nonzero().squeeze(1)
    x, z, cr, ci = x[ik], z[ik], cr[ik], ci[ik]
    flip = (
        1 - 2 * ((parity_and(x, neg_x[None, :]) + parity_and(z, neg_z[None, :])) & 1)
    ).to(cr.dtype)
    return cleanup_sorted(
        x & col_keep[None, :], z & col_keep[None, :], cr * flip, ci * flip,
        zero_threshold,
    )


def expval_iz_sum(x, cr, ci) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum of the coefficients of the I/Z-only terms: <0...0| O |0...0>."""
    diag = ~(x != 0).any(dim=1)
    zero = torch.zeros((), dtype=cr.dtype, device=cr.device)
    return torch.where(diag, cr, zero).sum(), torch.where(diag, ci, zero).sum()
