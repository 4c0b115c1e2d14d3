"""Pauli-operator action on sparse computational-basis states (host path).

A state is stored as packed basis bitstrings ``s_pack: uint64[n_basis, W]``
plus complex amplitudes.  The action of a Pauli term P = (x, z) follows from
its one-sparse matrix form (cf. symmer ``symplectic_to_sparse_matrix``
``operators/utils.py:182-228``)::

    P[r, c] nonzero iff c = r ^ x,  P[r, r^x] = (-i)^{|Y|} (-1)^{popcount(r & z)}

so  P|s>    = (-i)^{|Y|} (-1)^{popcount((s^x) & z)} |s ^ x>
    <s|P    = (-i)^{|Y|} (-1)^{popcount(s & z)}     <s ^ x|

This replaces the reference's two-step "state_op" encoding (|0>->Z, |1>->X,
base.py:1564-1619) with a direct phase formula -- fewer popcounts, no
phase-correction pass.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

_MINUS_I_POW = np.array([1, -1j, -1, 1j])  # (-i)^k


def apply_to_ket(
    x: np.ndarray, z: np.ndarray, c: np.ndarray,
    s: np.ndarray, amp: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """All (term, basis) pairs of O|psi>: returns (out_bits, out_amps) undeduped."""
    M, W = x.shape
    B = s.shape[0]
    out_bits = (s[None, :, :] ^ x[:, None, :]).reshape(M * B, W)
    y_cnt = np.bitwise_count(x & z).sum(axis=1).astype(np.int64)
    par = np.bitwise_count(out_bits.reshape(M, B, W) & z[:, None, :]).sum(axis=2).astype(np.int64) & 1
    phase = _MINUS_I_POW[y_cnt % 4][:, None] * (1 - 2 * par)
    out_amp = (phase * c[:, None] * amp[None, :]).reshape(M * B)
    return out_bits, out_amp


def apply_to_bra(
    s: np.ndarray, amp: np.ndarray,
    x: np.ndarray, z: np.ndarray, c: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """All (basis, term) pairs of <psi|O: returns (out_bits, out_amps) undeduped."""
    M, W = x.shape
    B = s.shape[0]
    out_bits = (s[:, None, :] ^ x[None, :, :]).reshape(B * M, W)
    y_cnt = np.bitwise_count(x & z).sum(axis=1).astype(np.int64)
    par = np.bitwise_count(s[:, None, :] & z[None, :, :]).sum(axis=2).astype(np.int64) & 1
    phase = _MINUS_I_POW[y_cnt % 4][None, :] * (1 - 2 * par)
    out_amp = (phase * amp[:, None] * c[None, :]).reshape(B * M)
    return out_bits, out_amp


def cleanup_state(
    s: np.ndarray, amp: np.ndarray, zero_threshold: Optional[float] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Deduplicate basis states, accumulating amplitudes."""
    if s.shape[0] == 0:
        return s, amp
    try:
        from ..native import gf2core
    except Exception:  # pragma: no cover
        gf2core = None
    if gf2core is not None:
        uniq, a_out = gf2core.cleanup_rows(s, np.asarray(amp, complex))
    else:
        uniq, inverse = np.unique(s, axis=0, return_inverse=True)
        inverse = inverse.reshape(-1)
        a_out = np.zeros(
            uniq.shape[0], dtype=np.result_type(amp.dtype, np.complex64)
        )
        np.add.at(a_out, inverse, amp)
    if zero_threshold is not None:
        keep = np.abs(a_out) > zero_threshold
        uniq, a_out = uniq[keep], a_out[keep]
    return np.ascontiguousarray(uniq), a_out


def inner_product(
    s_bra: np.ndarray, amp_bra: np.ndarray,
    s_ket: np.ndarray, amp_ket: np.ndarray,
) -> complex:
    """<bra|ket> via hash-join on basis bitstrings, O(min(B1,B2)) expected.

    Amplitudes are used as stored: the bra amplitudes are assumed already
    conjugated (reference convention, base.py:1800-1817).
    """
    if s_bra.shape[0] > s_ket.shape[0]:
        s_bra, amp_bra, s_ket, amp_ket = s_ket, amp_ket, s_bra, amp_bra
    lookup = {}
    for row, a in zip(s_ket, amp_ket):
        key = row.tobytes()
        lookup[key] = lookup.get(key, 0) + a
    total = 0
    for row, a in zip(s_bra, amp_bra):
        total += a * lookup.get(row.tobytes(), 0)
    return complex(total)


def expval(
    x: np.ndarray, z: np.ndarray, c: np.ndarray,
    s: np.ndarray, amp: np.ndarray,
) -> complex:
    """<psi|O|psi> for a packed operator and packed normalized-or-not state."""
    bits, amps = apply_to_ket(x, z, c, s, amp)
    bits, amps = cleanup_state(bits, amps)
    return inner_product(s, amp.conj(), bits, amps)


def termwise_expval(
    x: np.ndarray, z: np.ndarray,
    s: np.ndarray, amp: np.ndarray,
) -> np.ndarray:
    """Per-term <psi|P_t|psi> (unit coefficients) in ONE batched pass.

    Replaces T separate single-term dispatches (each ~30 ms sync on a
    remote-attached chip) for stabilizer sector assignment
    (reference independent_op.py:364-383 parallelises over processes instead).
    """
    M, W = x.shape
    if M == 0 or s.shape[0] == 0:
        return np.zeros(M, complex)

    # structured row view: used for the sorted join and the dedup below
    def _row_view(a):
        a = np.ascontiguousarray(a)
        return a.view([("", a.dtype)] * a.shape[1]).ravel()

    sv = _row_view(s)
    order = np.argsort(sv)
    sv_sorted = sv[order]
    # collapse duplicate basis rows (summing amplitudes): the sorted join
    # below matches each target against ONE occurrence of a basis row, so a
    # non-canonical state with repeated rows would be undercounted.
    # Duplicate detection rides the join's own sort -- the common canonical
    # case pays one adjacent-equality scan, not a second O(B log B) unique()
    dup = sv_sorted[1:] == sv_sorted[:-1]
    if dup.any():
        starts = np.flatnonzero(np.concatenate(([True], ~dup)))
        amp = np.add.reduceat(amp[order], starts)
        s = s[order[starts]]  # representatives, already in sorted order
        sv_sorted = sv_sorted[starts]
        order = np.arange(starts.shape[0])
    B = s.shape[0]

    y_cnt = np.bitwise_count(x & z).sum(axis=1).astype(np.int64)
    targets = (s[None, :, :] ^ x[:, None, :]).reshape(M * B, W)  # (M*B, W)
    par = (
        np.bitwise_count(targets.reshape(M, B, W) & z[:, None, :])
        .sum(axis=2).astype(np.int64) & 1
    )
    phase = _MINUS_I_POW[y_cnt % 4][:, None] * (1 - 2 * par)

    # match target rows against the support via a sorted structured-view join
    # (vectorised; the former per-(term, row) dict loop was O(M B) interpreted
    # iterations) -- sv_sorted/order computed above, shared with the dedup
    tv = _row_view(targets)
    pos = np.searchsorted(sv_sorted, tv)
    pos_c = np.minimum(pos, B - 1)
    matched = sv_sorted[pos_c] == tv
    j = order[pos_c]
    contrib = np.where(
        matched,
        amp.conj()[j] * phase.reshape(M * B) * np.tile(amp, M),
        0,
    )
    return contrib.reshape(M, B).sum(axis=1)
