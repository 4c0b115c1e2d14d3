"""Bit-packed symplectic representation (host side).

The reference stores a Pauli operator as a boolean symplectic matrix
``bool[n_terms, 2*n_qubits]`` (symmer ``operators/base.py:66-74``).  Here a
term is a pair of *bit planes*::

    x_pack, z_pack : uint64[n_terms, n_words],  n_words = ceil(n_qubits/64)

with bit ``q`` of qubit ``q`` stored LSB-first: ``(pack[t, q//64] >> (q%64)) & 1``.
This layout is 16x denser than the reference's bool array and views
losslessly as ``int64[n_terms, n_words]``, the layout of the torch device
planes (torch has no general uint64 arithmetic).

Pauli letter encoding: X bit set -> X, Z bit set -> Z, both -> Y, neither -> I
(matches symmer ``operators/utils.py:80-107``).
"""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np

WORD = 64  # host word width


def n_words_for(n_qubits: int) -> int:
    return max(1, (n_qubits + WORD - 1) // WORD)


def qubit_mask(n_qubits: int) -> np.ndarray:
    """uint64[n_words] mask with ones in the valid qubit positions."""
    W = n_words_for(n_qubits)
    mask = np.full(W, ~np.uint64(0), dtype=np.uint64)
    rem = n_qubits % WORD
    if rem and n_qubits > 0:
        mask[-1] = (np.uint64(1) << np.uint64(rem)) - np.uint64(1)
    if n_qubits == 0:
        mask[:] = 0
    return mask


def pack_bits(bits: np.ndarray, n_qubits: int = None) -> np.ndarray:
    """Pack a binary matrix (n_terms, n_qubits) into uint64[n_terms, n_words]."""
    bits = np.asarray(bits)
    if bits.ndim == 1:
        bits = bits.reshape(1, -1)
    n_terms, nq = bits.shape
    if n_qubits is None:
        n_qubits = nq
    W = n_words_for(n_qubits)
    if nq == 0:
        return np.zeros((n_terms, W), dtype=np.uint64)
    if bits.dtype != np.bool_ or not bits.flags["C_CONTIGUOUS"]:
        bits = np.ascontiguousarray(bits, dtype=np.bool_)
    packed8 = np.packbits(bits, axis=1, bitorder="little")
    pad = W * 8 - packed8.shape[1]
    if pad:
        packed8 = np.pad(packed8, [(0, 0), (0, pad)])
    return np.ascontiguousarray(packed8).view(np.uint64)


def unpack_bits(pack: np.ndarray, n_qubits: int) -> np.ndarray:
    """Unpack uint64[n_terms, n_words] into a bool matrix (n_terms, n_qubits)."""
    pack = np.ascontiguousarray(np.atleast_2d(pack), dtype=np.uint64)
    if n_qubits == 0:
        return np.zeros((pack.shape[0], 0), dtype=bool)
    bits8 = np.unpackbits(pack.view(np.uint8), axis=1, bitorder="little")
    # 0/1 uint8 views directly as bool -- avoids a full elementwise copy
    return bits8[:, :n_qubits].view(np.bool_)


import functools


@functools.lru_cache(maxsize=None)
def _extract_lut(mask_byte: int) -> np.ndarray:
    """uint8[256]: the bits of v selected by mask_byte, compacted LSB-first
    (a byte-granular pext)."""
    lut = np.zeros(256, np.uint8)
    for v in range(256):
        out = 0
        j = 0
        for bit in range(8):
            if (mask_byte >> bit) & 1:
                out |= ((v >> bit) & 1) << j
                j += 1
        lut[v] = out
    return lut


def select_columns(p: np.ndarray, keep_mask: np.ndarray) -> np.ndarray:
    """Packed qubit-column selection: keep bit columns where keep_mask is
    True, compacted LSB-first -- a vectorised pext over the planes.

    Replaces the unpack -> boolean-slice -> re-pack round trip (the packed
    representation was built to avoid O(T n_qubits) boolean materialisation;
    this runs 16 byte-LUT passes of O(T) u64 ops instead).
    """
    p = np.ascontiguousarray(np.atleast_2d(p), np.uint64)
    T, W = p.shape
    keep_mask = np.asarray(keep_mask, bool)
    nq = len(keep_mask)
    n_keep = int(keep_mask.sum())
    Wout = n_words_for(n_keep)
    out = np.zeros((T, Wout), np.uint64)
    if n_keep == 0 or T == 0:
        return out
    mask_bits = np.zeros(W * 64, bool)
    mask_bits[:nq] = keep_mask
    mask_bytes = np.packbits(mask_bits, bitorder="little")  # (W * 8,)
    try:
        from ..native import gf2core
    except Exception:  # pragma: no cover
        gf2core = None
    if gf2core is not None:
        # one BMI2 PEXT per (row, word) instead of 16 byte-LUT passes
        return gf2core.select_columns(p, mask_bytes.view(np.uint64), Wout)
    bytes_in = p.view(np.uint8).reshape(T, W * 8)
    offs = 0
    for k in range(W * 8):
        mb = int(mask_bytes[k])
        if mb == 0:
            continue
        width = mb.bit_count()
        vals = _extract_lut(mb)[bytes_in[:, k]].astype(np.uint64)
        w, b = offs // 64, offs % 64
        out[:, w] |= vals << np.uint64(b)
        if b + width > 64:
            out[:, w + 1] |= vals >> np.uint64(64 - b)
        offs += width
    return out


def strings_to_planes(pauli_strings: Sequence[str]) -> Tuple[np.ndarray, np.ndarray, int]:
    """Convert Pauli strings to (x_pack, z_pack, n_qubits).

    Vectorised over characters so that e.g. a single 10^8-qubit string packs in
    O(n) byte ops (cf. symmer ``string_to_symplectic`` ``operators/utils.py:140``).
    """
    n_terms = len(pauli_strings)
    if n_terms == 0:
        return (np.zeros((0, 1), np.uint64), np.zeros((0, 1), np.uint64), 0)
    n_qubits = len(pauli_strings[0])
    for s in pauli_strings:
        if len(s) != n_qubits:
            raise ValueError("All Pauli strings must have equal length")
    chars = np.frombuffer("".join(pauli_strings).encode("ascii"), dtype=np.uint8)
    chars = chars.reshape(n_terms, n_qubits) if n_qubits else chars.reshape(n_terms, 0)
    bad = ~np.isin(chars, np.frombuffer(b"IXYZ", dtype=np.uint8))
    if bad.any():
        raise ValueError("pauliword must only contain X,Y,Z,I terms")
    is_x = (chars == ord("X")) | (chars == ord("Y"))
    is_z = (chars == ord("Z")) | (chars == ord("Y"))
    return pack_bits(is_x, n_qubits), pack_bits(is_z, n_qubits), n_qubits


_LETTERS = np.array(["I", "X", "Z", "Y"])


def planes_to_strings(x_pack: np.ndarray, z_pack: np.ndarray, n_qubits: int) -> List[str]:
    """Convert packed planes back to a list of Pauli strings."""
    xb = unpack_bits(x_pack, n_qubits)
    zb = unpack_bits(z_pack, n_qubits)
    codes = xb.astype(np.uint8) + 2 * zb.astype(np.uint8)
    return ["".join(_LETTERS[row]) for row in codes]


def symplectic_to_planes(symp: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
    """Convert a reference-style [X|Z] boolean symplectic matrix to planes."""
    symp = np.atleast_2d(np.asarray(symp))
    n_qubits = symp.shape[1] // 2
    return (
        pack_bits(symp[:, :n_qubits], n_qubits),
        pack_bits(symp[:, n_qubits:], n_qubits),
        n_qubits,
    )


def planes_to_symplectic(x_pack: np.ndarray, z_pack: np.ndarray, n_qubits: int) -> np.ndarray:
    """Convert planes to the reference-style [X|Z] boolean symplectic matrix."""
    return np.hstack([unpack_bits(x_pack, n_qubits), unpack_bits(z_pack, n_qubits)])


def popcount_rows(pack: np.ndarray) -> np.ndarray:
    """Row-wise population count of packed words -> int64[n_terms]."""
    return np.bitwise_count(pack).sum(axis=1).astype(np.int64)


def hstack_words(*arrays: np.ndarray) -> np.ndarray:
    """Fast word-wise horizontal concat of packed planes.

    numpy's axis-1 concatenate on uint64 hits a pathological slow path
    (~250x slower than preallocate+assign at 250k rows on numpy 2.0).
    """
    rows = arrays[0].shape[0]
    widths = [a.shape[1] for a in arrays]
    out = np.empty((rows, sum(widths)), dtype=np.uint64)
    ofs = 0
    for a, w in zip(arrays, widths):
        out[:, ofs : ofs + w] = a
        ofs += w
    return out


def concat_bit_planes(a_pack: np.ndarray, n_a: int, b_pack: np.ndarray, n_b: int) -> np.ndarray:
    """Concatenate two packed bit planes at the BIT level: rows of n_a + n_b bits.

    (hstacking packed words would leave padding gaps when n_a % 64 != 0)
    """
    T = a_pack.shape[0]
    W_out = n_words_for(n_a + n_b)
    out = np.zeros((T, W_out), dtype=np.uint64)
    Wa = n_words_for(n_a)
    out[:, :Wa] = a_pack[:, :Wa] & qubit_mask(n_a)[None, :]
    w0, b = n_a // 64, n_a % 64
    Wb = n_words_for(n_b)
    bp = b_pack[:, :Wb] & qubit_mask(n_b)[None, :]
    if b == 0:
        out[:, w0 : w0 + Wb] |= bp
    else:
        hi = min(w0 + Wb, W_out)
        out[:, w0:hi] |= bp[:, : hi - w0] << np.uint64(b)
        hi2 = min(w0 + 1 + Wb, W_out)
        out[:, w0 + 1 : hi2] |= bp[:, : hi2 - w0 - 1] >> np.uint64(64 - b)
    return out


def bitreverse_words(a: np.ndarray) -> np.ndarray:
    """Reverse the 64 bits inside each packed word (vectorised, no big-ints).

    After reversal, qubit 0 sits at the MSB of word 0, so comparing rows
    lexicographically word-by-word reproduces the big-endian integer order of
    the underlying bitstrings (reference ``binary_array_to_int``,
    operators/utils.py:618).
    """
    a = np.asarray(a, dtype=np.uint64)
    m1 = np.uint64(0x5555555555555555)
    m2 = np.uint64(0x3333333333333333)
    m4 = np.uint64(0x0F0F0F0F0F0F0F0F)
    a = ((a >> np.uint64(1)) & m1) | ((a & m1) << np.uint64(1))
    a = ((a >> np.uint64(2)) & m2) | ((a & m2) << np.uint64(2))
    a = ((a >> np.uint64(4)) & m4) | ((a & m4) << np.uint64(4))
    return a.byteswap()


def rows_to_bytes(x_pack: np.ndarray, z_pack: np.ndarray) -> List[bytes]:
    """Hashable canonical key per term (used in host dictionaries)."""
    joint = hstack_words(x_pack, z_pack)
    return [row.tobytes() for row in joint]
