"""GF(2) linear algebra on bit-packed rows (host path).

Replaces the reference's numba GF(2) matmul and boolean echelon forms
(symmer ``operators/utils.py:9-78`` and ``:292-359``) with packed-uint64
row operations: a full-row XOR update touches W = ceil(bits/64) words, a 64x
reduction over the boolean implementation.

A C++ fast path (:mod:`symmer_torch.native`) is used for large reductions when
available; stacks of 2,048 rows and more go to the device path
(``kernels/cuda.gf2_rref``, K11) as symmer_tpu routes them
(``symmer_tpu/kernels/gf2.py:46-59``).  Semantics are identical.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .pack import pack_bits, unpack_bits


def rref_packed(M: np.ndarray, inplace: bool = False) -> np.ndarray:
    """Row-reduced echelon form over GF(2) on packed rows, no row reordering.

    Matches symmer ``_rref_binary`` (``operators/utils.py:292``): iterate rows
    in order, pivot on the first set bit, and XOR the pivot row into every
    other row with that bit set (above and below).
    """
    M = np.ascontiguousarray(M, dtype=np.uint64)
    if not inplace:
        M = M.copy()
    R, W = M.shape
    from ..config import config

    # the reference's route: thousands of rows, and the work over the device
    # threshold (or backend 'device'); a missing card raises
    if R >= 2048 and config.use_device_io(R * W):
        import torch

        from . import cuda

        t = torch.from_numpy(M.view(np.int64)).to(config.torch_device())
        M[...] = cuda.gf2_rref(t).cpu().numpy().view(np.uint64)
        return M
    try:
        from ..native import gf2core

        if gf2core is not None and R > 8:
            gf2core.rref_inplace(M)
            return M
    except Exception:
        pass
    for i in range(R):
        row = M[i]
        nz = np.nonzero(row)[0]
        if nz.size == 0:
            continue
        w = int(nz[0])
        word = row[w]
        pivot_bit = word & (~word + np.uint64(1))  # lowest set bit
        hit = (M[:, w] & pivot_bit) != 0
        hit[i] = False
        if hit.any():
            M[hit] ^= row
    return M


def _pivot_cols(M: np.ndarray) -> np.ndarray:
    """First set-bit column index per row; -1 for zero rows."""
    R, W = M.shape
    out = np.full(R, -1, dtype=np.int64)
    for i in range(R):
        nz = np.nonzero(M[i])[0]
        if nz.size:
            w = int(nz[0])
            out[i] = w * 64 + int(M[i, w] & (~M[i, w] + np.uint64(1))).bit_length() - 1
    return out


def rref_packed_reordered(M: np.ndarray) -> np.ndarray:
    """Full RREF with rows ordered by pivot column (zero rows last).

    Matches symmer ``rref_binary`` (``operators/utils.py:317``).
    """
    red = rref_packed(M)
    piv = _pivot_cols(red)
    nonzero = piv >= 0
    order = np.concatenate([
        np.nonzero(nonzero)[0][np.argsort(piv[nonzero], kind="stable")],
        np.nonzero(~nonzero)[0],
    ])
    return red[order]


# ---------------------------------------------------------------------------
# Boolean-matrix wrappers (control-path convenience; sizes here are moderate)
# ---------------------------------------------------------------------------

def rref_bool(matrix: np.ndarray, reorder: bool = False) -> np.ndarray:
    matrix = np.atleast_2d(np.asarray(matrix, dtype=bool))
    n_cols = matrix.shape[1]
    packed = pack_bits(matrix, n_cols)
    red = rref_packed_reordered(packed) if reorder else rref_packed(packed)
    return unpack_bits(red, n_cols)


def cref_bool(matrix: np.ndarray, reorder: bool = True) -> np.ndarray:
    """Column-reduced echelon form: rref of the transpose, transposed back.

    Matches symmer ``cref_binary``/``_cref_binary`` (``operators/utils.py:337-359``).
    """
    return rref_bool(np.asarray(matrix, dtype=bool).T, reorder=reorder).T


def rank_gf2(matrix: np.ndarray) -> int:
    red = rref_bool(matrix)
    return int(np.any(red, axis=1).sum())


def matmul_gf2_packed(
    A_pack: np.ndarray, B_pack: np.ndarray, chunk_bytes: int = 1 << 26
) -> np.ndarray:
    """C[i,j] = parity( popcount(A_i & B_j) ) for packed rows A, B -> bool.

    This is (A @ B^T) mod 2 for the underlying bit matrices — the kernel behind
    all commutation/adjacency checks (cf. symmer ``matmul_GF2``).
    """
    M1, W = A_pack.shape
    M2 = B_pack.shape[0]
    out = np.empty((M1, M2), dtype=bool)
    rows = max(1, chunk_bytes // max(1, M2 * W * 8))
    for i0 in range(0, M1, rows):
        i1 = min(M1, i0 + rows)
        acc = np.bitwise_count(A_pack[i0:i1, None, :] & B_pack[None, :, :]).sum(axis=2)
        out[i0:i1] = (acc & 1).astype(bool)
    return out


def packed_identity(n_bits: int) -> np.ndarray:
    """Packed identity bit matrix: row i has only bit i set."""
    W = max(1, (n_bits + 63) // 64)
    out = np.zeros((n_bits, W), dtype=np.uint64)
    idx = np.arange(n_bits)
    out[idx, idx // 64] = np.uint64(1) << (idx % 64).astype(np.uint64)
    return out


def extract_bit_range(M: np.ndarray, start: int, length: int) -> np.ndarray:
    """Slice bits [start, start+length) out of each packed row."""
    W_out = max(1, (length + 63) // 64)
    w0, b = start // 64, start % 64
    need = W_out + (1 if b else 0)
    src = M[:, w0 : w0 + need]
    if src.shape[1] < need:
        src = np.pad(src, [(0, 0), (0, need - src.shape[1])])
    if b == 0:
        out = src[:, :W_out].copy()
    else:
        out = (src[:, :W_out] >> np.uint64(b)) | (
            src[:, 1 : W_out + 1] << np.uint64(64 - b)
        )
    rem = length % 64
    if rem:
        out[:, -1] &= (np.uint64(1) << np.uint64(rem)) - np.uint64(1)
    return np.ascontiguousarray(out)


def kernel_basis_symplectic(
    A_pack: np.ndarray, n_a: int, B_pack: np.ndarray, n_b: int
) -> np.ndarray:
    """Kernel basis of the bit-concatenation [A | B] without materialising it.

    The symmetry-generator search needs null([Z | X]) of a T x 2n bit matrix;
    for T >> n the concat alone is a multi-10-MB copy.  With the native
    module: scatter XOR-fold each block into sketch buckets (two rounds),
    bit-concatenate only the SMALL folded rows, solve the small kernel
    exactly, and verify every candidate against the unconcatenated blocks in
    one native pass (null_check2).  Verified-exact like
    :func:`_kernel_basis_sketched`; any verification failure falls back to
    the materialised exact path.
    """
    from .pack import concat_bit_planes

    R = A_pack.shape[0]
    n_bits = n_a + n_b
    try:
        from ..native import gf2core
    except Exception:  # pragma: no cover
        gf2core = None
    if gf2core is not None and _sketch_applies(R, n_bits):
        out = _sketched_kernel([(A_pack, n_a), (B_pack, n_b)], gf2core)
        if out is not None:
            return out
    M = concat_bit_planes(A_pack, n_a, B_pack, n_b)
    # sketch=False: a failed sketch here is deterministic (fixed seed, same
    # rowspace) -- re-running it on the materialised concat would redo the
    # identical doomed fold+solve before the exact reduction
    return kernel_basis_packed(M, n_bits, sketch=False)


def _sketch_applies(R: int, n_bits: int) -> bool:
    """Tall enough that the fold+verify sketch beats the direct reduction."""
    return R > 4096 and R >= 4 * n_bits


def _sketched_kernel(blocks, gf2core):
    """Verified GF(2) sketch: null space of a bit-concatenation of blocks.

    The kernel depends only on the ROW SPACE, and rank <= n_bits, so a T-row
    matrix carries enormous redundancy when T >> n_bits.  XOR-fold the rows
    of each block into random buckets (two independent partitions of
    ``n_bits + 128`` buckets each -- a sparse random sketch S, giving
    C = S.M with rowspace(C) = rowspace(M) with overwhelming probability),
    bit-concatenate only the SMALL folded rows, solve the small kernel
    exactly, then VERIFY every candidate against the full unconcatenated
    blocks.  null(C) >= null(M) always holds, so: all candidates verified =>
    the spaces are equal and the answer is exact; any failure => return None
    and the caller falls back to the exact path.  Cost: one linear pass over
    the blocks plus an O(n_bits^2)-scale reduction, instead of an
    O(n_bits * T)-scale reduction -- 20x on the 1000-qubit x 200k-term
    symmetry search.

    Args:
        blocks: list of (packed rows, n_bits) sharing a row count; the
            matrix sketched is their bit-concatenation along columns.
        gf2core: the native module, or None for the numpy fold/verify.
    Returns:
        packed kernel basis rows (exact), or None on verification failure
        or when >128 candidates would make verification cost as much as
        the exact path.
    """
    from .pack import concat_bit_planes, qubit_mask

    R = blocks[0][0].shape[0]
    n_bits = sum(nb for _, nb in blocks)
    rng = np.random.default_rng(0x5EED)
    m = n_bits + 128
    folded_rounds = []
    for _ in range(2):
        idx = rng.integers(0, m, R)
        if gf2core is None:
            order = np.argsort(idx, kind="stable")
            si = idx[order]
            starts = np.flatnonzero(np.r_[True, si[1:] != si[:-1]])
        acc, n_acc = None, 0
        for Bn, nb in blocks:
            if gf2core is not None:
                fb = gf2core.xor_fold(Bn, idx, m)
            else:
                fb = np.bitwise_xor.reduceat(Bn[order], starts, axis=0)
            # stray bits beyond nb in the last packed word fold through
            # XOR, so masking the folded rows == masking the inputs
            fb &= qubit_mask(nb)[None, :]
            acc, n_acc = (
                (fb, nb) if acc is None
                else (concat_bit_planes(acc, n_acc, fb, nb), n_acc + nb)
            )
        folded_rounds.append(acc)
    C = np.ascontiguousarray(np.vstack(folded_rounds))
    cand = kernel_basis_packed(C, n_bits, sketch=False)
    if cand.shape[0] == 0:
        # null(C) contains null(M); an empty sketch kernel proves M has none
        return cand
    if cand.shape[0] > 128:
        return None
    if gf2core is not None:
        if len(blocks) == 1:
            A, B = blocks[0][0], np.zeros((R, 1), np.uint64)
            va, vb = cand, np.zeros((cand.shape[0], 1), np.uint64)
        else:
            (A, n_a), (B, n_b) = blocks
            va = extract_bit_range(cand, 0, n_a)
            vb = extract_bit_range(cand, n_a, n_b)
        return cand if gf2core.null_check2(A, B, va, vb) else None
    for v in cand:
        parity, start = np.zeros(R, dtype=np.int64), 0
        for Bn, nb in blocks:
            vs = extract_bit_range(v[None, :], start, nb)[0]
            parity += np.bitwise_count(Bn & vs[None, :]).sum(
                axis=1, dtype=np.int64
            )
            start += nb
        if (parity & 1).any():
            return None
    return cand


def _kernel_basis_sketched(M: np.ndarray, n_bits: int):
    """Verified GF(2) sketch of :func:`kernel_basis_packed` for tall
    matrices -- single-block wrapper over :func:`_sketched_kernel`."""
    R = M.shape[0]
    W = max(1, (n_bits + 63) // 64)
    if M.shape[1] == W:
        Mn = np.ascontiguousarray(M, dtype=np.uint64)
    else:
        Mn = np.zeros((R, W), dtype=np.uint64)
        Mn[:, : min(W, M.shape[1])] = M[:, : min(W, M.shape[1])]
    try:
        from ..native import gf2core
    except Exception:  # pragma: no cover
        gf2core = None
    return _sketched_kernel([(Mn, n_bits)], gf2core)


def kernel_basis_packed(
    M: np.ndarray, n_bits: int, sketch: bool = True
) -> np.ndarray:
    """Basis of the null space {v : M v = 0 (mod 2)} of the packed bit matrix.

    Used by the symmetry-generator search: stack [M; I], column-reduce, read
    the columns of the identity block under zero columns of the reduced M
    (cf. symmer ``IndependentOp.symmetry_generators`` ``independent_op.py:90-144``).

    With the native module the whole computation stays bit-packed: a C++
    64x64-block transpose + packed RREF, then the kernel vectors are read
    straight out of the identity-block bit range of the qualifying rows.
    Tall matrices (terms >> bits) first go through the verified random
    sketch (:func:`_kernel_basis_sketched`), which is exact whenever it
    returns (candidates are checked against the full M) and falls through
    to the direct reduction otherwise.

    Args:
        M: packed rows, each row a vector of ``n_bits`` bits.
        sketch: allow the tall-matrix sketch attempt; callers that already
            ran (and failed) the deterministic sketch on the same rowspace
            pass False to go straight to the exact reduction.
    Returns:
        packed rows spanning the kernel (possibly zero rows -> empty).
    """
    R = M.shape[0]
    if sketch and _sketch_applies(R, n_bits):
        out = _kernel_basis_sketched(M, n_bits)
        if out is not None:
            return out
    try:
        from ..native import gf2core
    except Exception:  # pragma: no cover
        gf2core = None
    if gf2core is not None:
        W = max(1, (n_bits + 63) // 64)
        Mn = np.zeros((R, W), dtype=np.uint64)
        Mn[:, : M.shape[1]] = M
        stacked = np.vstack([Mn, packed_identity(n_bits)])
        St = gf2core.transpose_bits(stacked, n_bits)   # (n_bits, ceil((R+n)/64))
        red = rref_packed(St, inplace=True)
        # rows whose first R bits vanish correspond to zero columns of the
        # reduced M block; their identity-block bits are the kernel vectors
        prefix = np.zeros(St.shape[1], dtype=np.uint64)
        full, rem = R // 64, R % 64
        prefix[:full] = ~np.uint64(0)
        if rem:
            prefix[full] = (np.uint64(1) << np.uint64(rem)) - np.uint64(1)
        zero_prefix = ~np.any(red & prefix[None, :], axis=1)
        return extract_bit_range(red[zero_prefix], R, n_bits)

    Mb = unpack_bits(M, n_bits)
    stacked = np.vstack([Mb, np.eye(n_bits, dtype=bool)])
    reduced = cref_bool(stacked, reorder=False)
    zero_cols = ~np.any(reduced[:R], axis=0)
    basis = reduced[R:, zero_cols].T  # rows = kernel vectors
    return pack_bits(basis, n_bits)


def generator_reconstruction_packed(
    B_joint: np.ndarray, M_joint: np.ndarray, n_bits: int
):
    """Packed [B; M] column reduction -> (reconstruction bool[T, dim], mask).

    Fully packed equivalent of the reference readout
    ``[B; M] -> [I 0; R F]`` (symmer base.py:523-560): column-reduce the
    stack, mask rows of F with any nonzero entry, return R.  Requires the
    native transpose; callers fall back to the boolean path otherwise.

    Args:
        B_joint: packed generator rows over n_bits bits (dim rows).
        M_joint: packed operator rows over n_bits bits (T rows).
    """
    from ..native import gf2core

    if gf2core is None:
        raise RuntimeError("native module unavailable")
    dim = B_joint.shape[0]
    T = M_joint.shape[0]
    W = max(1, (n_bits + 63) // 64)

    def _fit(A):
        out = np.zeros((A.shape[0], W), dtype=np.uint64)
        out[:, : min(W, A.shape[1])] = A[:, : min(W, A.shape[1])]
        return out

    stacked = np.vstack([_fit(B_joint), _fit(M_joint)])
    St = gf2core.transpose_bits(stacked, n_bits)      # (n_bits, ceil((dim+T)/64))
    red = rref_packed_reordered(St)
    # F block: bits [dim, dim+T) of red rows with index >= dim must vanish
    # for a term to be reconstructable; occupied columns = OR of those rows
    occupied = np.bitwise_or.reduce(red[dim:], axis=0) if red.shape[0] > dim else np.zeros(St.shape[1], np.uint64)
    occ_bits = extract_bit_range(occupied[None, :], dim, T)
    mask = ~unpack_bits(occ_bits, T)[0]
    # R block: bits [dim, dim+T) of the first dim rows, transposed to (T, dim)
    R_cols = extract_bit_range(red[:dim], dim, T)     # (dim, ceil(T/64))
    R_t = gf2core.transpose_bits(R_cols, T)           # (T, ceil(dim/64))
    recon = unpack_bits(R_t, dim)
    return recon, mask
