"""Plain-torch version of the GF(2) row reduction kernel (K11).

``rref`` is the plain version of ``csrc/gf2_rref.cu``, which the wrapper
``kernels/cuda.gf2_rref`` calls for CPU tensors: row-reduced echelon form of
packed int64[R, W] rows in place, without reordering, as
``kernels/gf2.rref_packed``'s host path computes it (symmer
``_rref_binary``): in row order, a zero row is skipped, a nonzero row pivots
on its lowest set bit and is XORed into every other row holding that bit.

Like the kernel, it visits only the nonzero rows: a mask of the nonzero
rows is kept and updated for the rows a pivot rewrites, so the loop takes
rank steps, not R.
"""
from __future__ import annotations

import torch


def rref(M: torch.Tensor) -> torch.Tensor:
    """GF(2) RREF of M (int64[R, W]) in place; returns M."""
    R = M.shape[0]
    nonzero = M.ne(0).any(dim=1)
    i = 0
    while i < R:
        ahead = torch.nonzero(nonzero[i:])
        if ahead.numel() == 0:
            break
        p = i + int(ahead[0, 0])
        row = M[p].clone()
        pw = int(torch.nonzero(row)[0, 0])
        word = row[pw]
        pbit = word & -word  # the lowest set bit (two's complement)
        hit = (M[:, pw] & pbit) != 0
        hit[p] = False
        M[hit] ^= row
        nonzero[hit] = M[hit].ne(0).any(dim=1)
        i = p + 1
    return M
