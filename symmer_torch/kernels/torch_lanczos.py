"""Plain-torch versions of the two Lanczos kernels.

The X-grouped form of a Pauli sum (``kernels/dense.py``): terms sharing an
X pattern couple the same (r, r ^ x) pairs, so

    H v = sum_g D[g] * v[r ^ ux[g]],
    D[g, r] = sum_{t in g} (-i)^{|Y_t|} c_t (-1)^{popcount(r & z_t)}

with ux the G distinct X patterns as integers (qubit 0 the most significant
bit).  ``group_matvec`` is the plain version of the ``group_matvec`` CUDA
kernel (``csrc/lanczos_matvec.cu``) and ``build_group_diagonals`` of
``build_group_diagonals`` (``csrc/group_diag.cu``).  Both take complex128
tensors; the kernel wrappers in ``kernels/cuda.py`` call these for CPU
tensors.

``fwht_passes`` is the split of the Walsh-Hadamard transform into passes
that the build kernel runs; the numpy model in
tests/test_torch_kernel_math.py holds its order to ``dense.fwht_rows``.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

# bytes of the (groups, columns, rows) gather of one chunk of group_matvec
_CHUNK_BYTES = 64 << 20
# the build kernel's first pass transforms 2^TILE_BITS contiguous points of a
# row in shared memory (64 KB of complex128); later passes 2^STRIDED_BITS
# points of each of 2^(TILE_BITS - STRIDED_BITS) neighbouring columns
TILE_BITS = 12
STRIDED_BITS = 9


def group_matvec(ux: torch.Tensor, D: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """out[c, r] = sum_g D[g, r] * V[c, r ^ ux[g]] for a (b, 2^n) block V.

    ux: int64[G], taken modulo 2^n as the kernel takes it; D:
    complex128[G, 2^n]; V: complex128[b, 2^n].  The groups are added in
    the order g = 0..G-1, gathered in chunks of groups."""
    G, dim = D.shape
    b = V.shape[0]
    rows = torch.arange(dim, dtype=torch.int64, device=V.device)
    out = torch.zeros((b, dim), dtype=V.dtype, device=V.device)
    step = max(1, _CHUNK_BYTES // max(1, b * dim * 16))
    for g0 in range(0, G, step):
        src = (rows[None, :] ^ ux[g0:g0 + step, None]) & (dim - 1)   # (B, dim)
        prod = D[None, g0:g0 + step] * V[:, src]          # (b, B, dim)
        for i in range(prod.shape[1]):
            out += prod[:, i]
    return out


def build_group_diagonals(gidx: torch.Tensor, z_int: torch.Tensor, phase_c: torch.Tensor,
                          G: int, n_qubits: int) -> torch.Tensor:
    """complex128[G, 2^n] table D of the X-grouped form.

    gidx, z_int: int64[T], each term's group and Z pattern (unique pairs);
    phase_c: complex128[T], (-i)^{|Y_t|} c_t.  The phases are added into a
    zeroed table at (gidx, z_int), then each row is Walsh-Hadamard
    transformed by butterflies (a + b, a - b) at h = 1, 2, 4, ... in the
    order of ``dense.fwht_rows``, so the table is bit for bit the host's
    ``dense.group_diagonals``."""
    dim = 1 << n_qubits
    S = torch.zeros((G, dim), dtype=torch.complex128, device=phase_c.device)
    S.view(-1).index_put_((gidx * dim + z_int,), phase_c, accumulate=True)
    h = 1
    while h < dim:
        S4 = S.view(G, dim // (2 * h), 2, h)
        a, b = S4[:, :, 0], S4[:, :, 1]
        S = torch.stack([a + b, a - b], dim=2).view(G, dim)
        h *= 2
    return S


def fwht_passes(n_qubits: int) -> List[Tuple[int, int]]:
    """(s, kb) of each pass of the build kernel: a pass runs the butterfly
    stages h = 2^s .. 2^(s + kb - 1) on tiles of 2^kb points (index bits s
    .. s + kb - 1 of the row) times 2^(TILE_BITS - kb) neighbouring columns
    (the bits below s), capped at the 2^s columns there are.  The first
    pass (s = 0) also adds the terms' phases into its zeroed tile."""
    passes = [(0, min(n_qubits, TILE_BITS))]
    s = TILE_BITS
    while s < n_qubits:
        kb = min(n_qubits - s, STRIDED_BITS)
        passes.append((s, kb))
        s += kb
    return passes


def pass_columns(s: int, kb: int) -> int:
    """Neighbouring columns (values of the index bits below s) per tile."""
    return min(1 << s, 1 << (TILE_BITS - kb))
