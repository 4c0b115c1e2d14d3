"""Plain-torch versions of the Lanczos kernels.

The X-grouped form of a Pauli sum (``kernels/dense.py``): terms sharing an
X pattern couple the same (r, r ^ x) pairs, so

    H v = sum_g D[g] * v[r ^ ux[g]],
    D[g, r] = sum_{t in g} (-i)^{|Y_t|} c_t (-1)^{popcount(r & z_t)}

with ux the G distinct X patterns as integers (qubit 0 the most significant
bit).  The plain versions of the CUDA kernels, which the wrappers in
``kernels/cuda.py`` call for CPU tensors:

  - ``terms_matvec``: the matvec from the grouped terms
    (``csrc/lanczos_matvec.cu``), the composition of the two functions below;
  - ``build_group_diagonals``: the (G, 2^n) table D (``csrc/group_diag.cu``);
  - ``lanczos_step`` / ``lanczos_replay``: the vector operations of one step
    of the scalar recurrence, pass 1 and pass 2 (``csrc/lanczos_step.cu``);
  - ``ritz_from_basis``: pass 2 from the Krylov basis that pass 1 kept, in
    one launch (``csrc/lanczos_step.cu``'s lanczos_ritz).

``group_matvec`` reads the table; the CPU device's Lanczos drivers build the
table once and call it.  Every sum of the recurrence is ``pairwise_sum``, the
tree of adjacent pairs in index order, and every other operation is one
elementwise IEEE operation on the re / im planes: the result does not depend
on ``torch.get_num_threads()`` and is bit for bit the step kernel's.

``fwht_passes`` is the split of the Walsh-Hadamard transform into passes
that the build kernel runs; the numpy model in
tests/test_torch_kernel_math.py holds its order to ``dense.fwht_rows``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

# bytes of the (groups, columns, rows) gather of one chunk of group_matvec
_CHUNK_BYTES = 64 << 20
# the build kernel's first pass transforms 2^TILE_BITS contiguous points of a
# row in shared memory (64 KB of complex128); later passes 2^STRIDED_BITS
# points of each of 2^(TILE_BITS - STRIDED_BITS) neighbouring columns
TILE_BITS = 12
STRIDED_BITS = 9


def group_matvec(ux: torch.Tensor, D: torch.Tensor, V: torch.Tensor,
                 rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """out[c, r] = sum_g D[g, r] * V[c, r ^ ux[g]] for a (b, 2^n) block V.

    ux: int64[G], taken modulo 2^n as the kernel takes it; D:
    complex128[G, 2^n]; V: complex128[b, 2^n]; rows: an optional (r0, r1)
    to compute only out[:, r0:r1], a (b, r1 - r0) block.  The groups are
    added in the order g = 0..G-1, gathered in chunks of groups, and each
    product is taken on the re / im planes (one IEEE operation at a time:
    torch's complex product rounds differently in its vectorised body and
    in its scalar tail), so a row's value does not depend on the rows
    around it: a row block is bit for bit the whole product's rows."""
    G, dim = D.shape
    b = V.shape[0]
    r0, r1 = (0, dim) if rows is None else (int(rows[0]), int(rows[1]))
    if not 0 <= r0 < r1 <= dim:
        raise ValueError(f"group_matvec: rows {rows} not a range of [0, {dim})")
    idx = torch.arange(r0, r1, dtype=torch.int64, device=V.device)
    out = torch.zeros((b, r1 - r0), dtype=V.dtype, device=V.device)
    acc, Dp, Vp = torch.view_as_real(out), torch.view_as_real(D), torch.view_as_real(V)
    step = max(1, _CHUNK_BYTES // max(1, b * (r1 - r0) * 16))
    for g0 in range(0, G, step):
        src = (idx[None, :] ^ ux[g0:g0 + step, None]) & (dim - 1)   # (B, rows)
        d, v = Dp[None, g0:g0 + step, r0:r1], Vp[:, src]           # (1 | b, B, rows, 2)
        prod = torch.empty(v.shape, dtype=v.dtype, device=v.device)
        pr, pi = prod[..., 0], prod[..., 1]
        torch.mul(d[..., 0], v[..., 0], out=pr).sub_(d[..., 1] * v[..., 1])
        torch.mul(d[..., 0], v[..., 1], out=pi).add_(d[..., 1] * v[..., 0])
        for i in range(prod.shape[1]):
            acc += prod[:, i]
    return out


def terms_matvec(ux: torch.Tensor, off: torch.Tensor, z: torch.Tensor, ph: torch.Tensor,
                 V: torch.Tensor, rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """H @ V from the grouped terms: group_matvec(ux, build_group_diagonals(...), V, rows).

    ux: int64[G]; off: int32[G + 1], the terms of group g are off[g] ..
    off[g + 1] - 1; z: int32[T], the terms' Z patterns; ph: complex128[T],
    (-i)^{|Y_t|} c_t; V: complex128[b, 2^n]; rows: an optional (r0, r1),
    the rows to compute."""
    G, dim = ux.shape[0], V.shape[1]
    n = dim.bit_length() - 1
    counts = (off[1:] - off[:-1]).to(torch.int64)
    gidx = torch.repeat_interleave(torch.arange(G, device=V.device), counts)
    D = build_group_diagonals(gidx, z.to(torch.int64), ph, G, n)
    return group_matvec(ux, D, V, rows)


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


# -- the scalar Lanczos step ------------------------------------------------

def pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum along the last axis (a power of two long) by the tree of adjacent
    pairs: ((x0 + x1) + (x2 + x3)) + ...; the sum of any aligned
    power-of-two block is a node of the tree, so the kernels may cut the
    axis into such blocks and add their sums the same way."""
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def norm(v: torch.Tensor) -> torch.Tensor:
    """||v|| = sqrt(pairwise_sum(v.re^2 + v.im^2)), a 0-d float64 tensor."""
    a = torch.view_as_real(v)
    return torch.sqrt(pairwise_sum(a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1]))


def inv(s: torch.Tensor) -> torch.Tensor:
    """1 / s, and 0 where s is not positive (a breakdown)."""
    return torch.where(s > 0, s.reciprocal(), torch.zeros_like(s))


def _prev_beta(betas: torch.Tensor, j: int) -> torch.Tensor:
    return betas[j - 1] if j > 0 else torch.zeros((), dtype=betas.dtype, device=betas.device)


def lanczos_step(hv, v_prev, v_cur, v_next, alphas, betas, j: int) -> None:
    """One step of pass 1, in place (complex128[2^n] vectors, float64[k]
    scalars):

        w = hv - beta_{j-1} v_prev,  alpha = Re <v_cur, w>,  w -= alpha v_cur,
        beta = ||w||,  alphas[j] = alpha,  betas[j] = beta,
        v_next <- w / beta   (0 where beta is 0)

    hv holds H v_cur and is only read (the kernel's grid route uses it as
    scratch); v_next (which may be v_prev) receives v_{j+1}."""
    h, p, c = (torch.view_as_real(t) for t in (hv, v_prev, v_cur))
    w = h - p * _prev_beta(betas, j)
    alpha = pairwise_sum(c[:, 0] * w[:, 0] + c[:, 1] * w[:, 1])
    w = w - c * alpha
    beta = torch.sqrt(pairwise_sum(w[:, 0] * w[:, 0] + w[:, 1] * w[:, 1]))
    torch.view_as_real(v_next).copy_(w * inv(beta))
    alphas[j] = alpha
    betas[j] = beta


def lanczos_replay(hv, v_prev, v_cur, alphas, betas, j: int, S, y) -> None:
    """One step of pass 2, in place: y[e] += S[j, e] v_cur for the Ritz
    vectors y (complex128[m, 2^n], S float64[k, m]), then pass 1's vector
    operations from the stored alphas[j], betas[j - 1], betas[j], so that
    v_prev <- v_{j+1} bit for bit as pass 1 computed it (hv is only read)."""
    h, p, c, yr = (torch.view_as_real(t) for t in (hv, v_prev, v_cur, y))
    yr.copy_(yr + c[None] * S[j][:, None, None])
    w = h - p * _prev_beta(betas, j)
    w = w - c * alphas[j]
    p.copy_(w * inv(betas[j]))


def ritz_from_basis(basis, S, k_eff: int) -> torch.Tensor:
    """complex128[m, 2^n] Ritz vectors y[e] = sum_{j < k_eff} S[j, e] basis[j]
    (basis complex128[>= k_eff, 2^n], S float64[>= k_eff, m]), added in the
    order j = 0, 1, ... from +0.0 on the re / im planes, one product and one
    sum at a time: bit for bit the y that k_eff ``lanczos_replay`` steps
    accumulate from the same vectors."""
    m, dim = S.shape[1], basis.shape[1]
    b = torch.view_as_real(basis)
    yr = torch.zeros((m, dim, 2), dtype=torch.float64, device=basis.device)
    for j in range(k_eff):
        yr = yr + b[j][None] * S[j][:, None, None]
    return torch.view_as_complex(yr)
