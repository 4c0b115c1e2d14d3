"""Plain-torch Pauli action on computational-basis states.

Counterpart of ``symmer_tpu/kernels/jx_state.py``, on the layout of
:mod:`torch_core`: a state is ``s : int64[B, W]`` packed basis rows with
amplitude planes ``ar, ai : float64[B]``.  The one-sparse action
(kernels/state_core.py)::

    P|s> = (-i)^{|Y|} (-1)^{popcount((s^x) & z)} |s ^ x>
    <s|P = (-i)^{|Y|} (-1)^{popcount(s & z)}     <s ^ x|

``expval`` is the plain version of the ``expval`` CUDA kernel
(``csrc/state_expval.cu``) and computes the kernel's function: for each
(term, basis row) pair the target row s_b ^ x_t, found by a binary search
over the lexicographically sorted state rows with whole-row compares (an
exact match, where jx_state compared 96-bit hashes).  The kernel finds the
same pairs through a hash table of linearly hashed rows (``hash_columns``;
``linear_hash`` is the plain version of its hash), with the terms grouped
by X part and a route chosen by ``expval_route``'s rule in a table of
``table_capacity`` slots.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import torch_core

# the seed of the GF(2)-linear row hash of the expval kernel
HASH_SEED = 0x5EED
# (term, basis row) pairs per chunk of the plain expval (bounds its
# (pairs, W) intermediates)
_PAIR_CHUNK = 1 << 21


def _phase_coeffs(x, z, cr, ci):
    """c_t * (-i)^{|Y_t|} per term, as (re, im)."""
    return torch_core.apply_i_pow(-torch_core.y_count(x, z), cr, ci)


def apply_to_ket(x, z, cr, ci, s, ar, ai):
    """All (term, basis) pairs of O|psi>: (bits, amp_re, amp_im), rows
    ordered t*B + b, not deduplicated."""
    T, W = x.shape
    B = s.shape[0]
    bits = (s[None, :, :] ^ x[:, None, :]).reshape(T * B, W)
    par = torch_core.parity_and(bits.reshape(T, B, W), z[:, None, :])  # (T, B)
    pr, pi = _phase_coeffs(x, z, cr, ci)
    sign = (1 - 2 * par).to(cr.dtype)
    out_r = (pr[:, None] * ar[None, :] - pi[:, None] * ai[None, :]) * sign
    out_i = (pr[:, None] * ai[None, :] + pi[:, None] * ar[None, :]) * sign
    return bits, out_r.reshape(T * B), out_i.reshape(T * B)


def apply_to_bra(s, ar, ai, x, z, cr, ci):
    """All (basis, term) pairs of <psi|O: (bits, amp_re, amp_im), rows
    ordered b*T + t.  The bra parity uses the ORIGINAL bits s_b."""
    B, W = s.shape
    T = x.shape[0]
    bits = (s[:, None, :] ^ x[None, :, :]).reshape(B * T, W)
    par = torch_core.parity_and(s[:, None, :], z[None, :, :])  # (B, T)
    pr, pi = _phase_coeffs(x, z, cr, ci)
    sign = (1 - 2 * par).to(cr.dtype)
    out_r = (ar[:, None] * pr[None, :] - ai[:, None] * pi[None, :]) * sign
    out_i = (ar[:, None] * pi[None, :] + ai[:, None] * pr[None, :]) * sign
    return bits, out_r.reshape(B * T), out_i.reshape(B * T)


def cleanup_state(s, ar, ai, zero_threshold: Optional[float] = None):
    """Deduplicate basis rows, summing amplitudes (torch_core.cleanup_sorted
    on a zero Z plane); rows with |amp| <= zero_threshold are dropped."""
    b, _, r, i = torch_core.cleanup_sorted(s, torch.zeros_like(s), ar, ai, zero_threshold)
    return b, r, i


def inner_product_sorted(s1, a1r, a1i, s2, a2r, a2i) -> Tuple[torch.Tensor, torch.Tensor]:
    """<bra|ket> of two DEDUPLICATED states (bra amplitudes pre-conjugated),
    as 0-d (re, im) tensors.

    Rows of both states are grouped exactly (``torch.unique`` over the
    concatenated rows); each group holds at most one row of each side, so
    every ``index_add_`` adds one value to a zero and the sum is the same on
    every run."""
    B1 = s1.shape[0]
    dev, dt = a1r.device, a1r.dtype
    if B1 == 0 or s2.shape[0] == 0:
        z = torch.zeros((), dtype=dt, device=dev)
        return z, z.clone()
    _, inv = torch.unique(torch.cat([s1, s2]), dim=0, return_inverse=True)
    G = int(inv.max()) + 1
    side = []
    for g, r, i in ((inv[:B1], a1r, a1i), (inv[B1:], a2r, a2i)):
        acc = torch.zeros((G, 2), dtype=dt, device=dev)
        acc.index_add_(0, g, torch.stack([r, i], dim=1))
        side.append(acc)
    (br, bi), (kr, ki) = side[0].unbind(1), side[1].unbind(1)
    return (br * kr - bi * ki).sum(), (br * ki + bi * kr).sum()


def sort_rows(s: torch.Tensor) -> torch.Tensor:
    """Permutation sorting int64[B, W] rows lexicographically, word 0 first,
    each word compared as a signed int64 (the order of ``row_less``)."""
    perm = torch.arange(s.shape[0], device=s.device)
    for w in range(s.shape[1] - 1, -1, -1):
        perm = perm[torch.argsort(s[perm, w], stable=True)]
    return perm


def row_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bool[N]: row a_n before row b_n in the order of ``sort_rows``."""
    out = torch.zeros(a.shape[0], dtype=torch.bool, device=a.device)
    for w in range(a.shape[1] - 1, -1, -1):
        out = torch.where(a[:, w] != b[:, w], a[:, w] < b[:, w], out)
    return out


def lower_bound(sorted_rows: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """int64[N]: the first position whose row is not before each target
    (a binary search)."""
    B = sorted_rows.shape[0]
    lo = torch.zeros(targets.shape[0], dtype=torch.int64, device=targets.device)
    hi = torch.full_like(lo, B)
    for _ in range(B.bit_length()):
        active = lo < hi
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        before = row_less(sorted_rows[mid.clamp(max=B - 1)], targets)
        lo = torch.where(active & before, mid + 1, lo)
        hi = torch.where(active & ~before, mid, hi)
    return lo


def hash_columns(W: int) -> torch.Tensor:
    """int32[64 W] (CPU): column i of the 32 x 64W bit matrix A of the row
    hash h(v) = A v over GF(2), drawn from HASH_SEED."""
    g = torch.Generator().manual_seed(HASH_SEED)
    return torch.randint(-(1 << 31), 1 << 31, (64 * W,), generator=g, dtype=torch.int64).to(
        torch.int32)


def linear_hash(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """int32[N]: the XOR of the columns of the set bits of each row, so that
    h(a ^ b) = h(a) ^ h(b) (the expval kernel's hash, in plain torch)."""
    N, W = rows.shape
    h = torch.zeros(N, dtype=torch.int32, device=rows.device)
    cols = cols.to(rows.device)
    for w in range(W):
        for bit in range(64):
            on = ((rows[:, w] >> bit) & 1).bool()
            h = torch.where(on, h ^ cols[64 * w + bit], h)
    return h


def expval_route(n_groups: int, n_rows: int) -> str:
    """'groups' (one probe per (X group, row) pair) or 'pairs' (one probe
    per unordered pair of rows), whichever makes fewer probes."""
    return "groups" if n_groups * n_rows <= n_rows * (n_rows + 1) // 2 else "pairs"


def table_capacity(n_keys: int) -> int:
    """Slots of the expval kernel's open-addressing table: the least power
    of two >= 4 n_keys (a load factor of at most 1/4; the kernel reads 4
    slots at a time)."""
    return max(4, 1 << max(0, 4 * n_keys - 1).bit_length())


def expval(x, z, cr, ci, s, ar, ai) -> Tuple[torch.Tensor, torch.Tensor]:
    """(re, im) of <psi|O|psi> for a DEDUPLICATED state, as 0-d tensors.

    Plain version of the ``expval`` CUDA kernel:

        sum_{t,b} c_t (-i)^{|Y_t|} (-1)^{popc((s_b ^ x_t) & z_t)} a_b conj(a_b')

    over the pairs whose target row s_b ^ x_t is a state row s_b'.  The
    state rows are sorted once (``sort_rows``); each target is found by
    ``lower_bound`` and an exact whole-row compare.  Chunked over terms.
    """
    T, W = x.shape
    B = s.shape[0]
    dev, dt = cr.device, cr.dtype
    re = torch.zeros((), dtype=dt, device=dev)
    im = torch.zeros((), dtype=dt, device=dev)
    if T == 0 or B == 0:
        return re, im
    perm = sort_rows(s)
    s, ar, ai = s[perm], ar[perm], ai[perm]
    pr, pi = _phase_coeffs(x, z, cr, ci)
    tc = max(1, _PAIR_CHUNK // (B * W))
    for t0 in range(0, T, tc):
        xt, zt = x[t0:t0 + tc], z[t0:t0 + tc]
        n = xt.shape[0]
        targets = (s[None, :, :] ^ xt[:, None, :]).reshape(n * B, W)
        par = torch_core.parity_and(targets.reshape(n, B, W), zt[:, None, :])
        pos = lower_bound(s, targets).clamp(max=B - 1)
        match = (s[pos] == targets).all(dim=1).reshape(n, B)
        # a_b conj(a_b') at the matched rows
        mr = ar[None, :] * ar[pos].reshape(n, B) + ai[None, :] * ai[pos].reshape(n, B)
        mi = ai[None, :] * ar[pos].reshape(n, B) - ar[None, :] * ai[pos].reshape(n, B)
        sign = torch.where(match, (1 - 2 * par).to(dt), torch.zeros((), dtype=dt, device=dev))
        cr_t, ci_t = pr[t0:t0 + n, None], pi[t0:t0 + n, None]
        re = re + ((cr_t * mr - ci_t * mi) * sign).sum()
        im = im + ((cr_t * mi + ci_t * mr) * sign).sum()
    return re, im
