"""Plain-torch versions of the device programs on the taper path.

Counterpart of ``symmer_tpu/kernels/jx_core.py``.  Layout:

  - planes ``x, z : int64[T, W]``, the bit-identical view of the host
    ``uint64[T, W]`` words (``W = ceil(n_qubits / 64)``);
  - coefficients as split ``float64`` planes ``cr, ci``.

Pauli phases are powers of i times a sign, so phase application is lane
swaps and negations.  Every function runs on whatever device its tensors live
on.  ``anticommutes``, ``clifford_scan``, ``route_rows``,
``row_signature``, ``pair_products``, ``rotation_rows``, ``project_rows``,
``sort_keys``, ``merge_groups``, ``merge_small``, ``cleanup_small`` and
``product_small`` here are the plain versions of the
hand-written CUDA kernels: the composite functions below
call them through :mod:`symmer_torch.kernels.cuda`, which launches the
kernel for a CUDA tensor and uses the plain version for a CPU tensor.

torch has no popcount, no xor-reduction and no multi-key sort, so:

  - popcount is a SWAR bit count on 32-bit halves of each word (every value
    stays non-negative, so no int64 overflow and arithmetic ``>>`` is masked);
  - the row signature is four 32-bit lanes (128 bits), combined by a sum
    modulo 2**32 instead of an xor fold (``row_signature`` here is the
    plain version of the ``row_signature`` CUDA kernel,
    ``csrc/row_signature.cu``, which the cleanups launch on a card);
  - a cleanup of at most ``cuda.SMALL_ROWS`` slots is one kernel that
    groups, sorts and merges (``merge_small``, the plain version of
    ``csrc/merge_small.cu``: a stable sort by both keys, then
    ``merge_groups``); a small cleanup or product (``cuda.small_fused``)
    also signs its slots in that kernel (``cleanup_small``,
    ``product_small``); a larger one sorts by the first signature key alone
    (``sort_keys``, the plain version of ``csrc/sort_keys.cu``), and by
    both keys (a lexsort of two stable sorts) only where ``merge_groups``
    finds that two signatures share the first; in ``merge_groups`` (the
    plain version of ``csrc/merge_groups.cu``) the segment sums are
    ``torch.segment_reduce``: each segment summed in order from +0.0, never
    by differences of prefix sums and never with atomics.

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


def qubitwise_commutes(x1, z1, x2, z2) -> torch.Tensor:
    """bool[M1, M2]: True where term pairs commute qubit by qubit (the
    difference bits masked to the joint support vanish); chunked over rows
    of the first operand like ``anticommutes``."""
    M1, W = x1.shape
    M2 = x2.shape[0]
    out = torch.empty((M1, M2), dtype=torch.bool, device=x1.device)
    n2 = (x2 | z2)[None]
    rows = max(1, _AC_CHUNK // max(1, M2 * W))
    for i0 in range(0, M1, rows):
        i1 = min(M1, i0 + rows)
        diff = ((x1[i0:i1, None, :] ^ x2[None]) | (z1[i0:i1, None, :] ^ z2[None])) & (
            (x1[i0:i1] | z1[i0:i1])[:, None, :] & n2
        )
        out[i0:i1] = ~(diff != 0).any(dim=2)
    return out


def pack_bool_rows(a: torch.Tensor) -> torch.Tensor:
    """bool[M, N] -> int64[M, ceil(N / 64)]: bit j of a row at bit j % 64 of
    word j // 64 (the layout of pack.pack_bits), built a byte at a time so
    the only full-size intermediate is one uint8 per element."""
    M, N = a.shape
    n_pad = -(-N // 64) * 64
    if n_pad != N:
        a = torch.cat([a, a.new_zeros((M, n_pad - N))], dim=1)
    weights = (1 << torch.arange(8, device=a.device, dtype=torch.int32)).to(torch.uint8)
    out = torch.empty((M, n_pad // 8), dtype=torch.uint8, device=a.device)
    rows = max(1, _AC_CHUNK // max(1, n_pad))
    for i0 in range(0, M, rows):
        b = a[i0:i0 + rows].reshape(-1, n_pad // 8, 8).to(torch.uint8)
        out[i0:i0 + rows] = (b * weights).sum(dim=2, dtype=torch.uint8)
    # little-endian bytes: byte k of a word holds bits 8k..8k+7
    return out.view(torch.int64)


def check_noncontextual_adj(adj: torch.Tensor) -> torch.Tensor:
    """Noncontextuality test on a commutation adjacency, as a 0-d bool tensor.

    Counterpart of jx_core.check_noncontextual_adj (the criterion of
    operators/utils.check_adjmat_noncontextual): universal rows (commuting
    with every term) drop out; the rest is noncontextual iff the distinct
    adjacency rows partition the non-universal terms into cliques, i.e.
    every non-universal column is set in exactly one distinct row.  The
    rows are packed to bits and grouped exactly (``torch.unique`` over the
    packed rows) instead of by jx_core's 128-bit hash.  Everything stays on
    the adjacency's device; only the caller's ``bool()`` syncs.
    """
    universal = adj.all(dim=1)
    rows = pack_bool_rows(adj[~universal])
    if rows.shape[0] == 0:
        return torch.ones((), dtype=torch.bool, device=adj.device)
    distinct = torch.unique(rows, dim=0)
    M = adj.shape[0]
    shifts = torch.arange(64, device=adj.device)
    counts = torch.zeros(M, dtype=torch.int64, device=adj.device)
    step = max(1, _AC_CHUNK // (64 * distinct.shape[1]))
    for i0 in range(0, distinct.shape[0], step):
        d = distinct[i0:i0 + step]
        counts += ((d[:, :, None] >> shifts) & 1).reshape(d.shape[0], -1)[:, :M].sum(dim=0)
    return (universal | (counts == 1)).all()


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


def route_rows(x, z, cr, ci, key, k: int, bit: int, keep, send) -> torch.Tensor:
    """Stable partition of rows by bit k of their routing key: rows whose
    bit equals `bit` go, in input order, to the front of the keep buffers
    (x, z, cr, ci), the others to the front of the send buffers; returns
    int64[2] (kept, sent).

    Plain version of the ``route_rows`` CUDA kernel (``csrc/route_rows.cu``),
    one round of the mesh's exchange (parallel/distributed.py)."""
    go = ((key >> k) & 1) == bit
    counts = []
    for rows, bufs in ((go, keep), (~go, send)):
        idx = rows.nonzero().squeeze(1)
        m = idx.shape[0]
        for src, dst in zip((x, z, cr, ci), bufs):
            torch.index_select(src, 0, idx, out=dst[:m])
        counts.append(m)
    return torch.tensor(counts, dtype=torch.int64, device=x.device)


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

    Plain version of the ``row_signature`` CUDA kernel
    (``csrc/row_signature.cu``), which computes the same bits.
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
    """Permutation sorting by (ka, kb); equal keys keep their input order.
    The plain version of the repair route (lexsort_keys), and the sort the
    cleanups made before K17."""
    perm = torch.argsort(kb, stable=True)
    return perm[torch.argsort(ka[perm], stable=True)]


def sort_keys(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(perm, keys[perm]): the stable ascending argsort of int64 keys, as
    int32.  Plain version of the ``sort_keys`` CUDA kernel
    (``csrc/sort_keys.cu``, K17)."""
    perm = torch.argsort(keys, stable=True).int()
    return perm, keys[perm]


def lexsort_keys(ka: torch.Tensor, kb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(perm, ka[perm]) of the stable sort by (ka, kb): a stable sort by kb,
    then by ka gathered through it, with ``cuda.sort_keys`` (K17 twice on a
    card).  perm is int32 and equals _lexsort(ka, kb)."""
    by_b, _ = cuda.sort_keys(kb)
    by_a, kas = cuda.sort_keys(ka[by_b])
    return by_b[by_a], kas


def _merge_sorted(ka, kb, cr, ci, zero_threshold, rows, live=None):
    """Group, sum and compact the rows of signatures (ka, kb).  Up to
    cuda.SMALL_ROWS rows one kernel does it all (merge_small: K3's one-block
    route, one launch, no split check).  Above, K17 sorts by ka alone, K3
    merges the sorted rows and checks the sort; where two signatures share
    ka (a 64-bit collision, about T**2 / 2**65) K3 reports a split run, and
    the rows are sorted by (ka, kb) (lexsort_keys) and merged again without
    the check.  The output does not depend on the route or on which sort
    ran (merge_groups), so it is the parent's _lexsort composition's, bit
    for bit.  Counts each repair in cuda.sort_repairs."""
    if ka.shape[0] <= cuda.SMALL_ROWS:
        return cuda.merge_small(ka, kb, cr, ci, zero_threshold, rows, live)
    perm, kas = cuda.sort_keys(ka)
    out = cuda.merge_groups(perm, kas, ka, kb, cr, ci, zero_threshold, rows, live)
    if out is None:
        cuda.sort_repairs += 1
        perm, kas = lexsort_keys(ka, kb)
        out = cuda.merge_groups(perm, kas, ka, kb, cr, ci, zero_threshold, rows, live, False)
    return out


def cleanup_sorted(x, z, cr, ci, zero_threshold: Optional[float] = None) -> Planes:
    """Deduplicate terms: sort by the row signature, sum each group.

    Args:
        x, z: int64[T, W] planes; cr, ci: float64[T].
        zero_threshold: terms with |coeff| <= threshold are dropped; None
            deduplicates only (exact zeros kept).

    Returns:
        (x, z, cr, ci) of the surviving terms, in the order of their first
        occurrence in the input (as np_core.cleanup).  Within a group the
        coefficients are summed sequentially in input order (the sorts are
        stable), never by subtraction.
    """
    return _cleanup(x, z, cr, ci, zero_threshold, False)


def cleanup_keyed(x, z, cr, ci, zero_threshold: Optional[float] = None):
    """cleanup_sorted, with the surviving rows' first signature key (``ka``
    of row_signature) as a fifth output: the mesh's exchange routes rows by
    its bits (parallel/distributed.py) without hashing them again."""
    return _cleanup(x, z, cr, ci, zero_threshold, True)


def _cleanup(x, z, cr, ci, zero_threshold, keyed: bool):
    if x.shape[0] == 0:
        return (x, z, cr, ci) + ((x.new_empty((0,)),) if keyed else ())
    x, z, cr, ci = x.contiguous(), z.contiguous(), cr.contiguous(), ci.contiguous()
    # on a card: a small cleanup in one launch (K3's one-block route signing
    # its rows, csrc/merge_small.cu), else K2, then K3's one-block route or
    # K17 and K3 (csrc/row_signature.cu, csrc/sort_keys.cu,
    # csrc/merge_groups.cu); this module's plain versions on the CPU
    if cuda.small_fused(*x.shape):
        out = cuda.cleanup_small(x, z, cr, ci, zero_threshold)
    else:
        ka, kb = cuda.row_signature(x, z)
        out = _merge_sorted(ka, kb, cr, ci, zero_threshold, (x, z))
    return out if keyed else out[:4]


def cleanup_small(x, z, cr, ci, zero_threshold: Optional[float]):
    """merge_small of the rows' signatures (row_signature) and the planes'
    row source: the cleanup of a few rows with its (ka) fifth output.

    Plain version of ``cuda.cleanup_small`` (``csrc/merge_small.cu``'s
    fused route, which signs the rows inside K3's one-block route)."""
    return merge_small(*row_signature(x, z), cr, ci, zero_threshold, (x, z))


def product_small(x1, z1, cr1, ci1, x2, z2, cr2, ci2, zero_threshold: Optional[float]):
    """merge_small of pair_products' keys and coefficients and the pair row
    source: the product and cleanup of a few pairs, with its (ka) fifth
    output.

    Plain version of ``cuda.product_small`` (``csrc/merge_small.cu``'s
    fused route, which signs the pairs inside K3's one-block route)."""
    return merge_small(*pair_products(x1, z1, cr1, ci1, x2, z2, cr2, ci2), zero_threshold,
                       (x1, z1, x2, z2))


def _source_rows(rows, rep):
    """The rows `rep` of a row source (cuda.row_source): the planes (x, z);
    a product's operands (x1, z1, x2, z2), row r = x1[r // M2] ^ x2[r % M2];
    a rotation's (x, z, xr, zr), row r = x[r mod T] ^ (xr where r >= T);
    masked rows (x, z, col_keep), row r = x[r] & col_keep."""
    kind = cuda.row_source(rows)
    if kind == cuda.PLANES:
        return rows[0][rep], rows[1][rep]
    if kind == cuda.MASKED:
        x, z, keep = rows
        return x[rep] & keep, z[rep] & keep
    if kind == cuda.ROTATION:
        x, z, xr, zr = rows
        T = x.shape[0]
        i, twin = rep % T, (rep >= T)[:, None]
        return (torch.where(twin, x[i] ^ xr, x[i]), torch.where(twin, z[i] ^ zr, z[i]))
    x1, z1, x2, z2 = rows
    i, j = rep // x2.shape[0], rep % x2.shape[0]
    return x1[i] ^ x2[j], z1[i] ^ z2[j]


def merge_groups(perm, kas, ka, kb, cr, ci, zero_threshold: Optional[float], rows, live=None,
                 check: bool = True):
    """The cleanup after its sort: group the rows by their signature (ka,
    kb), sum each group, drop the groups with |sum| <= zero_threshold (None
    keeps exact zeros), and return (x, z, cr, ci, ka) of the survivors in
    the order of their first rows in the input.

    perm (int32 or int64) sorts the rows stably by ka (``sort_keys``) or,
    with ``check`` False, by (ka, kb) (``lexsort_keys``, ``_lexsort``); kas
    is ka[perm].  A group's coefficients are summed from +0.0 in input order
    (torch.segment_reduce) and its first sorted row is its first input row;
    the groups come out in the order of those rows, whatever their order in
    perm.  ``check``: where two adjacent sorted positions (live or dead)
    have equal ka and unequal kb, a sort by ka alone split a group, and the
    function returns None.  ``live`` (bool[T] or
    None, every row) flags the rows that take part: a dead row adds nothing
    and is no group's first row, and a group of dead rows gives nothing.
    ``rows`` is the row source (cuda.row_source): the planes (x, z); a
    product's operands (x1, z1, x2, z2) for the rows of ``pair_products``;
    a rotation's (x, z, xr, zr) for ``rotation_rows``' slots; (x, z,
    col_keep) for ``project_rows``' masked rows.

    Plain version of the ``merge_groups`` CUDA kernel
    (``csrc/merge_groups.cu``)."""
    if check and kas.shape[0] > 1:
        kbs = kb[perm]
        if bool(((kas[1:] == kas[:-1]) & (kbs[1:] != kbs[:-1])).any()):
            return None
    if live is not None:
        on = live[perm]
        perm, kas = perm[on], kas[on]
    perm = perm.long()
    T = perm.shape[0]
    if T == 0:
        empty = rows[0].new_empty((0, rows[0].shape[1]))
        return empty, empty.clone(), cr[:0], ci[:0], ka[:0]
    kbs = kb[perm]
    new = torch.ones(T, dtype=torch.bool, device=perm.device)
    new[1:] = (kas[1:] != kas[:-1]) | (kbs[1:] != kbs[:-1])
    starts = new.nonzero().squeeze(1)
    lengths = torch.diff(starts, append=starts.new_full((1,), T))
    c = torch.stack([cr[perm], ci[perm]], dim=1)
    sums = torch.segment_reduce(c, "sum", lengths=lengths, axis=0)
    rep = perm[starts]  # each group's first row in input order (stable sorts)
    # groups in first-occurrence order, the host path's order
    # (np_core.cleanup): order-sensitive callers (sort by magnitude with
    # ties, the noncontextual sweep) then choose as the host path does
    first = torch.argsort(rep)
    rep, sums = rep[first], sums[first]
    if zero_threshold is not None:
        keep = (torch.hypot(sums[:, 0], sums[:, 1]) > zero_threshold).nonzero().squeeze(1)
        rep, sums = rep[keep], sums[keep]
    x, z = _source_rows(rows, rep)
    return x, z, sums[:, 0].contiguous(), sums[:, 1].contiguous(), ka[rep]


def merge_small(ka, kb, cr, ci, zero_threshold: Optional[float], rows, live=None):
    """merge_groups after the stable sort by (ka, kb), without the check:
    the cleanup's merge with its own sort.

    Plain version of the ``merge_small`` CUDA kernel
    (``csrc/merge_small.cu``, K3's one-block route), which groups the
    signatures in a hash table and sorts each group's slots by (first slot,
    slot); the output is the same."""
    perm = _lexsort(ka, kb)
    return merge_groups(perm.int(), ka[perm], ka, kb, cr, ci, zero_threshold, rows, live, False)


def pair_products(x1, z1, cr1, ci1, x2, z2, cr2, ci2):
    """(ka, kb, pr, pi) of the all-pairs product, rows ordered i*M2+j: the
    row signature of each product row (x1[i] ^ x2[j], z1[i] ^ z2[j]) and its
    coefficient, with phase (-1)^{popc(x1&z2)} * i^{3(y1+y2) + y_out}
    (np_core.multiply).

    Plain version of the ``pair_products`` CUDA kernel
    (``csrc/pair_products.cu``), which never writes the product rows; this
    version builds them and takes their signatures from
    ``cuda.row_signature`` (K2 on a card), as the cleanup of the product
    planes did before K4."""
    M1, W = x1.shape
    M2 = x2.shape[0]
    xo = (x1[:, None, :] ^ x2[None, :, :]).reshape(M1 * M2, W)
    zo = (z1[:, None, :] ^ z2[None, :, :]).reshape(M1 * M2, W)
    ka, kb = cuda.row_signature(xo, zo)
    y_in = (y_count(x1, z1)[:, None] + y_count(x2, z2)[None, :]).reshape(-1)
    y_out = y_count(xo, zo)
    sign = 1 - 2 * (
        popcount(x1[:, None, :] & z2[None, :, :]).sum(-1) & 1
    ).reshape(-1).to(cr1.dtype)
    pr = (cr1[:, None] * cr2[None, :] - ci1[:, None] * ci2[None, :]).reshape(-1)
    pi = (cr1[:, None] * ci2[None, :] + ci1[:, None] * cr2[None, :]).reshape(-1)
    pr, pi = apply_i_pow(3 * y_in + y_out, pr * sign, pi * sign)
    return ka, kb, pr, pi


def mul_pairs_cleanup(x1, z1, cr1, ci1, x2, z2, cr2, ci2,
                      zero_threshold: Optional[float] = None) -> Planes:
    """All-pairs product (rows ordered i*M2+j) followed by cleanup_sorted.

    A small product (cuda.small_fused) is one launch on a card: K3's
    one-block route signs the pairs itself (cuda.product_small).  Else K4
    gives each product row's signature and coefficient without the product
    rows (one launch), K3 merges them (_merge_sorted: its one-block route up
    to cuda.SMALL_ROWS pairs, else after K17's sort).  Either way only the
    survivors' rows are built, from their pair index
    (jx_core.mul_pairs_cleanup's row_source)."""
    x1, z1, x2, z2 = (t.contiguous() for t in (x1, z1, x2, z2))
    cr1, ci1, cr2, ci2 = (t.contiguous() for t in (cr1, ci1, cr2, ci2))
    if cuda.small_fused(x1.shape[0] * x2.shape[0], x1.shape[1]):
        return cuda.product_small(x1, z1, cr1, ci1, x2, z2, cr2, ci2, zero_threshold)[:4]
    ka, kb, pr, pi = cuda.pair_products(x1, z1, cr1, ci1, x2, z2, cr2, ci2)
    return _merge_sorted(ka, kb, pr, pi, zero_threshold, (x1, z1, x2, z2))[:4]


def rotation_rows(x, z, cr, ci, xr, zr, cos_t: float, sin_t: float):
    """(ka, kb, pr, pi, live) of the 2T slots of a non-Clifford rotation by
    Q = (xr, zr): slot r is term r (its signature; its coefficient times
    cos_t where it anticommutes with Q), slot T + r its P Q row (the
    signature of (x ^ xr, z ^ zr); mul_single's coefficient times -i sin_t),
    live where the term anticommutes.  Only anticommuting terms grow a P Q
    row, as on the host path (np_core.rotate_single).

    Plain version of the ``rotation_rows`` CUDA kernel
    (``csrc/rotation_rows.cu``), which never writes the rotated rows; this
    version builds them and takes the signatures from
    ``cuda.row_signature``."""
    ac = anticommutes_single(x, z, xr, zr)
    xm, zm, mr, mi = mul_single(x, z, cr, ci, xr, zr)
    ka, kb = cuda.row_signature(torch.cat([x, xm]), torch.cat([z, zm]))
    # -i sin(t) * (mr + i mi): the exact i^3 swap, then the scale by sin
    pr = torch.cat([torch.where(ac, cr * cos_t, cr), mi * sin_t])
    pi = torch.cat([torch.where(ac, ci * cos_t, ci), -mr * sin_t])
    return ka, kb, pr, pi, torch.cat([torch.ones_like(ac), ac])


def rotate_nonclifford_cleanup(x, z, cr, ci, xr, zr, cos_t: float, sin_t: float,
                               zero_threshold: Optional[float] = None) -> Planes:
    """Conjugation by e^{i t/2 Q} for a non-Clifford angle t, then cleanup.

    Commuting terms are untouched; each anticommuting term P becomes
    cos(t) P + sin(t) (-i P Q).  K6 gives the 2T slots' signatures,
    coefficients and live flags without the rotated rows (one launch on a
    card), K3 merges the live slots (_merge_sorted: one block, or after
    K17's sort) and rebuilds the survivors' rows from
    the rotation's row source (jx_core.rotate_nonclifford_cleanup's
    row_source)."""
    rows = tuple(t.contiguous() for t in (x, z, xr, zr))
    ka, kb, pr, pi, live = cuda.rotation_rows(rows[0], rows[1], cr.contiguous(),
                                              ci.contiguous(), rows[2], rows[3], cos_t, sin_t)
    return _merge_sorted(ka, kb, pr, pi, zero_threshold, rows, live)[:4]


def project_rows(x, z, cr, ci, ac, neg_x, neg_z, col_keep):
    """(ka, kb, pr, pi, live) of a stabilizer-subspace projection's T slots:
    live where the term commutes with every rotated stabilizer (no entry of
    ac's row set), the signature of the row with the stabilized columns
    zeroed (x & col_keep, z & col_keep), the coefficient times the
    eigenvalue sign flip (-1 where popc(x & neg_x) + popc(z & neg_z) is
    odd).

    Plain version of the ``project_rows`` CUDA kernel
    (``csrc/project_rows.cu``), which never writes the masked rows."""
    flip = (
        1 - 2 * ((parity_and(x, neg_x[None, :]) + parity_and(z, neg_z[None, :])) & 1)
    ).to(cr.dtype)
    ka, kb = cuda.row_signature(x & col_keep[None, :], z & col_keep[None, :])
    return ka, kb, cr * flip, ci * flip, ~ac.any(dim=1)


def clifford_project_cleanup(x, z, cr, ci, rx, rz, rm, stab_x, stab_z,
                             neg_x, neg_z, col_keep,
                             zero_threshold: Optional[float]) -> Planes:
    """Fused stabilizer-subspace projection (jx_core.clifford_project_cleanup).

    Clifford rotation scan (K5), the anticommutation of every term with
    every rotated (single-qubit) stabilizer (K1), then K7: the terms that
    anticommute with any are flagged dead, the eigenvalue sign flips, the
    stabilized columns' zeroing and the signatures, without the filtered
    rows; K3 merges the live rows (_merge_sorted: one block, or after K17's
    sort) and rebuilds the survivors' masked rows.

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
    rows = (x.contiguous(), z.contiguous(), col_keep.contiguous())
    ac = cuda.anticommutes(rows[0], rows[1], stab_x.contiguous(), stab_z.contiguous())
    ka, kb, pr, pi, live = cuda.project_rows(rows[0], rows[1], cr.contiguous(), ci.contiguous(),
                                             ac, neg_x.contiguous(), neg_z.contiguous(), rows[2])
    return _merge_sorted(ka, kb, pr, pi, zero_threshold, rows, live)[:4]


def expval_iz_sum(x, cr, ci) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum of the coefficients of the I/Z-only terms: <0...0| O |0...0>."""
    diag = ~(x != 0).any(dim=1)
    zero = torch.zeros((), dtype=cr.dtype, device=cr.device)
    return torch.where(diag, cr, zero).sum(), torch.where(diag, ci, zero).sum()
