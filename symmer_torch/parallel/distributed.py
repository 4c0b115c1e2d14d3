"""Term deduplication over a device mesh, the term axis never gathered.

Counterpart of ``symmer_tpu/parallel/distributed.py``.  An operator on a
mesh (parallel/mesh.py) is a list of per-shard tensors, each on its shard's
device: planes ``x, z`` (int64[C, W]), coefficients ``cr, ci`` (float64[C])
and a valid-row count per shard, the shard's rows first and the rest of its
fixed capacity ``C`` unused.  One process runs each shard's step on that
shard's device in turn, with the port's kernels, then the exchange:

1. ``log2(N)`` rounds of pairwise hash-routed exchange.  In round ``k`` each
   shard merges its duplicate rows (torch_core.cleanup_keyed, which also
   gives each row its routing key ``ka``), keeps the rows whose key bit
   ``k`` equals bit ``k`` of its own index and sends the rest to the partner
   ``s ^ (1 << k)``: the keep/send split is the ``route_rows`` kernel
   (K16, csrc/route_rows.cu), a stable partition of the rows into the
   front of the shard's own buffer and into its send buffer.  The send
   buffers are then swapped: shard s appends its partner's sent rows after
   its kept ones, a copy (between two cards a peer copy, ordered after the
   partner's partition on its stream), and no shard's buffer is both read
   and written in one swap.  After the rounds every row sits on the shard
   addressed by the low ``log2(N)`` bits of its key, so all duplicates of
   a term are on one shard.
2. A local cleanup per shard merges them and applies the threshold.

Bit k of ``ka`` is bit k of the signature's lane 1 (k < 32), so which shard
holds a term differs from symmer_tpu's (another hash); the term set does
not.  Rows are merged before every round, so a shard holds at most one
copy of a term and one incoming copy: only more distinct terms than ``C``
routed to one shard overflow.  An overflow is flagged per shard (rows past
``C`` are not kept) and the drivers (parallel/sharded.py) retry at a larger
capacity or return None; nothing is dropped silently.

Coefficients are float64: symmer_tpu's relative threshold floor and its
double-float planes exist for float32 devices and are not ported.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..kernels import cuda, torch_core
from .mesh import Mesh, on_device


def _n_rounds(mesh: Mesh) -> int:
    n = mesh.size
    if n & (n - 1):
        raise ValueError(f"mesh size must be a power of two, got {n}")
    return n.bit_length() - 1


def _buffers(rows: int, W: int, dev: torch.device):
    x = torch.empty((rows, W), dtype=torch.int64, device=dev)
    c = torch.empty((2, rows), dtype=torch.float64, device=dev)
    return x, torch.empty_like(x), c[0], c[1]


def exchange_merge(xs, zs, crs, cis, ns: Sequence[int], mesh: Mesh, capacity: int,
                   zero_threshold: Optional[float]):
    """Route every row to its home shard, then merge each shard's rows.

    xs, zs, crs, cis: one tensor per shard, on the shard's device, its first
    ns[s] rows valid (ns[s] <= capacity); they are only read.  Returns
    (xs, zs, crs, cis, ns, overflow): new buffers of ``capacity`` rows per
    shard, their first ns[s] rows the unique terms routed to shard s (those
    with |c| > zero_threshold; None keeps exact zeros), and a flag per shard
    set when more rows than ``capacity`` met there in a round (its result is
    then incomplete)."""
    n_rounds = _n_rounds(mesh)
    devs = mesh.devices
    if len(xs) != len(devs) or any(n > capacity for n in ns):
        raise ValueError(f"{len(xs)} shards of {list(ns)} rows for a mesh of {len(devs)} "
                         f"at capacity {capacity}")
    W = xs[0].shape[1]
    own = [_buffers(capacity, W, d) for d in devs]
    send = [_buffers(capacity, W, d) for d in devs] if n_rounds else None
    cur = [tuple(a[s][:ns[s]] for a in (xs, zs, crs, cis)) for s in range(len(devs))]
    overflow = [False] * len(devs)
    for k in range(n_rounds):
        counts = []
        for s, dev in enumerate(devs):
            with on_device(dev):
                *rows, key = torch_core.cleanup_keyed(*cur[s])
                counts.append(cuda.route_rows(*rows, key, k, (s >> k) & 1, own[s], send[s]))
        counts = [c.tolist() for c in counts]
        for s, dev in enumerate(devs):
            kept, recv = counts[s][0], counts[s ^ (1 << k)][1]
            m = min(recv, capacity - kept)
            overflow[s] |= kept + recv > capacity
            with on_device(dev):
                for dst, src in zip(own[s], send[s ^ (1 << k)]):
                    dst[kept:kept + m].copy_(src[:m], non_blocking=True)
            cur[s] = tuple(a[:kept + m] for a in own[s])
    n_out = []
    for s, dev in enumerate(devs):
        with on_device(dev):
            merged = torch_core.cleanup_sorted(*cur[s], zero_threshold)
            n = merged[0].shape[0]
            for dst, src in zip(own[s], merged):
                dst[:n].copy_(src)
        n_out.append(n)
    return (*([b[i] for b in own] for i in range(4)), n_out, overflow)


def distributed_cleanup(xs, zs, crs, cis, n_valid_per_shard: Sequence[int], mesh: Mesh,
                        zero_threshold: Optional[float] = None, capacity_factor: int = 2):
    """Deduplicate a term-sharded operator without gathering the term axis.

    xs, zs (int64[T_local, W]) and crs, cis (float64[T_local]): one tensor
    per shard of a power-of-two mesh, shard s's first
    n_valid_per_shard[s] rows valid.  Each shard's buffer holds
    capacity_factor * T_local rows.  Returns (xs, zs, crs, cis, ns,
    overflow) as exchange_merge does: shard s holds the unique terms whose
    key's low bits equal s."""
    _n_rounds(mesh)
    T_local = max(x.shape[0] for x in xs)
    return exchange_merge(xs, zs, crs, cis, list(n_valid_per_shard), mesh,
                          capacity_factor * T_local, zero_threshold)


def distributed_multiply_cleanup(x1s, z1s, cr1s, ci1s, x2s, z2s, cr2s, ci2s, mesh: Mesh,
                                 zero_threshold: float):
    """(op1 * op2).cleanup() with op1's terms sharded (shard s's rows are all
    valid) and op2 replicated (one tensor per shard, parallel.mesh.replicate):
    each shard multiplies its slab (torch_core.mul_pairs_cleanup, merged
    without a threshold, since a term's coefficient may be split across
    shards), then the exchange merges duplicates across shards and applies
    the threshold once.  A shard's capacity is T1_local * T2 rows, its whole
    slab.  Returns (xs, zs, crs, cis, ns, overflow)."""
    assert zero_threshold is not None, "sharded multiply requires a threshold"
    _n_rounds(mesh)
    capacity = max(x.shape[0] for x in x1s) * x2s[0].shape[0]
    local = []
    for s, dev in enumerate(mesh.devices):
        with on_device(dev):
            local.append(torch_core.mul_pairs_cleanup(
                x1s[s], z1s[s], cr1s[s], ci1s[s], x2s[s], z2s[s], cr2s[s], ci2s[s], None))
    return exchange_merge(*([p[i] for p in local] for i in range(4)),
                          [p[0].shape[0] for p in local], mesh, capacity, zero_threshold)


def distributed_rotate_nonclifford(xs, zs, crs, cis, ns: Sequence[int], xr, zr,
                                   cos_t: float, sin_t: float, mesh: Mesh,
                                   zero_threshold: Optional[float], capacity: int):
    """One non-Clifford rotation of a sharded operator (symmer_tpu's
    ``_local_rotate_nc``): each shard rotates its rows
    (torch_core.rotate_nonclifford_cleanup, merged without a threshold; at
    most twice its rows), the exchange runs at twice ``capacity`` and
    applies the threshold, and a shard left with more than ``capacity``
    rows is flagged.  xr, zr: the rotation's planes, one tensor per shard
    (parallel.mesh.replicate).  Returns (xs, zs, crs, cis, ns, overflow)."""
    local = []
    for s, dev in enumerate(mesh.devices):
        with on_device(dev):
            local.append(torch_core.rotate_nonclifford_cleanup(
                xs[s][:ns[s]], zs[s][:ns[s]], crs[s][:ns[s]], cis[s][:ns[s]], xr[s], zr[s],
                cos_t, sin_t, None))
    *planes, n_out, overflow = exchange_merge(
        *([p[i] for p in local] for i in range(4)), [p[0].shape[0] for p in local], mesh,
        2 * capacity, zero_threshold)
    overflow = [o or n > capacity for o, n in zip(overflow, n_out)]
    return (*([b[:capacity] for b in a] for a in planes), [min(n, capacity) for n in n_out],
            overflow)


def distributed_clifford_run(xs, zs, crs, cis, ns: Sequence[int], rx, rz, rm, mesh: Mesh):
    """A run of Clifford rotations on a sharded operator (symmer_tpu's
    ``_local_clifford``): one clifford_scan per shard on its valid rows, no
    exchange (a Clifford rotation maps distinct terms to distinct terms).
    rx, rz (int64[D, W]) and rm (int64[D]): one tensor per shard.  Returns
    (xs, zs, crs, cis), each shard's tensors of its ns[s] rows."""
    out = []
    for s, dev in enumerate(mesh.devices):
        with on_device(dev):
            out.append(cuda.clifford_scan(xs[s][:ns[s]], zs[s][:ns[s]], crs[s][:ns[s]],
                                          cis[s][:ns[s]], rx[s], rz[s], rm[s]))
    return tuple([p[i] for p in out] for i in range(4))


def distributed_clifford_project(xs, zs, crs, cis, n_valid_per_shard: Sequence[int],
                                 rx, rz, rm, stab_x, stab_z, neg_x, neg_z, col_keep,
                                 mesh: Mesh, zero_threshold: Optional[float],
                                 capacity_factor: int = 2):
    """The fused stabilizer-subspace projection with the term axis sharded
    (torch_core.clifford_project_cleanup's arguments; the rotation,
    stabilizer and mask tensors one per shard, parallel.mesh.replicate):
    each shard runs the Clifford scan, the stabilizer filter, the sign flips
    and the column mask and merges without a threshold; the exchange (at
    capacity_factor * T_local rows a shard) applies it once every duplicate
    is on one shard.  Returns (xs, zs, crs, cis, ns, overflow)."""
    _n_rounds(mesh)
    ns = list(n_valid_per_shard)
    capacity = capacity_factor * max(x.shape[0] for x in xs)
    local = []
    for s, dev in enumerate(mesh.devices):
        with on_device(dev):
            local.append(torch_core.clifford_project_cleanup(
                xs[s][:ns[s]], zs[s][:ns[s]], crs[s][:ns[s]], cis[s][:ns[s]], rx[s], rz[s],
                rm[s], stab_x[s], stab_z[s], neg_x[s], neg_z[s], col_keep[s], None))
    return exchange_merge(*([p[i] for p in local] for i in range(4)),
                          [p[0].shape[0] for p in local], mesh, capacity, zero_threshold)
