"""The noncontextual brute-force ground-state search on the device.

Counterpart of ``symmer_tpu/kernels/jx_noncon.py`` (single device).  The
classical objective (operators/noncontextual_op.py) is

    E(nu) = s0(nu) - || s_i(nu) ||_2,   s0 = sum over S0 terms of
    base_m * (-1)^{parity_m(nu)},   s_i = the same sum over clique i's terms,

minimised over all 2^n_free assignments of the free generators.  A term of a
noncontextual operator has at most one clique factor, so the terms split
into segments: S0 first, then each clique.  The kernel's inputs per term
(``kernel_inputs``):

  - ``gmask`` (int64 holding 32 bits): bit ``n_free - 1 - j`` set when free
    generator j divides the term, bit 31 its fixed-assignment parity;
  - ``base`` (float64): Re(coeff * pauli_mult_sign);
  - ``seg_off`` (int64[n_cliques + 2]): segment boundaries of the terms,
    which are ordered S0, clique 0, clique 1, ...

Enumeration order equals the host path's (``itertools.product([-1, 1],
repeat=n_free)``): index k's bit ``n_free - 1 - j`` is generator j's grid
value, ``nu_j = 2 grid - 1``, so nu_j = -1 where that bit is clear.  The
parity of term m is then popc(kk & gmask_m) & 1 with
kk = (~k & (2^n_free - 1)) | 2^31: an exact popcount, where jx_noncon needed
a float parity matmul at HIGHEST precision.

``brute_force_plain`` is the plain version of the ``brute_force_minimise``
CUDA kernel (``csrc/noncon_brute.cu``), chunked torch in float64.

The kernel computes each segment's sums over all assignments as a split
Walsh-Hadamard transform.  With F_m = gmask_m's free bits,
popc(kk & gmask_m) = bit31_m + popc(F_m) - popc(k & F_m), so

    (-1)^{parity_m(k)} base_m = b'_m (-1)^{popc(F_m & k)},
    b'_m = (-1)^{bit31_m + popc(F_m)} base_m,

and a segment's sum s(k) = sum_m b'_m (-1)^{popc(F_m & k)} is a plain
Walsh-Hadamard transform in k itself.  The kernel folds the signs, buckets
the terms by the low ``n_lo`` bits of F (n_lo = min(n_free, MAX_SPLIT)) and
lets one block take one value of k's high bits at a time.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import torch_core

FIXED_BIT = 31
# the kernel's split: 2^n_lo assignments per block, n_lo = min(n_free,
# MAX_SPLIT) (on an H100 the widest split was the fastest at 2^14-2^28
# assignments; PERF.md)
MAX_SPLIT = 11


def kernel_inputs(F_free, fixed_parity, base, mS0, mCi, device):
    """(gmask, base, seg_off, n_cliques) on ``device`` from jx_noncon's
    arguments, terms reordered by segment (S0, clique 0, ...).

    Raises ValueError if a term carries more than one clique factor or the
    S0 mask is not the complement of the clique masks."""
    F = np.asarray(F_free, dtype=np.int64).reshape(len(base), -1)
    n_free = F.shape[1]
    if not 1 <= n_free <= 31:
        raise ValueError(f"free assignment count {n_free} not in [1, 31]")
    mCi = np.asarray(mCi, dtype=np.float64).reshape(-1, len(base))
    n_cliques = mCi.shape[0]
    in_clique = mCi != 0
    per_term = in_clique.sum(axis=0)
    if np.any(per_term > 1):
        raise ValueError(
            f"{int(np.sum(per_term > 1))} terms carry more than one clique factor"
        )
    if not np.array_equal(np.asarray(mS0) != 0, per_term == 0):
        raise ValueError("the S0 mask is not the complement of the clique masks")
    clique = (
        np.where(per_term == 0, -1, np.argmax(in_clique, axis=0))
        if n_cliques else np.full(len(base), -1)
    )
    order = np.argsort(clique, kind="stable")
    weights = np.int64(1) << np.arange(n_free - 1, -1, -1, dtype=np.int64)
    gmask = (F @ weights) | (np.asarray(fixed_parity, np.int64).reshape(-1) % 2 << FIXED_BIT)
    seg_off = np.searchsorted(clique[order], np.arange(-1, n_cliques + 1), side="left")
    to = lambda a, dt: torch.tensor(np.ascontiguousarray(a), dtype=dt, device=device)
    return (
        to(gmask[order], torch.int64),
        to(np.asarray(base, np.float64)[order], torch.float64),
        to(seg_off, torch.int64),
        n_cliques,
    )


def brute_force_plain(gmask, base, seg_off, n_free: int, n_cliques: int,
                      chunk: int = None, start: int = 0,
                      stop: int = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min energy, argmin index) over the assignments start .. stop - 1
    (default all) as 0-d tensors; ties go to the smaller index.  Plain
    version of the ``brute_force_minimise`` CUDA kernel: the same parities,
    then the segment sums as one float64 product with a 0/1 segment matrix;
    the chunks of assignments start at multiples of ``chunk``, whatever the
    range."""
    dev = base.device
    M = base.shape[0]
    search = 1 << n_free
    if stop is None:
        stop = search
    if chunk is None:
        chunk = max(1, min(search, (1 << 24) // max(M, 1)))
    seg = torch.zeros((M, n_cliques + 1), dtype=torch.float64, device=dev)
    bounds = seg_off.tolist()
    for i in range(n_cliques + 1):
        seg[bounds[i]:bounds[i + 1], i] = 1.0
    full = (1 << n_free) - 1
    best_e = torch.full((), float("inf"), dtype=torch.float64, device=dev)
    best_k = torch.zeros((), dtype=torch.int64, device=dev)
    for c0 in range(start - start % chunk, stop, chunk):
        k = torch.arange(max(start, c0), min(stop, c0 + chunk), dtype=torch.int64, device=dev)
        kk = ((~k) & full) | (1 << FIXED_BIT)
        par = torch_core.parity64(kk[:, None] & gmask[None, :])
        signed = (1 - 2 * par).to(torch.float64) * base[None, :]
        sums = signed @ seg  # (chunk, 1 + n_cliques)
        E = sums[:, 0] - torch.sqrt((sums[:, 1:] * sums[:, 1:]).sum(dim=1))
        j = torch.argmin(E)  # first minimum: the smallest index of the chunk
        better = E[j] < best_e  # earlier chunks hold smaller indices
        best_e = torch.where(better, E[j], best_e)
        best_k = torch.where(better, k[j], best_k)
    return best_e, best_k


def direct_segment(n_terms: int, n_lo: int) -> bool:
    """The kernel sums a segment this small term by term (a popcount, at a
    quarter of the float64 add rate, and an add a term) instead of
    bucketing and transforming it (n_lo adds an assignment); an empty
    segment sums to 0."""
    return 4 * n_terms <= n_lo


def brute_force_minimise(F_free, fixed_parity, base, mS0, mCi, n_free: int,
                         device, mesh=None) -> Tuple[float, int]:
    """Minimise E over all 2**n_free assignments; returns (best energy, best
    enumeration index).  Arguments as jx_noncon.brute_force_minimise's:
    F_free {0,1}[M, n_free], fixed_parity {0,1}[M], base float[M], mS0
    float[M], mCi float[n_cliques, M].

    One search on ``device``, or, with a mesh of several shards
    (parallel.mesh.Mesh), the assignments split into contiguous ranges, one
    launch per shard on its device, and the minimum of the shards' minima
    (ties to the smaller index, as jx_noncon's pmin pair): bit for bit the
    one-device search."""
    from ..parallel.mesh import check_devices, on_device
    from . import cuda

    if np.asarray(F_free).reshape(len(base), -1).shape[1] != n_free:
        raise ValueError(f"F_free has not {n_free} free columns")
    devices = (torch.device(device),)
    if mesh is not None and mesh.size > 1:
        check_devices(mesh, devices[0])
        devices = mesh.devices
    inputs = {}  # one copy of the inputs per device
    search, parts = 1 << n_free, []
    for s, dev in enumerate(devices):
        lo, hi = s * search // len(devices), (s + 1) * search // len(devices)
        if lo == hi:
            continue
        if dev not in inputs:
            inputs[dev] = kernel_inputs(F_free, fixed_parity, base, mS0, mCi, dev)
        gmask, b, seg_off, n_cliques = inputs[dev]
        with on_device(dev):
            parts.append(cuda.brute_force_minimise(gmask, b, seg_off, n_free, n_cliques,
                                                   start=lo, stop=hi))
    return min((float(e), int(k)) for e, k in parts)


def nu_from_index(index: int, n_free: int) -> np.ndarray:
    """Free-entry nu vector for an enumeration index."""
    grid = (index >> np.arange(n_free - 1, -1, -1)) & 1
    return 2 * grid - 1
