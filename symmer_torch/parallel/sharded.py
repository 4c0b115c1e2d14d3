"""Host-boundary drivers of the mesh-sharded operator kernels.

Counterpart of ``symmer_tpu/parallel/sharded.py``.  ``kernels.dispatch``
routes through these when ``config.mesh`` is set (``symmer_torch.use_mesh``)
and the operator is large enough: host uint64 planes and complex
coefficients in, the same out, with the term axis split over the mesh in
between and never gathered on a device (parallel/distributed.py).  An
overflow of the exchange's buffers is detected, retried at a larger
capacity where symmer_tpu retries, and finally returns None, so that the
caller runs its single-device path: the result is the same either way.

The output is shard-major (each shard's rows in turn), and a term's shard
follows the port's row signature: the term set and the coefficients (within
rounding: the merge adds partial sums in another order) are those of the
single-device path, the order of the terms is not.

Coefficients are float64 (symmer_tpu's float32 threshold floor is 0 there,
so the threshold is the plain one; its double-float planes are not ported).
"""
from __future__ import annotations

import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import cuda, torch_core, torch_state
from ..kernels.rotations import projection_prep, segment_rotations
from . import distributed
from .mesh import Mesh, on_device, replicate

Planes = Tuple[np.ndarray, np.ndarray, np.ndarray]


def _usable(mesh: Mesh) -> bool:
    """The exchange needs a power-of-two mesh of at least 2 shards; anything
    else falls back to the single-device path (None upstream)."""
    n = mesh.size
    return n >= 2 and not (n & (n - 1))


def _split(T: int, n_dev: int):
    """(rows a shard, valid rows of each shard) of T terms in n_dev parts."""
    L = -(-T // n_dev)
    return L, [min(max(T - L * s, 0), L) for s in range(n_dev)]


def _upload(x, z, c, mesh: Mesh):
    """Host planes -> per-shard device tensors of each shard's rows (shard s
    the rows [s L, s L + n_s)), and the counts n_s."""
    L, ns = _split(x.shape[0], mesh.size)
    xs, zs, crs, cis = [], [], [], []
    for s, dev in enumerate(mesh.devices):
        rows = slice(s * L, s * L + ns[s])
        for out, a in ((xs, x), (zs, z)):
            out.append(torch.tensor(np.ascontiguousarray(a[rows], np.uint64).view(np.int64),
                                    device=dev))
        cs = np.asarray(c[rows], complex)
        crs.append(torch.tensor(np.ascontiguousarray(cs.real), dtype=torch.float64, device=dev))
        cis.append(torch.tensor(np.ascontiguousarray(cs.imag), dtype=torch.float64, device=dev))
    return xs, zs, crs, cis, ns


def _gather(xs, zs, crs, cis, ns) -> Planes:
    """Each shard's valid rows, shard after shard, as host planes; a fully
    cancelled operator keeps one explicit zero row."""
    W = xs[0].shape[1]
    x64 = np.concatenate([x[:n].cpu().numpy() for x, n in zip(xs, ns)]).view(np.uint64)
    z64 = np.concatenate([z[:n].cpu().numpy() for z, n in zip(zs, ns)]).view(np.uint64)
    c = np.concatenate([cr[:n].cpu().numpy() + 1j * ci[:n].cpu().numpy()
                        for cr, ci, n in zip(crs, cis, ns)])
    if len(c) == 0:
        x64 = np.zeros((1, W or 1), np.uint64)
        z64 = np.zeros_like(x64)
        c = np.zeros(1, complex)
    return x64, z64, c


def _rows(a, mesh: Mesh):
    """uint64 host rows -> int64 tensors, one per shard (replicated)."""
    return replicate(np.ascontiguousarray(a, np.uint64).view(np.int64), mesh)


def cleanup(x, z, c, zero_threshold, mesh: Mesh) -> Optional[Planes]:
    """Mesh-sharded deduplication of host planes; None: the caller falls back."""
    if not _usable(mesh):
        return None
    th = zero_threshold if zero_threshold is not None else 0.0
    shards = _upload(x, z, c, mesh)
    for capacity_factor in (2, 4):
        *out, ns, overflow = distributed.distributed_cleanup(
            *shards, mesh, zero_threshold=th, capacity_factor=capacity_factor)
        if not any(overflow):
            return _gather(*out, ns)
    return None


def multiply_cleanup(x1, z1, c1, x2, z2, c2, zero_threshold,
                     mesh: Mesh) -> Optional[Planes]:
    """Mesh-sharded (op1 * op2).cleanup() of host planes; None: fall back."""
    if not _usable(mesh):
        return None
    x1s, z1s, cr1s, ci1s, _ = _upload(x1, z1, c1, mesh)
    c2 = np.asarray(c2, complex)
    op2 = (_rows(x2, mesh), _rows(z2, mesh), replicate(np.ascontiguousarray(c2.real), mesh),
           replicate(np.ascontiguousarray(c2.imag), mesh))
    *out, ns, overflow = distributed.distributed_multiply_cleanup(
        x1s, z1s, cr1s, ci1s, *op2, mesh, zero_threshold)
    if any(overflow):
        return None
    return _gather(*out, ns)


def perform_rotations(x, z, c, rotations: Sequence[Tuple[np.ndarray, np.ndarray, Optional[float]]],
                      zero_threshold, mesh: Mesh) -> Optional[Planes]:
    """Mesh-sharded rotation sequence: one upload, one download, at a
    capacity of twice a shard's rows (one try, as symmer_tpu's).

    Each Clifford run is one local scan a shard; each non-Clifford rotation
    rotates every shard, exchanges and merges (at twice the capacity) and
    must fit the capacity again; a final cleanup merges the result.
    zero_threshold None is 0.0 here, as in symmer_tpu's mesh driver (exact
    zeros dropped).  Overflow anywhere: None (the caller falls back)."""
    if not _usable(mesh):
        return None
    th = float(zero_threshold) if zero_threshold is not None else 0.0
    xs, zs, crs, cis, ns = _upload(x, z, c, mesh)
    C = 2 * max(1, -(-x.shape[0] // mesh.size))
    for seg in segment_rotations(rotations):
        if seg[0] == "clifford":
            _, rx, rz, ms = seg
            xs, zs, crs, cis = distributed.distributed_clifford_run(
                xs, zs, crs, cis, ns, _rows(rx, mesh), _rows(rz, mesh),
                replicate(np.asarray(ms, np.int64), mesh), mesh)
            continue
        _, xr, zr, angle = seg
        a = complex(angle).real
        *planes, ns, overflow = distributed.distributed_rotate_nonclifford(
            xs, zs, crs, cis, ns, [t[0] for t in _rows(xr.reshape(1, -1), mesh)],
            [t[0] for t in _rows(zr.reshape(1, -1), mesh)],
            float(np.cos(a)), float(np.sin(a)), mesh, th, C)
        if any(overflow):
            return None
        xs, zs, crs, cis = planes
    *out, ns, overflow = distributed.exchange_merge(xs, zs, crs, cis, ns, mesh, C, th)
    if any(overflow):
        return None
    return _gather(*out, ns)


def clifford_rotate_project(x, z, c, rotations, stab_x, stab_z, stab_signs,
                            free_qubit_mask: np.ndarray, zero_threshold: float,
                            mesh: Mesh) -> Optional[Planes]:
    """Mesh-sharded fused projection (taper / CS-VQE): Clifford rotations,
    stabilizer filter, sign flips, column masking and the cross-shard merge
    in one upload and one download.  None: the caller runs the
    single-device fused path."""
    if not _usable(mesh):
        return None
    rx, rz, ms, neg_x, neg_z, col_keep = projection_prep(
        rotations, stab_x, stab_z, stab_signs, free_qubit_mask, x.shape[1])
    th = float(zero_threshold) if zero_threshold is not None else 0.0
    rep = (_rows(rx, mesh), _rows(rz, mesh), replicate(ms, mesh), _rows(stab_x, mesh),
           _rows(stab_z, mesh), *(_rows(v, mesh) for v in (neg_x, neg_z, col_keep)))
    shards = _upload(x, z, c, mesh)
    for capacity_factor in (2, 4):
        *out, ns, overflow = distributed.distributed_clifford_project(
            *shards, *rep, mesh, th, capacity_factor=capacity_factor)
        if not any(overflow):
            return _gather(*out, ns)
    return None


def expval(x, z, c, s_pack, amps, mesh: Mesh) -> Optional[complex]:
    """Mesh-sharded <psi|O|psi>: the terms split over the shards, the state
    on every shard's device (deduplicated once a device), one ``expval``
    launch a shard, and the partial (re, im) summed in float64 in shard
    order on the first shard's device (symmer_tpu's psum).  A reduction, no
    exchange: any mesh of at least 2 shards.  None for a smaller mesh, or
    when the state's copies would pass 1 GiB (a warning; the single-device
    path holds one)."""
    n_dev = mesh.size
    if n_dev < 2:
        return None
    state_bytes = s_pack.nbytes + 2 * np.asarray(amps).nbytes
    if state_bytes * n_dev > (1 << 30):
        warnings.warn(
            f"mesh expval skipped: replicating a {state_bytes >> 20} MiB state "
            f"across {n_dev} devices; using the single-device path")
        return None
    xs, zs, crs, cis, _ = _upload(x, z, c, mesh)
    amps = np.asarray(amps, complex)
    states = {}
    for dev in mesh.devices:
        if dev not in states:
            with on_device(dev):
                states[dev] = torch_state.cleanup_state(
                    torch.tensor(np.ascontiguousarray(s_pack, np.uint64).view(np.int64),
                                 device=dev),
                    torch.tensor(np.ascontiguousarray(amps.real), device=dev),
                    torch.tensor(np.ascontiguousarray(amps.imag), device=dev))
    parts = []
    for s, dev in enumerate(mesh.devices):
        with on_device(dev):
            parts.append(torch.stack(cuda.expval(xs[s], zs[s], crs[s], cis[s], *states[dev])))
    first = mesh.devices[0]
    total = parts[0].to(first)
    for p in parts[1:]:
        total = total + p.to(first)
    re, im = total.tolist()
    return complex(re, im)


def distributed_wide_multiply(left, right, mesh: Optional[Mesh] = None):
    """Single-term Pauli product with the packed word axis split over the
    mesh (the qubit-axis regime: two 100,000,000-qubit single terms, symmer
    README.md:54).  Each shard XORs its words and counts its share of the
    phase's three popcounts (Y counts in and out, x1 . z2); the counts are
    summed in shard order.  Returns a PauliwordOp equal to the host product,
    None when no mesh is given or configured; raises ValueError for
    operands that are not single terms of one width."""
    from ..config import config
    from ..operators.base import PauliwordOp

    mesh = config.mesh if mesh is None else mesh
    if mesh is None:
        return None
    _single_terms(left, right, "distributed_wide_multiply handles single-term operands; use "
                               "the term-sharded product for many-term operators")
    words = _word_shards(left, right, mesh)
    xo, zo, total = [], [], np.zeros(3, np.int64)
    for dev, (x1, z1, x2, z2) in zip(mesh.devices, words):
        with on_device(dev):
            xs, zs = x1 ^ x2, z1 ^ z2
            pc = torch_core.popcount
            counts = torch.stack([pc(x1 & z1).sum() + pc(x2 & z2).sum(), pc(xs & zs).sum(),
                                  pc(x1 & z2).sum()])
            xo.append(xs.cpu())
            zo.append(zs.cpu())
            total += np.asarray(counts.tolist(), np.int64)
    W = left.x_pack.shape[1]
    k = int(3 * total[0] + total[1]) % 4
    phase = (1, 1j, -1, -1j)[k] * (1 - 2 * int(total[2] & 1))
    return PauliwordOp.from_planes(
        torch.cat(xo).numpy()[:W].view(np.uint64)[None, :],
        torch.cat(zo).numpy()[:W].view(np.uint64)[None, :],
        np.array([left.coeff_vec[0] * right.coeff_vec[0] * phase], complex),
        left.n_qubits,
    )


def distributed_wide_commutes(left, right, mesh: Optional[Mesh] = None) -> Optional[bool]:
    """Do two ultra-wide single-term Paulis commute?  parity(x1 . z2) ==
    parity(z1 . x2), each shard counting its words' share; None when no
    mesh is given or configured."""
    from ..config import config

    mesh = config.mesh if mesh is None else mesh
    if mesh is None:
        return None
    _single_terms(left, right, "distributed_wide_commutes handles single terms")
    total = 0
    for dev, (x1, z1, x2, z2) in zip(mesh.devices, _word_shards(left, right, mesh)):
        with on_device(dev):
            pc = torch_core.popcount
            total += int((pc(x1 & z2).sum() + pc(z1 & x2).sum()).item())
    return total % 2 == 0


def _single_terms(left, right, message: str) -> None:
    if left.n_terms != 1 or right.n_terms != 1:
        raise ValueError(message)
    if left.n_qubits != right.n_qubits:
        raise ValueError(
            f"operand widths differ ({left.n_qubits} vs {right.n_qubits} qubits); "
            "tensor-pad to a common width first")


def _word_shards(left, right, mesh: Mesh):
    """The four planes of two single terms cut along the word axis, one
    (x1, z1, x2, z2) of int64 words a shard, zero-padded to equal parts."""
    planes = [_shard_words(p[0], mesh)
              for p in (left.x_pack, left.z_pack, right.x_pack, right.z_pack)]
    return list(zip(*planes))


def _shard_words(words: np.ndarray, mesh: Mesh):
    from .mesh import shard_terms

    return shard_terms(np.ascontiguousarray(words, np.uint64).view(np.int64), mesh)
