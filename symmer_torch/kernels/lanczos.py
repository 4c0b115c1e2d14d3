"""Lanczos eigensolvers on the card: exact ground and low-lying states.

The port of ``symmer_tpu/kernels/jx_lanczos.py``.  The operator is never a
matrix.  Terms sharing an X pattern couple the same (r, r ^ x) pairs, so

    H v = sum_g D[g] * v[r ^ ux[g]],
    D[g, r] = sum_{t in g} (-i)^{|Y_t|} c_t (-1)^{popcount(r & z_t)}

over the G distinct X patterns ux (tapered N2: 2,229 terms, G = 378).
``prepare_operator`` sorts the terms by group.  On a CUDA device every
matvec recomputes D from the terms (``cuda.group_matvec``) and no table
exists; on the CPU device the (G, 2^n) table is built once with the plain
build and read by the plain table matvec (``kernels/torch_lanczos.py``).
Each step of pass 1 of the scalar recurrence is then one
``cuda.lanczos_step`` launch, whose sums are pairwise trees in index order:
the recurrence does not depend on the CPU thread count.  Everything is
complex128 / float64.

Two passes: pass 1 runs the recurrence and keeps (alpha, beta) on the
device; they are read back once, the host solves the tridiagonal (scipy
``eigh_tridiagonal``) or the band matrix (``np.linalg.eigh``); pass 2
accumulates the Ritz vectors.  The scalar driver's pass 1 keeps its Krylov
basis v_0 .. v_k where ``keeps_basis`` admits it, and pass 2 is then one
``cuda.lanczos_ritz`` launch over it; otherwise pass 2 replays pass 1 bit
for bit from the stored scalars, a matvec and a ``cuda.lanczos_replay``
launch a step, with the same operations in the same order (the kernels are
deterministic).  Both routes give the same Ritz vectors bit for bit (the
band driver always replays).  Ghost Ritz values are removed, the Paige
residual is checked with up to two doubling retries, degenerate multiplets
are resolved by deflated restarts (``lanczos_lowest_eigsh``, deflation by
shifting: ``_deflate_shift``) or by the band recurrence
(``lanczos_block_eigsh``).  The start vectors come from numpy's
``default_rng(7)`` as in symmer_tpu.

With a mesh (``prepare_operator(..., mesh)``, ``config.mesh`` under
``symmer_torch.use_mesh`` for the public wrappers) the matvec's output rows
are split into one block a shard, as symmer_tpu splits its table's rows
(``_matvec_grouped_mesh_block``): shard s computes its rows from its own
copy of the whole vector on its device, and the blocks are gathered into
the result on the first shard's device, where the recurrence's vector
operations run.  Each row is bit for bit the one-device matvec's, so the
drivers' results are too.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from . import cuda, dense, torch_lanczos

# symmer_tpu's device budget for the diagonal table (jx_lanczos.py:54), its
# group block bytes (:56) and its host/device build threshold (:59): the
# MemoryError condition is computed with them as symmer_tpu computes it in
# float64, so the same operators raise in both packages
_D_BUDGET_BYTES = 2 << 30
_BLOCK_BYTES = 256 << 20
_DEVICE_BUILD_BYTES = 4 << 20


@dataclass(frozen=True)
class PreparedOperator:
    """The X-grouped form of an operator on the device."""

    ux: torch.Tensor   # int64[G], the distinct X patterns
    off: torch.Tensor  # int32[G + 1], group g's terms are off[g] .. off[g + 1] - 1
    z: torch.Tensor    # int32[T], the terms' Z patterns, sorted by group
    ph: torch.Tensor   # complex128[T], (-i)^{|Y_t|} c_t in the same order
    D: Optional[torch.Tensor]  # complex128[G, 2^n] on the CPU device; None on a card
    n_qubits: int
    nbytes: int        # device bytes of the fields here (what the port allocates)
    mesh: object = None  # parallel.mesh.Mesh of the row blocks, or None
    shards: Tuple = ()   # each shard's (ux, off, z, ph) on its device


def _block_shape(G: int, dim: int, L: int, itemsize: int):
    B = max(1, min(G, _BLOCK_BYTES // max(1, dim * L * itemsize)))
    nb = -(-G // B)
    return B, nb


def reference_table_bytes(G: int, n_qubits: int) -> int:
    """Device bytes that symmer_tpu's ``prepare_operator`` counts against
    its 2 GiB budget for G groups in float64 (jx_lanczos.py:1094-1106):
    re/im lanes of 8 bytes; above 4 MB the on-chip build pads the rows to a
    power of two and double-buffers the table."""
    dim = 1 << n_qubits
    L, itemsize = 2, 8
    table_bytes = G * dim * L * itemsize
    if table_bytes > _DEVICE_BUILD_BYTES:
        B_, nb_ = _block_shape(G, dim, L, itemsize)
        pad_rows = 1 << int(np.ceil(np.log2(max(1, nb_ * B_))))
        return 2 * pad_rows * dim * L * itemsize
    return table_bytes


def grouped_terms(ux, gidx, z_int, phase_c, device) -> Tuple[torch.Tensor, ...]:
    """(ux int64[G], off int32[G + 1], z int32[T], ph complex128[T]) on
    ``device``, K13's operands: ``dense.group_scatter_inputs``'s terms
    sorted by group, stably; group g's terms are off[g] .. off[g + 1] - 1."""
    as_dev = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)
    order = np.argsort(gidx, kind="stable")
    off = np.concatenate([[0], np.cumsum(np.bincount(gidx, minlength=ux.shape[0]))])
    return (as_dev(ux, torch.int64), as_dev(off, torch.int32),
            as_dev(z_int[order], torch.int32), as_dev(phase_c[order], torch.complex128))


def _mesh_ok(mesh, n_qubits: int) -> bool:
    """symmer_tpu's rule for a row-sharded matvec (jx_lanczos.py:317-323):
    a power of two of at least 2 shards that divides H = 2^(n // 2), the
    row axis its table is cut along."""
    if mesh is None:
        return False
    n_dev = mesh.size
    return n_dev >= 2 and n_dev & (n_dev - 1) == 0 and (1 << (n_qubits // 2)) % n_dev == 0


def prepare_operator(x, z, c, n_qubits: int, mesh=None) -> PreparedOperator:
    """The grouped terms on ``config.device``, once; pass the result to the
    solvers (``prepared=``) to reuse it across deflated sweeps and repeated
    solves.  On the CPU device the group-diagonal table is built here too,
    whole.

    ``mesh`` (a ``parallel.mesh.Mesh``) splits the matvec's rows over its
    shards when it passes symmer_tpu's ``_mesh_ok``, and is dropped (one
    device) otherwise, as in symmer_tpu; every shard gets its own copy of
    the grouped terms on its device, and the rest lives on the first
    shard's device.

    Raises MemoryError where symmer_tpu's does (``reference_table_bytes``
    over 2 GiB times the mesh's shards), whatever the card could hold: the
    reference's count decides the route (``QubitSubspaceManager``'s DMRG
    fallback)."""
    from ..config import config
    from ..parallel.mesh import check_devices

    dev = config.torch_device()
    if not _mesh_ok(mesh, n_qubits):
        mesh = None
    n_dev = mesh.size if mesh is not None else 1
    ux, gidx, z_int, phase_c = dense.group_scatter_inputs(x, z, c, n_qubits)
    G = ux.shape[0]
    counted = reference_table_bytes(G, n_qubits)
    if counted > _D_BUDGET_BYTES * n_dev:
        raise MemoryError(
            f"group-diagonal table ({counted >> 20} MiB as symmer_tpu counts it) "
            f"exceeds the budget of {n_dev} device(s); use exact_gs_energy_matrix_free "
            "for this size"
        )
    if mesh is not None:
        check_devices(mesh, dev)
        dev = mesh.devices[0]
    terms = grouped_terms(ux, gidx, z_int, phase_c, dev)
    nbytes = sum(t.numel() * t.element_size() for t in terms)
    shards = ()
    if mesh is not None:
        shards = tuple(tuple(t.to(d, copy=True) for t in terms) for d in mesh.devices)
        nbytes *= 1 + n_dev
    D = None
    if dev.type == "cpu":
        as_dev = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)
        D = cuda.build_group_diagonals(
            as_dev(gidx, torch.int64), as_dev(z_int, torch.int64),
            as_dev(phase_c, torch.complex128), G, n_qubits)
        nbytes += D.numel() * D.element_size()
    return PreparedOperator(*terms, D, n_qubits, nbytes, mesh, shards)


# -- vector operations -------------------------------------------------------

def _r(v: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(v)


def _scale(v, s):
    return torch.view_as_complex(_r(v) * s)


def _norm(v):
    return torch.sqrt(torch.vdot(v, v).real)


def _caxpy(v, sr, si, w):
    """w + (sr + i si) * v for real 0-d tensors sr, si."""
    return w + torch.complex(sr, si) * v


def _deflate_shift(w, v_in, locked, sigma: float):
    """w + sigma * sum_m y_m <y_m, v_in>: deflation by SHIFTING.

    ``locked``: (m, dim) orthonormal rows y_m; sigma above the spectral
    range of H.  A = H + sigma * sum y y^H moves each locked eigenvalue
    lambda to lambda + sigma, above the whole remaining spectrum, so the
    recurrence converges to the lowest eigenpair of the complement.  Plain
    projection (P H P) would park the locked space at eigenvalue 0, below
    a positive complement spectrum (symmer_tpu jx_lanczos.py:170-203).

    On a card, two cuBLAS products (deterministic launch to launch).  On the
    CPU, where a BLAS product's sums depend on the thread count, the re / im
    planes: the dots as pairwise trees, the rows added in the order m = 0,
    1, ...  On a card that version costs ~20 launches a deflated step: H2O's
    lowest four took 1,740 ms with it against 1,022 ms with cuBLAS (medians
    of three, NVIDIA H100 80GB HBM3 at 700 W, ``tools/ab_compare.py eigen``)."""
    if w.device.type != "cpu":
        coef = (locked.conj() @ v_in) * sigma
        return w + coef @ locked
    L, v = _r(locked), _r(v_in)
    dots = torch.stack([L[..., 0] * v[:, 0] + L[..., 1] * v[:, 1],
                        L[..., 0] * v[:, 1] - L[..., 1] * v[:, 0]])
    cre, cim = torch_lanczos.pairwise_sum(dots) * sigma           # (m,) each
    rows = torch.stack([cre[:, None] * L[..., 0] - cim[:, None] * L[..., 1],
                        cre[:, None] * L[..., 1] + cim[:, None] * L[..., 0]], dim=-1)
    acc = rows[0]
    for m in range(1, rows.shape[0]):
        acc = acc + rows[m]
    return torch.view_as_complex(_r(w) + acc)


def _matvec(prepared: PreparedOperator, V, out=None):
    """H @ V for a (b, dim) block: the recomputing kernel on a card, the
    table once built on the CPU device; over the row blocks of a mesh when
    the operator was prepared with one."""
    if prepared.mesh is not None:
        return _matvec_mesh(prepared, V, out)
    if prepared.D is not None:
        return torch_lanczos.group_matvec(prepared.ux, prepared.D, V)
    return cuda.group_matvec(prepared.ux, prepared.off, prepared.z, prepared.ph, V, out=out)


def _matvec_mesh(prepared: PreparedOperator, V, out=None):
    """H @ V over the mesh's row blocks, the counterpart of symmer_tpu's
    ``_matvec_grouped_mesh_block``: shard s computes rows [s dim / N,
    (s + 1) dim / N) on its device from its own copy of the whole V (the
    kernel with a row range on a card, the table's rows on the CPU device),
    and the N blocks are copied into the result on the first shard's device
    in shard order (its tiled all-gather).  No shard reads a buffer that
    another writes."""
    from ..parallel.mesh import on_device

    mesh = prepared.mesh
    b, dim = V.shape
    step = dim // mesh.size
    if out is None:
        out = torch.empty((b, dim), dtype=V.dtype, device=V.device)
    for s, (dev, terms) in enumerate(zip(mesh.devices, prepared.shards)):
        rows = (s * step, (s + 1) * step)
        with on_device(dev):
            Vs = torch.empty((b, dim), dtype=V.dtype, device=dev).copy_(V)
            if prepared.D is not None:
                blk = torch_lanczos.group_matvec(terms[0], prepared.D, Vs, rows)
            else:
                blk = cuda.group_matvec(*terms, Vs, rows=rows)
        out[:, rows[0]:rows[1]].copy_(blk)
    return out


def _to_dev(a: np.ndarray, dev) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.complex128, device=dev)


def _start_vector(seed: int, shape) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 0.25j * rng.standard_normal(shape)


# -- scalar Lanczos ----------------------------------------------------------

_CPU_BASIS_BYTES = 1 << 30


def keeps_basis(k: int, dim: int, dev: torch.device) -> bool:
    """Whether the scalar driver's pass 1 keeps its Krylov basis v_0 .. v_k,
    (k + 1) x dim complex128, for pass 2: within a quarter of the card's
    memory, or 1 GiB on the CPU device.  (Tapered N2's 377 vectors of 2^15
    rows take 198 MB, tapered MgH2's 425 of 2^17 0.89 GB.)  Otherwise pass 2
    replays pass 1, a matvec a step."""
    need = (k + 1) * dim * 16
    if dev.type == "cuda":
        return need <= torch.cuda.get_device_properties(dev).total_memory // 4
    return need <= _CPU_BASIS_BYTES


def lanczos_ground_state(
    x,
    z,
    c,
    n_qubits: int,
    k: int = 0,
    v0: Optional[np.ndarray] = None,
    n_eigs: int = 1,
    locked: Optional[np.ndarray] = None,
    prepared: Optional[PreparedOperator] = None,
    mesh=None,
    _retry: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Lowest distinct eigenvalues and eigenvectors of the packed operator.

    Returns (eigvals[n_eigs], eigvecs[dim, n_eigs]) as float64 / complex128,
    ascending, ghost Ritz duplicates removed.  ``k = 0`` picks
    ``min(dim, 16 + 24 * n_qubits)`` iterations, with up to two doubling
    retries while the Paige residual exceeds 1e-9 of the spectral scale; an
    explicit k only warns.  ``locked`` ((dim, m) orthonormal columns)
    deflates a converged subspace by shifting (``_deflate_shift``).
    ``prepared`` (``prepare_operator``) skips the table build and carries
    its mesh; otherwise ``mesh`` goes to ``prepare_operator``.
    """
    from scipy.linalg import eigh_tridiagonal

    from ..profiling import kernel_stats

    dim = 1 << n_qubits
    if _retry is None:
        _retry = 2 if k <= 0 else 0
    if k <= 0:
        k = min(dim, 16 + 24 * n_qubits)
    k = min(k, dim)
    if prepared is None:
        prepared = prepare_operator(x, z, c, n_qubits, mesh)
    dev = prepared.ux.device
    kernel_stats.record("lanczos_ground_state", True, prepared.mesh is not None)

    if v0 is None:
        v0 = _start_vector(7, dim)
    v0 = np.asarray(v0, complex).reshape(-1)
    locked_d = None
    if locked is not None:
        # start strictly inside the deflated complement (host float64)
        m_lock = int(locked.shape[1])
        v0 = v0 - locked @ (locked.conj().T @ v0)
        nrm0 = np.linalg.norm(v0)
        if nrm0 < 1e-8:
            v0 = _start_vector(11 + m_lock, dim)
            v0 = v0 - locked @ (locked.conj().T @ v0)
            nrm0 = np.linalg.norm(v0)
        v0 = v0 / nrm0
        locked_d = _to_dev(locked.T, dev)
    # sigma > spectral range (||H||_2 <= sum |c_t|)
    sigma = 2.0 * float(np.sum(np.abs(np.asarray(c, complex)))) + 1.0
    v0_d = _to_dev(v0, dev)
    v_start = _scale(v0_d, torch_lanczos.inv(torch_lanczos.norm(v0_d)))
    hv = torch.empty((1, dim), dtype=torch.complex128, device=dev)

    def start():
        """(v_prev, v_cur): a zero vector and the normalised start."""
        return torch.zeros_like(v_start), v_start.clone()

    def apply_op(v_cur):
        """(H + the deflation shift) @ v_cur."""
        w = _matvec(prepared, v_cur[None], out=hv)[0]
        if locked_d is not None:
            w = _deflate_shift(w, v_cur, locked_d, sigma)
        return w

    # ---- pass 1: the recurrence; alpha and beta stay on the device; each
    # step writes v_{j+1} into the basis's row j + 1, or over v_prev
    alphas = torch.zeros(k, dtype=torch.float64, device=dev)
    betas = torch.zeros(k, dtype=torch.float64, device=dev)
    basis = None
    if keeps_basis(k, dim, dev):
        basis = torch.empty((k + 1, dim), dtype=torch.complex128, device=dev)
        basis[0] = v_start
        rows = (torch.zeros_like(v_start), *basis.unbind(0))   # rows[j + 1] = v_j
        for j in range(k):
            cuda.lanczos_step(apply_op(rows[j + 1]), rows[j], rows[j + 1], rows[j + 2],
                              alphas, betas, j)
        del rows
    else:
        v_prev, v_cur = start()
        for j in range(k):
            cuda.lanczos_step(apply_op(v_cur), v_prev, v_cur, v_prev, alphas, betas, j)
            v_prev, v_cur = v_cur, v_prev
    al_host = alphas.cpu().numpy()
    be_host = betas.cpu().numpy()

    # truncate at breakdown (invariant subspace): beta == 0 decouples the tail
    k_eff = k
    brk = np.nonzero(be_host[: k - 1] == 0)[0]
    if brk.size:
        k_eff = int(brk[0]) + 1
    evals, evecs = eigh_tridiagonal(al_host[:k_eff], be_host[: k_eff - 1])

    # deduplicate ghosts, select the lowest n_eigs distinct Ritz values
    scale = max(np.max(np.abs(evals)), 1.0)
    sel = []
    for idx in np.argsort(evals):
        if all(abs(evals[idx] - evals[j]) > 1e-9 * scale for j in sel):
            sel.append(idx)
        if len(sel) >= n_eigs:
            break
    sel = np.asarray(sel, int)

    # Paige residual |H y_e - theta_e y_e| = |beta_{k_eff}| |S[-1, e]|
    resid = abs(be_host[k_eff - 1]) * np.abs(evecs[-1, sel])
    if k_eff < dim and np.any(resid > 1e-9 * scale):
        if _retry > 0 and k < dim:
            basis = None  # freed before the retry allocates its own
            return lanczos_ground_state(
                x, z, c, n_qubits, k=min(dim, 2 * k), v0=v0, n_eigs=n_eigs,
                locked=locked, prepared=prepared, _retry=_retry - 1,
            )
        import warnings

        warnings.warn(
            f"Lanczos residual {float(resid.max()):.2e} after k={k_eff} "
            "iterations exceeds 1e-9 of the spectral scale; the returned "
            "eigenpairs may be unconverged -- increase k"
        )

    # ---- pass 2: the Ritz vectors, from the kept basis or by replaying pass 1
    # from the stored scalars
    S_d = torch.as_tensor(np.ascontiguousarray(evecs[:, sel]), dtype=torch.float64, device=dev)
    if basis is not None:
        y = cuda.lanczos_ritz(basis, S_d, k_eff)
    else:
        v_prev, v_cur = start()
        y = torch.zeros((len(sel), dim), dtype=torch.complex128, device=dev)
        for j in range(k_eff):
            cuda.lanczos_replay(apply_op(v_cur), v_prev, v_cur, alphas, betas, j, S_d, y)
            v_prev, v_cur = v_cur, v_prev
    vec = y.cpu().numpy()
    nrm = np.linalg.norm(vec, axis=1, keepdims=True)
    nrm[nrm == 0] = 1.0
    return evals[sel], (vec / nrm).T


# -- block (band) Lanczos ----------------------------------------------------

def _block_qr_mgs(W):
    """Modified Gram-Schmidt QR of the b rows of W (b, dim).

    Returns (Q, Rre, Rim), R upper triangular with a real non-negative
    diagonal, as (b, b) float64 tensors.  A zero residual row (breakdown)
    gives a zero Q row and a zero R diagonal; the host truncates there."""
    b = W.shape[0]
    cols = list(W.unbind(0))
    Rre = torch.zeros((b, b), dtype=torch.float64, device=W.device)
    Rim = torch.zeros((b, b), dtype=torch.float64, device=W.device)
    for i in range(b):
        nrm = _norm(cols[i])
        q = _scale(cols[i], torch_lanczos.inv(nrm))
        Rre[i, i] = nrm
        for jc in range(i + 1, b):
            cij = torch.vdot(q, cols[jc])
            cols[jc] = _caxpy(q, -cij.real, -cij.imag, cols[jc])
            Rre[i, jc], Rim[i, jc] = cij.real, cij.imag
        cols[i] = q
    return torch.stack(cols), Rre, Rim


def _block_apply_inv_R(W, Rre, Rim):
    """Pass 2's V_next = W R^-1 by back-substitution in the order of
    ``_block_qr_mgs``: each stored R[l, i] is the coefficient that pass 1
    computed against the same running residual, so the rows are bitwise
    pass 1's."""
    out = []
    for i, w in enumerate(W.unbind(0)):
        for l in range(i):
            w = _caxpy(out[l], -Rre[l, i], -Rim[l, i], w)
        out.append(_scale(w, torch_lanczos.inv(Rre[i, i])))
    return torch.stack(out)


def lanczos_block_eigsh(
    x,
    z,
    c,
    n_qubits: int,
    n_vecs: int,
    block: Optional[int] = None,
    k: int = 0,
    v0: Optional[np.ndarray] = None,
    prepared: Optional[PreparedOperator] = None,
    mesh=None,
    _retry: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Lowest ``n_vecs`` eigenpairs WITH multiplicity by block (band) Lanczos.

    Block width ``min(n_vecs, 8)`` (or ``block``) rounded up to a power of
    two, so it divides dim = 2^n; multiplicities are resolved up to it.  The
    band recurrence W = H V_j - V_{j-1} B_{j-1}^H, A_j = V_j^H W,
    W -= V_j A_j, QR(W) -> (V_{j+1}, B_j) keeps A_j, B_j on the device; the
    host assembles the block-tridiagonal matrix and solves it densely, and
    a bitwise replay pass accumulates the Ritz vectors.  A diagonal of R
    below 1e-9 sum |c| (breakdown) truncates the band matrix there.  Only
    Ritz pairs whose residual ||H y - theta y|| is within 1e-9 of the
    spectral scale are kept, ghosts (copies of a converged eigenvector,
    with parallel Ritz vectors) dropped, with the scalar driver's doubling
    retries while fewer than n_vecs remain; symmer_tpu's block driver keeps
    the lowest Ritz pairs as they come and returns the ground energy
    several times on molecular Hamiltonians.  Fewer than n_vecs pairs come
    back when no retry is left (``exact_lowest_states_device`` then
    finishes with deflated restarts).  ``mesh`` as in
    ``lanczos_ground_state``.
    """
    from ..profiling import kernel_stats

    dim = 1 << n_qubits
    n_vecs = max(1, min(n_vecs, dim))
    b = int(block) if block else min(n_vecs, 8)
    b = max(1, min(b, dim))
    b = min(1 << int(np.ceil(np.log2(b))), dim)
    if _retry is None:
        _retry = 2 if k <= 0 else 0
    k_cap = max(1, dim // b)
    if k <= 0:
        k = min(k_cap, max(24, (16 + 24 * n_qubits) // b + 8))
    k = min(k, k_cap)
    if prepared is None:
        prepared = prepare_operator(x, z, c, n_qubits, mesh)
    dev = prepared.ux.device
    kernel_stats.record("lanczos_block_eigsh", True, prepared.mesh is not None)

    if v0 is None:
        V0 = _start_vector(7, (dim, b))
    else:
        V0 = np.asarray(v0, complex).reshape(dim, -1)
        if V0.shape[1] < b:
            V0 = np.concatenate([V0, _start_vector(7, (dim, b - V0.shape[1]))], axis=1)
    V0, _ = np.linalg.qr(V0)  # host float64 orthonormal start block
    V0_d = _to_dev(V0.T, dev)
    cplx = dict(dtype=torch.complex128, device=dev)

    # ---- pass 1: the band recurrence
    v_prev, v_cur = torch.zeros_like(V0_d), V0_d
    B_prev = torch.zeros((b, b), **cplx)
    As = torch.zeros((k, b, b), **cplx)
    Bs = torch.zeros((k, b, b), **cplx)
    for j in range(k):
        W = _matvec(prepared, v_cur) - B_prev.conj() @ v_prev
        A = v_cur.conj() @ W.T           # A[l, i] = <v_l, w_i>
        W = W - A.T @ v_cur
        v_next, Rre, Rim = _block_qr_mgs(W)
        B_prev = torch.complex(Rre, Rim)
        As[j], Bs[j] = A, B_prev
        v_prev, v_cur = v_cur, v_next
    A_h = As.cpu().numpy()
    B_h = Bs.cpu().numpy()

    # truncate at breakdown, relative to the operator scale (sum |c| >= ||H||)
    k_eff = k
    op_scale = max(float(np.sum(np.abs(np.asarray(c, complex)))), 1e-300)
    for j in range(k - 1):
        if np.any(np.abs(np.diagonal(B_h[j])) < 1e-9 * op_scale):
            k_eff = j + 1
            break

    n = k_eff * b
    T = np.zeros((n, n), complex)
    for j in range(k_eff):
        Aj = A_h[j]
        T[j * b:(j + 1) * b, j * b:(j + 1) * b] = (Aj + Aj.conj().T) / 2
        if j + 1 < k_eff:
            T[(j + 1) * b:(j + 2) * b, j * b:(j + 1) * b] = B_h[j]
            T[j * b:(j + 1) * b, (j + 1) * b:(j + 2) * b] = B_h[j].conj().T
    evals, S = np.linalg.eigh(T)
    scale = max(np.max(np.abs(evals)), 1.0)

    def ritz_vectors(cand):
        """Pass 2: replay pass 1 bitwise and accumulate the Ritz vectors of
        the columns ``cand`` of S, normalised, (len(cand), dim) on the device."""
        S_d = torch.as_tensor(S[:, cand].reshape(k_eff, b, len(cand)), **cplx)
        v_prev, v_cur = torch.zeros_like(V0_d), V0_d
        y = torch.zeros((len(cand), dim), **cplx)
        zero = torch.zeros((b, b), **cplx)
        for j in range(k_eff):
            y = y + S_d[j].T @ v_cur
            B_prev = Bs[j - 1] if j > 0 else zero
            W = _matvec(prepared, v_cur) - B_prev.conj() @ v_prev
            W = W - As[j].T @ v_cur
            v_prev, v_cur = v_cur, _block_apply_inv_R(W, Bs[j].real, Bs[j].imag)
        nrm = torch.linalg.vector_norm(y, dim=1, keepdim=True)
        return y / torch.where(nrm > 0, nrm, torch.ones_like(nrm))

    # Without reorthogonalisation the recurrence loses orthogonality as
    # eigenpairs converge: a converged eigenvector comes back as several
    # Ritz pairs (ghosts, whose Ritz vectors are parallel), where a true
    # multiplet's are orthogonal.  In ascending order: a Ritz vector with
    # half its weight or more in the span of those kept is a ghost and
    # skipped; any other is kept if its residual ||H y - theta y|| is within
    # 1e-9 of the spectral scale, and ends the scan if not (nothing above an
    # unconverged pair is trusted).  The candidates widen until n_vecs are
    # kept or the scan ends.
    n_want = min(n_vecs, n)
    n_cand = min(n, 2 * n_want)
    while True:
        Y = ritz_vectors(np.arange(n_cand))
        theta = torch.as_tensor(evals[:n_cand], dtype=torch.float64, device=dev)
        resid = torch.linalg.vector_norm(_matvec(prepared, Y) - theta[:, None] * Y, dim=1)
        resid, gram = resid.cpu().numpy(), (Y.conj() @ Y.T).cpu().numpy()
        keep, ended = [], False
        for i in range(n_cand):
            if keep and np.linalg.norm(gram[keep, i]) ** 2 >= 0.5:
                continue
            if resid[i] > 1e-9 * scale:
                ended = True
                break
            keep.append(i)
            if len(keep) == n_want:
                break
        if len(keep) == n_want or ended or n_cand == n:
            break
        n_cand = min(n, 2 * n_cand)
    if len(keep) < n_want and k_eff * b < dim:
        if _retry > 0 and k < k_cap:
            return lanczos_block_eigsh(
                x, z, c, n_qubits, n_vecs, block=b, k=min(k_cap, 2 * k), v0=V0,
                prepared=prepared, _retry=_retry - 1,
            )
        import warnings

        warnings.warn(
            f"block Lanczos: {len(keep)} of {n_want} eigenpairs within 1e-9 of the "
            f"spectral scale after k={k_eff} blocks; increase k"
        )
    # a kept vector can carry a trace of a ghost of its multiplet partner:
    # orthonormalise within each multiplet (the eigenspace is unchanged)
    vals, vec = evals[keep], Y[keep].cpu().numpy().T
    i = 0
    while i < len(vals):
        j = i + 1
        while j < len(vals) and vals[j] - vals[i] <= 1e-8 * scale:
            j += 1
        if j - i > 1:
            vec[:, i:j] = np.linalg.qr(vec[:, i:j])[0]
        i = j
    return vals, vec


def lanczos_lowest_eigsh(
    x,
    z,
    c,
    n_qubits: int,
    n_vecs: int,
    k: int = 0,
    v0: Optional[np.ndarray] = None,
    stop=None,
    prepared: Optional[PreparedOperator] = None,
    mesh=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Lowest ``n_vecs`` eigenpairs WITH multiplicity by deflated restarts.

    A single-vector Krylov space holds one vector per distinct eigenvalue;
    each sweep here locks the converged eigenvectors and reruns the
    recurrence with them deflated by shifting, so sweep m converges to the
    m-th lowest eigenpair counting multiplicity (start vectors from
    ``default_rng(7 + 13 * sweep)``).  ``stop(evals, evecs)``, called after
    each sweep with everything collected so far, may return True to end
    early.  Returns (evals, evecs) of what was collected, ascending.
    ``mesh`` as in ``lanczos_ground_state``.
    """
    dim = 1 << n_qubits
    n_vecs = max(1, min(n_vecs, dim))
    vals: list = []
    vecs: list = []
    locked = None
    if prepared is None:
        prepared = prepare_operator(x, z, c, n_qubits, mesh)
    for sweep in range(n_vecs):
        v_start = v0 if v0 is not None and sweep == 0 else _start_vector(7 + 13 * sweep, dim)
        ev, Y = lanczos_ground_state(
            x, z, c, n_qubits, k=k, v0=v_start, n_eigs=1, locked=locked,
            prepared=prepared,
        )
        y = Y[:, 0]
        if locked is not None:
            # exact host re-orthogonalisation before locking
            y = y - locked @ (locked.conj().T @ y)
            nrm = np.linalg.norm(y)
            if nrm < 1e-8:
                break  # complement exhausted
            y = y / nrm
        vals.append(float(ev[0]))
        vecs.append(y)
        locked = np.stack(vecs, axis=1)
        if stop is not None and stop(np.asarray(vals), locked):
            break
    order = np.argsort(vals)
    return np.asarray(vals)[order], locked[:, order]
