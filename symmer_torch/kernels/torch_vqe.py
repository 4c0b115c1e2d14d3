"""Plain-torch versions of the VQE engine's kernels (K15), and the plan of
rotation runs that the forward and the adjoint sweep share.

A dense complex128 statevector of 2^n rows, qubit 0 the most significant
bit of a row index.  A Pauli term acts on it as a signed permutation:
(P psi)[r] = ph (-1)^{popcount(r & z)} psi[r ^ x] with ph = (-i)^{|Y|} c
(``kernels/dense.py``).

**Runs over coset tiles.**  A rotation by G = ph (-1)^{popc(r & z)} X^x maps
row r only to r ^ x, so it maps every coset of a GF(2) subspace S that holds
x onto itself.  ``plan_runs`` cuts the generators into runs: maximal
stretches of consecutive generators (MAX_RUN at most) whose x's, with the
FOLD_BITS low row bits, span at most D dimensions (``default_tile_bits``).
Each run's S is filled up to exactly D dimensions with the lowest free row
bits, so every tile holds 2^D rows and its rows come in aligned runs of
2^FOLD_BITS (64 contiguous bytes: the loads and stores stay coalesced).
The basis b_0 .. b_{D-1} of S is in reduced echelon form, ordered by pivot
(each b_i's lowest set bit, set in no other b): tile row j of coset c is
rep(c) ^ B(j), B(j) the XOR of the b_i at j's set bits, rep(c) the row that
holds c's bits at the non-pivot positions and 0 at the pivots.  A
generator's x is B(m) for its tile mask m (m's bit i is x's bit at pivot
i), and popc(r & z) is odd exactly when popc(rep & z) + popc(j & zc) is,
zc's bit i the parity of b_i & z.  Within a run, generators with one x form
stretches (at most MAX_STRETCH long): a stretch pairs tile rows (j0, j0 ^
m), j0 the pair index p with a 0 inserted at m's lowest bit h.

The plain versions of the CUDA kernels, which the wrappers in
``kernels/cuda.py`` call for CPU tensors:

  - ``rotate``: e^{i t G} psi for one generator G (c real +-1), out of
    place;
  - ``rotate_runs``: the whole forward prod_k e^{i t_k G_k} psi over the
    plan's tiles (``csrc/vqe_rotate.cu``'s forward); each row sees the same
    rotations in the same order with the same operations as ``rotate``, so
    it equals P sequential ``rotate`` calls bit for bit;
  - ``adjoint_sweep``: the adjoint sweep's overlaps <lam| G_k |psi> from
    the last generator down, un-rotating both vectors by U_k after each
    (``csrc/vqe_rotate.cu``'s sweep); each overlap is summed in the
    kernel's order (below);
  - ``pauli_overlaps``: <a| P_i |b> for a batch of Paulis
    (``csrc/pauli_overlaps.cu``), each the pairwise sum
    (``torch_lanczos.pairwise_sum``) over the rows in their natural order of
    (-1)^{popc(r & z_i)} w(r), w(r) = conj(a[r]) b[r ^ x_i], times ph_i once.

**The sweep's order of a sum.**  A thread of the kernel's block (256) takes
the items p = t + i T of a stretch (T = min(256, items); items the 2^(D-1)
pairs, or the 2^D rows where m = 0), adds their values left to right over i
(a pair's value is its two rows' terms added, j0's first), the block adds
its threads' sums by the pairwise tree over t (the coset's partial, kept
per generator and coset), and the totals add the partials by the pairwise
tree over the cosets, then multiply by ph once.

Every function works on the re / im planes with one IEEE operation at a
time, in the kernels' order, so the kernels equal them bit for bit.
``energy`` is the engine's whole objective in plain differentiable torch,
the yardstick of the adjoint gradient (``evolution/device_vqe.py``) in the
tests and on the card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from .torch_core import parity64
from .torch_lanczos import pairwise_sum

# d_max: a coset tile holds at most 2^TILE_BITS rows (16 KB of complex128
# a vector), at least 2^MIN_TILE_BITS (or the whole state), and by default
# the width that leaves 2^COSET_BITS cosets (blocks for the card's 132
# SMs): the fastest forward and sweep of d = 8-12 at tapered MgH2 (17 q:
# d = 9) and N2 (15 q: d = 8) (tools/vqe_tiles.py, PERF.md)
TILE_BITS = 10
MIN_TILE_BITS = 8
COSET_BITS = 8
# the low row bits folded into every tile: 4 adjacent rows, 64 bytes
FOLD_BITS = 2
# generators of one x that a stretch applies (the sweep keeps one partial
# sum per generator of a stretch in registers)
MAX_STRETCH = 8
# generators of a run (the kernels stage a run's parameters in shared memory)
MAX_RUN = 256
# threads of the kernels' blocks
THREADS = 256
# rows x Paulis of one chunk of pauli_overlaps' (Paulis, rows) products
_CHUNK_ELEMS = 1 << 22


def signs(rows: torch.Tensor, z) -> torch.Tensor:
    """float64 (-1)^{popcount(rows & z)}; z an int or an int64 tensor
    broadcasting against rows."""
    return (1 - 2 * parity64(rows & z)).to(torch.float64)


def _phase_times(q: torch.Tensor, phr, phi, sgn):
    """(re, im) of ph * sgn * q for q a (..., 2) float64 plane pair."""
    gre = (q[..., 0] * phr - q[..., 1] * phi) * sgn
    gim = (q[..., 1] * phr + q[..., 0] * phi) * sgn
    return gre, gim


def _rotated(p: torch.Tensor, q: torch.Tensor, phr, phi, sgn, c, s) -> torch.Tensor:
    """c p + i s ph sgn q for (..., 2) plane pairs p (the row) and q (its
    partner): (c p.re - s g.im, c p.im + s g.re)."""
    gre, gim = _phase_times(q, phr, phi, sgn)
    return torch.stack([p[..., 0] * c - gim * s, p[..., 1] * c + gre * s], dim=-1)


def rotate(psi: torch.Tensor, x: int, z: int, phr: float, phi: float, c: float,
           s: float) -> torch.Tensor:
    """out = c psi + i s ph (-1)^{popcount(r & z)} psi[r ^ x]: e^{i t G} psi
    for c = cos t, s = sin t.  psi: complex128[2^n]; returns a new tensor."""
    dim = psi.shape[0]
    rows = torch.arange(dim, dtype=torch.int64, device=psi.device)
    p = torch.view_as_real(psi)
    return torch.view_as_complex(_rotated(p, p[rows ^ x], phr, phi, signs(rows, z), c, s))


# -- the plan of runs ------------------------------------------------------------

def _reduce(v: int, basis: Dict[int, int]) -> int:
    """v with every pivot bit cleared by the reduced basis {pivot: vector}."""
    for p, b in basis.items():
        if v >> p & 1:
            v ^= b
    return v


def _insert(basis: Dict[int, int], v: int) -> None:
    """Add a reduced nonzero v (its lowest bit the new pivot), keeping the
    basis reduced: no pivot bit is set in another vector."""
    q = (v & -v).bit_length() - 1
    for p, b in basis.items():
        if b >> q & 1:
            basis[p] = b ^ v
    basis[q] = v


def _parity(v: int) -> int:
    return bin(v).count("1") & 1


@dataclass(frozen=True)
class RunPlan:
    """The generators cut into runs over coset tiles (see the module
    docstring).  R runs, S stretches, P generators, D = tile_bits."""
    n_qubits: int
    tile_bits: int
    run_off: np.ndarray       # int64[R + 1]: run r's stretches
    basis: np.ndarray         # int64[R, D]: b_0 .. b_{D-1}, by pivot
    pivots: np.ndarray        # int64[R]: the pivot bits as a mask
    stretch_off: np.ndarray   # int64[S + 1]: stretch s's generators
    stretch_mask: np.ndarray  # int64[S]: x in tile coordinates (m)
    gx: np.ndarray            # int64[P]
    gz: np.ndarray            # int64[P]
    gzc: np.ndarray           # int64[P]: z in tile coordinates (zc)
    ph: np.ndarray            # float64[P, 2]: (re, im) of ph

    @property
    def n_runs(self) -> int:
        return self.basis.shape[0]

    @property
    def n_cosets(self) -> int:
        return 1 << (self.n_qubits - self.tile_bits)

    def ints(self) -> np.ndarray:
        """The integer arrays in one int64 buffer, in the order of
        ``int_sections`` (the kernels read them at these offsets)."""
        return np.concatenate([np.asarray(getattr(self, k), np.int64).reshape(-1)
                               for k, _ in self.int_sections()])

    def int_sections(self) -> List[Tuple[str, int]]:
        return [(k, getattr(self, k).size) for k in
                ("run_off", "basis", "pivots", "stretch_off", "stretch_mask", "gz", "gzc")]

    def on(self, device) -> "DevicePlan":
        """The plan's arrays on `device` (two uploads), as the kernels take
        them."""
        sizes = [size for _, size in self.int_sections()]
        return DevicePlan(
            plan=self, ints=torch.as_tensor(self.ints(), device=device),
            ph=torch.as_tensor(self.ph, device=device),
            sections=tuple(int(v) for v in np.cumsum([0] + sizes[:-1])))


@dataclass(frozen=True)
class DevicePlan:
    """A RunPlan on a device: its int64 sections in one tensor (each starting
    at its entry of `sections`) and ph as float64[P, 2]."""
    plan: RunPlan
    ints: torch.Tensor
    ph: torch.Tensor
    sections: Tuple[int, ...]


def default_tile_bits(n_qubits: int) -> int:
    """The tile width d_max of an n-qubit state (TILE_BITS above)."""
    return min(n_qubits, max(MIN_TILE_BITS, min(TILE_BITS, n_qubits - COSET_BITS)))


def plan_runs(gx, gz, ph, n_qubits: int, tile_bits: int = None) -> RunPlan:
    """Cut P generators (x, z int patterns, ph complex) into runs whose x's
    and the FOLD_BITS low row bits span at most tile_bits dimensions
    (default: default_tile_bits(n)), greedily in order, MAX_RUN generators
    at most; stretches of one x within a run, MAX_STRETCH long at most."""
    n = int(n_qubits)
    D = min(default_tile_bits(n) if tile_bits is None else int(tile_bits), n)
    # a fresh run must hold any x: at most D - 1 folded bits
    L = min(FOLD_BITS, max(D - 1, 0))
    gx = np.asarray(gx, np.int64).reshape(-1)
    gz = np.asarray(gz, np.int64).reshape(-1)
    ph = np.asarray(ph, complex).reshape(-1)
    P = gx.shape[0]

    def fresh():
        return {i: 1 << i for i in range(L)}

    cuts, basis = [], fresh()  # (first generator, basis) of each run
    start = 0
    for k in range(P):
        v = _reduce(int(gx[k]), basis)
        if (v and len(basis) == D) or k - start == MAX_RUN:
            cuts.append((start, basis))
            start, basis = k, fresh()
            v = _reduce(int(gx[k]), basis)
        if v:
            _insert(basis, v)
    if P:
        cuts.append((start, basis))
    bounds = [c[0] for c in cuts] + [P]
    run_off, bases, pivots = [0], [], []
    stretch_off, stretch_mask = [0], []
    gzc = np.zeros(P, np.int64)
    for r, (k0, basis) in enumerate(cuts):
        for b in range(n):  # fill S up to D with the lowest free row bits
            if len(basis) == D:
                break
            if b not in basis:
                _insert(basis, 1 << b)
        piv = sorted(basis)
        bvec = [basis[p] for p in piv]
        bases.append(bvec)
        pivots.append(sum(1 << p for p in piv))
        k1 = bounds[r + 1]
        prev = None
        for k in range(k0, k1):
            m = sum(((int(gx[k]) >> p) & 1) << i for i, p in enumerate(piv))
            gzc[k] = sum(_parity(b & int(gz[k])) << i for i, b in enumerate(bvec))
            if m != prev or k - stretch_off[-1] == MAX_STRETCH:
                if k > k0:
                    stretch_off.append(k)
                stretch_mask.append(m)
                prev = m
        stretch_off.append(k1)
        run_off.append(len(stretch_mask))
    return RunPlan(
        n_qubits=n, tile_bits=D, run_off=np.asarray(run_off, np.int64),
        basis=np.asarray(bases, np.int64).reshape(len(bases), D),
        pivots=np.asarray(pivots, np.int64),
        stretch_off=np.asarray(stretch_off if P else [0], np.int64),
        stretch_mask=np.asarray(stretch_mask, np.int64), gx=gx, gz=gz, gzc=gzc,
        ph=np.stack([ph.real, ph.imag], axis=1).reshape(-1, 2).astype(np.float64))


def coset_reps(plan: RunPlan, r: int) -> np.ndarray:
    """int64[2^(n-D)]: rep(c) of run r, c's bits at the non-pivot positions."""
    c = np.arange(plan.n_cosets, dtype=np.int64)
    rep = np.zeros_like(c)
    free = [b for b in range(plan.n_qubits) if not int(plan.pivots[r]) >> b & 1]
    for i, b in enumerate(free):
        rep |= ((c >> i) & 1) << b
    return rep


def tile_offsets(plan: RunPlan, r: int) -> np.ndarray:
    """int64[2^D]: B(j) of run r."""
    j = np.arange(1 << plan.tile_bits, dtype=np.int64)
    off = np.zeros_like(j)
    for i, b in enumerate(plan.basis[r]):
        off ^= ((j >> i) & 1) * b
    return off


def tile_rows(plan: RunPlan, r: int) -> np.ndarray:
    """int64[2^(n-D), 2^D]: row rep(c) ^ B(j) of tile row j of coset c."""
    return coset_reps(plan, r)[:, None] ^ tile_offsets(plan, r)[None, :]


def _items(D: int, m: int) -> np.ndarray:
    """int64[K, T]: the first tile row j0 of item p = t + i T, at [i, t]."""
    if m == 0:
        p = np.arange(1 << D, dtype=np.int64)
    else:
        h = (m & -m).bit_length() - 1
        p = np.arange(1 << (D - 1), dtype=np.int64)
        p = ((p >> h) << (h + 1)) | (p & ((1 << h) - 1))
    T = min(THREADS, p.size)
    return p.reshape(-1, T)


def _tile_signs(rep: torch.Tensor, j: torch.Tensor, z: int, zc: int) -> torch.Tensor:
    """(-1)^{popc(rep & z) + popc(j & zc)}: rep (C, 1), j a tile index tensor."""
    return (1 - 2 * (parity64(rep & z) ^ parity64(j & zc))).to(torch.float64)


def _run_tensors(plan: RunPlan, r: int, device):
    rows = torch.as_tensor(tile_rows(plan, r), device=device)
    rep = torch.as_tensor(coset_reps(plan, r), device=device)[:, None]
    return rows, rep


def _stretches(plan: RunPlan, r: int):
    for s in range(int(plan.run_off[r]), int(plan.run_off[r + 1])):
        yield int(plan.stretch_mask[s]), int(plan.stretch_off[s]), int(plan.stretch_off[s + 1])


def rotate_runs(psi: torch.Tensor, plan: RunPlan, cs: torch.Tensor) -> torch.Tensor:
    """prod_k e^{i t_k G_k} psi (G_0 first) over the plan's coset tiles: a
    new tensor.  cs: float64[P, 2], (cos t_k, sin t_k)."""
    out = torch.view_as_real(psi.clone())
    J = torch.arange(1 << plan.tile_bits, dtype=torch.int64, device=psi.device)
    cs = cs.to(torch.float64)
    for r in range(plan.n_runs):
        rows, rep = _run_tensors(plan, r, psi.device)
        tile = out[rows]                                    # (C, 2^D, 2)
        for m, k0, k1 in _stretches(plan, r):
            for k in range(k0, k1):
                sgn = _tile_signs(rep, J, int(plan.gz[k]), int(plan.gzc[k]))
                phr, phi = float(plan.ph[k, 0]), float(plan.ph[k, 1])
                tile = _rotated(tile, tile[:, J ^ m], phr, phi, sgn, cs[k, 0], cs[k, 1])
        out[rows] = tile
    return torch.view_as_complex(out)


def _terms(lt: torch.Tensor, pt: torch.Tensor, sgn: torch.Tensor):
    """(re, im) of sgn conj(l) p for (..., 2) plane pairs."""
    wre = lt[..., 0] * pt[..., 0] + lt[..., 1] * pt[..., 1]
    wim = lt[..., 0] * pt[..., 1] - lt[..., 1] * pt[..., 0]
    return wre * sgn, wim * sgn


def _fold(v: torch.Tensor) -> torch.Tensor:
    """(..., K, T) -> (..., T): the K items of each thread added left to right."""
    acc = v[..., 0, :]
    for i in range(1, v.shape[-2]):
        acc = acc + v[..., i, :]
    return acc


def _times_ph(re: torch.Tensor, im: torch.Tensor, phr, phi):
    """(re, im) of ph (re + i im): (phr re - phi im, phr im + phi re)."""
    return re * phr - im * phi, im * phr + re * phi


def adjoint_sweep(psi: torch.Tensor, lam: torch.Tensor, plan: RunPlan,
                  cs: torch.Tensor) -> torch.Tensor:
    """complex128[P]: ov_k = <lam_k| G_k |psi_k> for k = P-1 .. 0, psi_k and
    lam_k the vectors after un-rotating by U_{P-1} .. U_{k+1} (U_k = e^{i t_k
    G_k}); each sum in the sweep kernel's order (module docstring).  psi and
    lam are left as they were (the kernel works on them in place)."""
    dev = psi.device
    P = plan.gx.shape[0]
    ps, ls = torch.view_as_real(psi.clone()), torch.view_as_real(lam.clone())
    J = torch.arange(1 << plan.tile_bits, dtype=torch.int64, device=dev)
    cs = cs.to(torch.float64)
    part = torch.empty((P, plan.n_cosets, 2), dtype=torch.float64, device=dev)
    for r in reversed(range(plan.n_runs)):
        rows, rep = _run_tensors(plan, r, dev)
        pt, lt = ps[rows], ls[rows]                          # (C, 2^D, 2)
        for m, k0, k1 in reversed(list(_stretches(plan, r))):
            j0 = torch.as_tensor(_items(plan.tile_bits, m), device=dev)   # (K, T)
            for k in reversed(range(k0, k1)):
                z, zc = int(plan.gz[k]), int(plan.gzc[k])
                sgn = _tile_signs(rep, J, z, zc)                          # (C, 2^D)
                vre, vim = _terms(lt, pt[:, J ^ m], sgn)
                if m:
                    j1 = j0 ^ m
                    vre, vim = vre[:, j0] + vre[:, j1], vim[:, j0] + vim[:, j1]
                else:
                    vre, vim = vre[:, j0], vim[:, j0]
                part[k, :, 0] = pairwise_sum(_fold(vre))
                part[k, :, 1] = pairwise_sum(_fold(vim))
                if k:  # U_k^dag = e^{-i t_k G_k}; the last un-rotation is not needed
                    phr, phi = float(plan.ph[k, 0]), float(plan.ph[k, 1])
                    c, s = cs[k, 0], -cs[k, 1]
                    pt = _rotated(pt, pt[:, J ^ m], phr, phi, sgn, c, s)
                    lt = _rotated(lt, lt[:, J ^ m], phr, phi, sgn, c, s)
        ps[rows], ls[rows] = pt, lt
    tot = pairwise_sum(part.transpose(1, 2))                 # (P, 2)
    ph = torch.as_tensor(plan.ph, device=dev)
    ore, oim = _times_ph(tot[:, 0], tot[:, 1], ph[:, 0], ph[:, 1])
    return torch.view_as_complex(torch.stack([ore, oim], dim=1).contiguous())


def x_groups(xs) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(ux int64[G], off int64[G + 1], order int64[N]) of Paulis sorted by x
    (stable): slot s of group g (off[g] <= s < off[g + 1]) is Pauli
    order[s], whose x is ux[g]."""
    xs = np.asarray(xs, np.int64).reshape(-1)
    order = np.argsort(xs, kind="stable")
    ux, counts = np.unique(xs[order], return_counts=True)
    return ux, np.concatenate([[0], np.cumsum(counts)]).astype(np.int64), order.astype(np.int64)


def pauli_overlaps(a: torch.Tensor, b: torch.Tensor, xs: torch.Tensor, zs: torch.Tensor,
                   ph: torch.Tensor) -> torch.Tensor:
    """complex128[N]: out_i = ph_i sum_r (-1)^{popcount(r & z_i)} conj(a[r])
    b[r ^ x_i], the sum a pairwise sum over the rows, ph_i applied once.

    a, b: complex128[2^n]; xs, zs: int64[N] (x taken modulo 2^n, as the
    kernel takes it); ph: float64[N, 2] (re, im)."""
    dim, N = a.shape[0], xs.shape[0]
    rows = torch.arange(dim, dtype=torch.int64, device=a.device)
    pa, pb = torch.view_as_real(a), torch.view_as_real(b)
    out = torch.empty((N, 2), dtype=torch.float64, device=a.device)
    step = max(1, _CHUNK_ELEMS // dim)
    for i0 in range(0, N, step):
        x, z = xs[i0:i0 + step, None], zs[i0:i0 + step, None]
        wre, wim = _terms(pa, pb[(rows[None, :] ^ x) & (dim - 1)], signs(rows[None, :], z))
        ore, oim = _times_ph(pairwise_sum(wre), pairwise_sum(wim),
                             ph[i0:i0 + step, 0], ph[i0:i0 + step, 1])
        out[i0:i0 + step, 0], out[i0:i0 + step, 1] = ore, oim
    return torch.view_as_complex(out)


def energy(x: torch.Tensor, psi0: torch.Tensor, gx, gz, gph, hx, hz, hph) -> torch.Tensor:
    """E(x) = Re <psi(x)| H |psi(x)>, psi(x) = prod_k e^{i x_k G_k} psi0
    (G_0 first), in differentiable torch: the gradient by torch.autograd.

    x: float64[P] (requires_grad for a gradient); psi0: complex128[2^n];
    gx, gz: int64[P] and gph: complex128[P], the generators; hx, hz:
    int64[T] and hph: complex128[T], the observable's terms."""
    dim = psi0.shape[0]
    rows = torch.arange(dim, dtype=torch.int64, device=psi0.device)
    psi = psi0
    for k in range(gx.shape[0]):
        g = gph[k] * signs(rows, gz[k]) * psi[rows ^ gx[k]]
        psi = torch.cos(x[k]) * psi + 1j * torch.sin(x[k]) * g
    e = torch.zeros((), dtype=torch.complex128, device=psi0.device)
    for t in range(hx.shape[0]):
        e = e + hph[t] * torch.vdot(psi, signs(rows, hz[t]) * psi[rows ^ hx[t]])
    return e.real
