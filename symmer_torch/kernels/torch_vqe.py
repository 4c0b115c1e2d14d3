"""Plain-torch versions of the VQE engine's kernels (K15).

A dense complex128 statevector of 2^n rows, qubit 0 the most significant
bit of a row index.  A Pauli term acts on it as a signed permutation:
(P psi)[r] = ph (-1)^{popcount(r & z)} psi[r ^ x] with ph = (-i)^{|Y|} c
(``kernels/dense.py``).  The plain versions of the CUDA kernels, which the
wrappers in ``kernels/cuda.py`` call for CPU tensors:

  - ``rotate``: e^{i t G} psi for one generator G (c real +-1), out of
    place (``csrc/vqe_rotate.cu``);
  - ``pauli_overlaps``: <a| P_i |b> for a batch of Paulis, each summed over
    the rows by ``torch_lanczos.pairwise_sum`` (``csrc/pauli_overlaps.cu``).

Both work on the re / im planes with one IEEE operation at a time, in the
kernels' order, so the kernels equal them bit for bit.  ``energy`` is the
engine's whole objective in plain differentiable torch, the yardstick of
the adjoint gradient (``evolution/device_vqe.py``) in the tests and on the
card.
"""
from __future__ import annotations

import torch

from .torch_core import parity64
from .torch_lanczos import pairwise_sum

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


def rotate(psi: torch.Tensor, x: int, z: int, phr: float, phi: float, c: float,
           s: float) -> torch.Tensor:
    """out = c psi + i s ph (-1)^{popcount(r & z)} psi[r ^ x]: e^{i t G} psi
    for c = cos t, s = sin t.  psi: complex128[2^n]; returns a new tensor."""
    dim = psi.shape[0]
    rows = torch.arange(dim, dtype=torch.int64, device=psi.device)
    p = torch.view_as_real(psi)
    gre, gim = _phase_times(p[rows ^ x], phr, phi, signs(rows, z))
    out = torch.stack([p[:, 0] * c - gim * s, p[:, 1] * c + gre * s], dim=1)
    return torch.view_as_complex(out)


def pauli_overlaps(a: torch.Tensor, b: torch.Tensor, xs: torch.Tensor, zs: torch.Tensor,
                   ph: torch.Tensor) -> torch.Tensor:
    """complex128[N]: out_i = sum_r conj(a[r]) ph_i (-1)^{popcount(r & z_i)}
    b[r ^ x_i], each a pairwise sum over the rows.

    a, b: complex128[2^n]; xs, zs: int64[N] (x taken modulo 2^n, as the
    kernel takes it); ph: float64[N, 2] (re, im)."""
    dim, N = a.shape[0], xs.shape[0]
    rows = torch.arange(dim, dtype=torch.int64, device=a.device)
    pa, pb = torch.view_as_real(a), torch.view_as_real(b)
    out = torch.empty((N, 2), dtype=torch.float64, device=a.device)
    step = max(1, _CHUNK_ELEMS // dim)
    for i0 in range(0, N, step):
        x, z = xs[i0:i0 + step, None], zs[i0:i0 + step, None]
        gre, gim = _phase_times(pb[(rows[None, :] ^ x) & (dim - 1)], ph[i0:i0 + step, 0, None],
                                ph[i0:i0 + step, 1, None], signs(rows[None, :], z))
        tre = pa[:, 0] * gre + pa[:, 1] * gim
        tim = pa[:, 0] * gim - pa[:, 1] * gre
        out[i0:i0 + step, 0] = pairwise_sum(tre)
        out[i0:i0 + step, 1] = pairwise_sum(tim)
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
