"""Dense-statevector engine for VQE / ADAPT-VQE on ``config.device``.

The counterpart of ``symmer_tpu/evolution/jx_vqe.py``.  The objective

    E(x) = <ref| U(x)^dag H U(x) |ref>,   U(x) = prod_k e^{i x_k G_k}

runs on hand kernels: each generator G_k = ph_k (-1)^{popcount(r & z_k)}
X^{x_k} (ph = (-i)^{|Y|} c, c real +-1, so G_k^2 = I).  The engine cuts the
generators once into runs over coset tiles (``torch_vqe.plan_runs``); the
forward is one call of ``cuda.vqe_runs`` (K15a: one cooperative launch,
each run applied to every coset of its subspace in shared memory, a grid
barrier between runs), H psi is
K13's X-grouped matvec (``cuda.group_matvec``, b = 1) and <psi|H psi> one
overlap (``cuda.pauli_overlaps``, K15c, the identity).  The gradient is a
``torch.autograd.Function`` whose backward is the adjoint sweep, one call
of ``cuda.vqe_adjoint`` over the same runs in reverse: from lambda = H
psi_P, for k = P-1 .. 0, ov_k = <lambda| G_k |psi>, then psi <- U_k^dag psi
and lambda <- U_k^dag lambda, in place; g = -2 Im ov.  It holds a few state
vectors, where jax.grad through the reference's scan stores every step's
state (P x 2^n x 16 bytes).  The values equal the reference's
parameter-shift ones (the +-pi/4 shift rule is exact for Pauli
generators).  Only the angles' (cos, sin) go up per call, as one float64
tensor.

The ADAPT pool gradient d_i = <psi| i[H, P_i] |psi> = -2 Im <H psi| P_i
|psi> is one batch of overlaps of the pool grouped by X part on the host
(``device_pool_gradient``).  On the CPU device every kernel is its plain
torch version (``kernels/torch_vqe.py``, ``torch_lanczos.terms_matvec``).
Basis convention as ``kernels/dense.py``: qubit 0 is the most significant
bit of a row index.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..kernels import cuda, dense, torch_vqe

# the dense 2^n statevector lives on the device
MAX_QUBITS = 26
_MINUS_I_POW = np.array([1, -1j, -1, 1j])


def term_arrays(op) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(x_int, z_int, ph) per term: int64 patterns (qubit 0 the most
    significant bit) and ph = (-i)^{|Y|} c (complex)."""
    x_int = dense.plane_ints(op.x_pack, op.n_qubits)
    z_int = dense.plane_ints(op.z_pack, op.n_qubits)
    y_cnt = np.bitwise_count(op.x_pack & op.z_pack).sum(axis=1).astype(np.int64)
    return x_int, z_int, _MINUS_I_POW[y_cnt % 4] * np.asarray(op.coeff_vec, complex)


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)


def term_tensors(op, device):
    """(x int64[N], z int64[N], ph float64[N, 2] (re, im), groups) on
    ``device``: an operator's terms as ``cuda.pauli_overlaps`` takes them,
    grouped by X part on the host."""
    x, z, ph = term_arrays(op)
    return (_tensor(x, torch.int64, device), _tensor(z, torch.int64, device),
            _tensor(np.stack([ph.real, ph.imag], axis=1).reshape(-1, 2), torch.float64, device),
            cuda.overlap_groups(x, 1 << op.n_qubits, device))


def _check_inputs(observable, generators, what: str) -> None:
    if observable.n_qubits > MAX_QUBITS:
        raise AssertionError(
            "device_array holds the dense 2^n statevector on device; "
            f"{observable.n_qubits} qubits exceeds the supported range")
    # the rotation computes cos(x) psi + i sin(x) c P psi, which equals
    # exp(i x c P) only when c^2 == 1, i.e. c is REAL +-1 (a complex
    # unit-modulus c like i gives (cP)^2 = -I and a hyperbolic evolution);
    # VQE_Driver.prepare_for_evolution normalises, direct callers may not
    if generators.n_terms and not (np.allclose(generators.coeff_vec.imag, 0)
                                   and np.allclose(np.abs(generators.coeff_vec.real), 1)):
        raise AssertionError(f"{what} requires real +-1 generator coefficients; "
                             "normalise via prepare_for_evolution first")


class DeviceVQEEngine:
    """Bound (observable, generators, ref state) -> loss / gradient on
    ``config.device``; raises when that is CUDA and no card is present."""

    def __init__(self, observable, generators, ref_state):
        from ..config import config

        _check_inputs(observable, generators, "DeviceVQEEngine")
        dev = config.torch_device()
        self.device = dev
        self.n_qubits = n = observable.n_qubits
        self.n_params = generators.n_terms
        # the runs over coset tiles, once per engine: only the angles change
        self._plan = torch_vqe.plan_runs(*term_arrays(generators), n).on(dev)
        # the observable's terms sorted by X group, as kernels/lanczos.py's
        # prepare_operator keeps them (no table, so no table budget)
        ux, gidx, z_int, phase_c = dense.group_scatter_inputs(
            observable.x_pack, observable.z_pack, observable.coeff_vec, n)
        order = np.argsort(gidx, kind="stable")
        off = np.concatenate([[0], np.cumsum(np.bincount(gidx, minlength=ux.shape[0]))])
        self._H = (_tensor(ux, torch.int64, dev), _tensor(off, torch.int32, dev),
                   _tensor(z_int[order], torch.int32, dev),
                   _tensor(phase_c[order], torch.complex128, dev))
        self._psi0 = _tensor(ref_state.to_dense_matrix.reshape(-1), torch.complex128, dev)
        zero = torch.zeros(1, dtype=torch.int64, device=dev)
        self._identity = (zero, zero, torch.tensor([[1.0, 0.0]], dtype=torch.float64, device=dev),
                          cuda.overlap_groups([0], 1 << n, dev))

    # -- the pieces --------------------------------------------------------

    def _angles(self, x) -> torch.Tensor:
        """float64[P, 2] (cos x_k, sin x_k) on the device."""
        x = np.asarray(x, np.float64).reshape(-1)
        if x.shape != (self.n_params,):
            raise ValueError(f"{x.shape[0]} parameters for {self.n_params} generators")
        return _tensor(np.stack([np.cos(x), np.sin(x)], axis=1), torch.float64, self.device)

    def evolve(self, x) -> torch.Tensor:
        """psi(x) = prod_k e^{i x_k G_k} psi0 (G_0 first), a new tensor."""
        return cuda.vqe_runs(self._psi0, self._plan, self._angles(x))

    def apply_observable(self, psi: torch.Tensor) -> torch.Tensor:
        """H psi (K13's matvec, one column)."""
        return cuda.group_matvec(*self._H, psi[None])[0]

    def expectation(self, psi: torch.Tensor, hpsi: torch.Tensor) -> torch.Tensor:
        """Re <psi| H psi> as a 0-d float64 tensor on the device."""
        xs, zs, ph, groups = self._identity
        return cuda.pauli_overlaps(psi, hpsi, xs, zs, ph, groups)[0].real

    def adjoint(self, x, psi: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
        """dE/dx (float64[P] on the device) by the adjoint sweep from psi =
        psi(x) and lam = H psi.  Both inputs are consumed: the card's sweep
        overwrites them through raw pointers, so their autograd version
        counters are moved here, on every device alike."""
        ov = cuda.vqe_adjoint(psi, lam, self._plan, self._angles(x))
        torch.autograd.graph.increment_version(psi)
        torch.autograd.graph.increment_version(lam)
        return -2.0 * ov.imag

    # -- what VQE_Driver calls ---------------------------------------------------

    def loss(self, x) -> float:
        return float(_Energy.apply(torch.as_tensor(np.asarray(x, np.float64)), self))

    def gradient(self, x) -> np.ndarray:
        xt = torch.tensor(np.asarray(x, np.float64).reshape(-1), requires_grad=True)
        _Energy.apply(xt, self).backward()
        return xt.grad.numpy()

    def pool_gradient(self, pool, x) -> np.ndarray:
        """d_i = -2 Im <H psi(x)| P_i |psi(x)> for every pool term."""
        psi = self.evolve(x)
        xs, zs, ph, groups = term_tensors(pool, self.device)
        out = cuda.pauli_overlaps(self.apply_observable(psi), psi, xs, zs, ph, groups)
        return (-2.0 * out.imag).cpu().numpy()

    @staticmethod
    def key(observable, generators, ref_state) -> Tuple:
        """Cheap identity for engine reuse across optimizer iterations.

        Content-based throughout: id()-based components are unsafe here
        (CPython recycles freed addresses, so a stale id can alias a new
        object and serve an engine built for different inputs)."""
        from ..config import config

        return (
            str(config.device),
            observable.x_pack.tobytes(), observable.z_pack.tobytes(),
            observable.coeff_vec.tobytes(),
            generators.x_pack.tobytes(), generators.z_pack.tobytes(),
            generators.coeff_vec.tobytes(),
            ref_state._s_pack.tobytes(), ref_state._amps.tobytes(),
        )


class _Energy(torch.autograd.Function):
    """E(x) for a CPU float64 parameter vector x; the engine's kernels run on
    its device.  Backward: the adjoint sweep (DeviceVQEEngine.adjoint)."""

    @staticmethod
    def forward(ctx, x, engine):
        xs = x.detach().numpy()
        psi = engine.evolve(xs)
        hpsi = engine.apply_observable(psi)
        ctx.engine, ctx.x = engine, xs
        ctx.save_for_backward(psi, hpsi)
        return engine.expectation(psi, hpsi).cpu()

    @staticmethod
    def backward(ctx, grad_out):
        # the sweep consumes the saved vectors and moves their version
        # counters: a second backward through the same graph raises
        psi, hpsi = ctx.saved_tensors
        return grad_out * ctx.engine.adjoint(ctx.x, psi, hpsi).cpu(), None


def device_pool_gradient(observable, adapt_gens, ref_state, pool, x) -> np.ndarray:
    """ADAPT pool gradient on ``config.device``: every d_i = <psi| i[H, P_i]
    |psi> = -2 Im <H psi| P_i |psi> from one state, one H psi and one batch
    of overlaps (the reference materialises a commutator operator per pool
    element instead, variational_optimization.py:276-355)."""
    _check_inputs(observable, adapt_gens, "device_pool_gradient")
    return DeviceVQEEngine(observable, adapt_gens, ref_state).pool_gradient(pool, x)
