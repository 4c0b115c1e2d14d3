#!/usr/bin/env python3
"""Where symmer_tpu's and symmer_torch's BeH2 Lanczos states part.

    JAX_PLATFORMS=cpu python3 tools/beh2_noise.py

On the CPU (symmer_torch on config.device "cpu", symmer_tpu on JAX's CPU
backend with x64), for BeH2 STO-3G (14 qubits, k = 352 Lanczos steps from
the start vector both packages draw), prints:
  - the amplitudes of each package's uncleaned lanczos_ground_state vector
    by decade of magnitude, those in [1e-15, 1e-12) split by whether they
    lie in the ground state's particle-number sector;
  - the gap between the two pass-1 recurrences' alpha_j at some steps j;
  - the ghost copies of the ground Ritz value in each package's tridiagonal
    matrix and, for the lowest three, the Krylov steps that hold their
    eigenvector's weight (the lowest one is the Ritz vector kept), and the
    Ritz vector of each copy with the qubit count QubitSubspaceManager
    reaches from it;
  - the Ritz vector, and the qubit count QubitSubspaceManager reaches from
    it, when one package's pass-1 scalars (alpha, beta and the eigenvector
    of their tridiagonal matrix) drive the other package's pass 2;
  - the same when pass 1 runs one package's matvec with the other's step
    arithmetic (y = V s from the stored Krylov vectors);
  - the port's vector when its pairwise sums are replaced by a sequential
    sum or by 8 running partial sums.
This is the evidence behind ROADMAP.md Queue 3's BeH2 entry.  It imports
both packages: it is a comparison, not part of the port.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import warnings

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECADES = [(1e-13, 1e-12), (1e-14, 1e-13), (1e-15, 1e-14), (1e-16, 1e-15), (1e-17, 1e-16),
           (1e-20, 1e-17), (0.0, 1e-20)]
RANGES = ((0, 50), (50, 100), (100, 200), (200, 300), (300, 352))


def decades(v) -> str:
    a = np.abs(v)
    return " ".join(f"[{lo:.0e},{hi:.0e}):{int(((a >= lo) & (a < hi)).sum())}" for lo, hi in DECADES)


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch
    from scipy.linalg import eigh_tridiagonal

    import symmer_torch
    import symmer_torch.utils as tutils
    import symmer_tpu
    from symmer_torch import config as tconfig
    from symmer_torch.kernels import dispatch as tdispatch
    from symmer_torch.kernels import lanczos, torch_lanczos
    from symmer_tpu.kernels import jx_lanczos

    warnings.simplefilter("ignore")
    tconfig.device, tconfig.backend = "cpu", "device"
    tdispatch.DEVICE_FLOOR = 0
    path = os.path.join(REPO, "tests", "data", "hamiltonians", "BeH2_STO-3G_SINGLET_JW.json")
    terms = json.load(open(path))["hamiltonian"]
    H = symmer_tpu.PauliwordOp.from_dictionary(terms)
    Ht = symmer_torch.PauliwordOp.from_dictionary(terms)
    planes = (H.x_pack, H.z_pack, H.coeff_vec, H.n_qubits)
    n, dim = H.n_qubits, 1 << H.n_qubits
    k = 16 + 24 * n
    count = np.bitwise_count(np.arange(dim))

    def noise(y) -> str:
        """Amplitudes at or above 1e-15, and those below 1e-12 in and out of
        the sector of the largest amplitude."""
        a = np.abs(y / np.linalg.norm(y))
        sector = count == count[np.argmax(a)]
        small = (a >= 1e-15) & (a < 1e-12)
        return (f"{int((a >= 1e-15).sum())} amplitudes at or above 1e-15 ([1e-15, 1e-12): "
                f"{int((small & sector).sum())} in the sector, {int((small & ~sector).sum())} "
                f"out, largest out {a[~sector].max():.1e})")

    def qubits(y) -> int:
        """QubitSubspaceManager(BeH2).get_reduced_hamiltonian(6) on the
        port, with y as the Lanczos reference state."""
        psi = symmer_torch.QuantumState.from_array((y / np.linalg.norm(y)).reshape(-1, 1))
        real = tutils.exact_gs_energy_device
        tutils.exact_gs_energy_device = lambda *a, **kw: (None, psi)
        try:
            return symmer_torch.QubitSubspaceManager(Ht).get_reduced_hamiltonian(6).n_qubits
        finally:
            tutils.exact_gs_energy_device = real

    symmer_torch.QubitSubspaceManager._device_lanczos_ok = staticmethod(lambda: True)

    # the two uncleaned states
    ej, Vj = jx_lanczos.lanczos_ground_state(*planes)
    et, Vt = lanczos.lanczos_ground_state(*planes)
    b, a = Vj[:, 0], Vt[:, 0]
    big = np.abs(b) > 1e-12
    ph = np.vdot(a[big], b[big])
    a = a * ph / abs(ph)
    print(f"energies symmer_tpu {ej[0]!r} port {et[0]!r}")
    print(f"amplitudes above 1e-12: symmer_tpu {int(big.sum())} port "
          f"{int((np.abs(a) > 1e-12).sum())}, apart up to a phase {np.abs(a[big] - b[big]).max():.2e}")
    print(f"symmer_tpu by decade: {decades(b)}")
    print(f"port by decade:       {decades(a)}")
    print(f"symmer_tpu: {noise(b)}, {qubits(b)} qubits")
    print(f"port:       {noise(a)}, {qubits(a)} qubits")

    # each package's pass 1 and pass 2, by their own functions
    rng = np.random.default_rng(7)
    v0 = rng.standard_normal(dim) + 0.25j * rng.standard_normal(dim)
    perms, D_dev, mesh, df, dt = jx_lanczos.prepare_operator(*planes)
    v0_j = jx_lanczos._ship_vec(v0, df, dt)
    no_lock, no_sigma = jnp.zeros((0, dim, 2), dt), jnp.zeros((1,), dt)
    prep = lanczos.prepare_operator(*planes)
    v0_t = torch.tensor(v0)

    def ref_pass1():
        cur = jx_lanczos._normalize_fn(df)(v0_j)
        prev, beta = jnp.zeros_like(cur), jnp.zeros((1,), dt)
        al, be = jnp.zeros((k, 1), dt), jnp.zeros((k, 1), dt)
        for j0 in range(0, k, 64):  # symmer_tpu's segments of 64 steps
            seg = jx_lanczos._tridiag_segment_fn(k, min(64, k - j0), n, df, None, 0)
            prev, cur, beta, al, be = seg(perms, D_dev, no_lock, no_sigma, prev, cur, beta,
                                          al, be, j0)
        return np.asarray(al)[:, 0], np.asarray(be)[:, 0]

    def ref_pass2(al, be, s):
        cur = jx_lanczos._normalize_fn(df)(v0_j)
        prev, y = jnp.zeros_like(cur), jnp.zeros((1, dim, 2), dt)
        for j0 in range(0, k, 64):
            seg = jx_lanczos._ritz_segment_fn(k, min(64, k - j0), n, df, None, 0)
            prev, cur, y = seg(perms, D_dev, no_lock, no_sigma, prev, cur, y,
                               jnp.asarray(al[:, None]), jnp.asarray(be[:, None]),
                               jnp.asarray(s[:, None, None]), j0)
        y = np.asarray(y)[0]
        return y[:, 0] + 1j * y[:, 1]

    def port_start():
        v = lanczos._scale(v0_t, torch_lanczos.inv(torch_lanczos.norm(v0_t)))
        return torch.zeros_like(v), v

    def port_pass2(al, be, s):
        prev, cur = port_start()
        y = torch.zeros((1, dim), dtype=torch.complex128)
        al, be, s = torch.tensor(al), torch.tensor(be), torch.tensor(s[:, None])
        for j in range(k):
            torch_lanczos.lanczos_replay(lanczos._matvec(prep, cur[None])[0], prev, cur,
                                         al, be, j, s, y)
            prev, cur = cur, prev
        return y.numpy()[0]

    # pass 1 with either package's matvec and step arithmetic, storing V
    to_lanes = lambda t: np.stack([t.numpy().real, t.numpy().imag], -1)
    from_lanes = lambda x: torch.tensor(np.asarray(x)[..., 0] + 1j * np.asarray(x)[..., 1])
    ref_mv = jax.jit(lambda vs: jx_lanczos._matvec_block(perms, D_dev, vs, n, df, None))

    @jax.jit
    def ref_step(hv, prev, cur, beta):
        w, v_prev, v_cur = (jx_lanczos._lanes_from_stacked(t, df) for t in (hv, prev, cur))
        w = jx_lanczos._v_axpy(v_prev, (-beta,), w, df)
        alpha = jx_lanczos._dot_real(v_cur, w, df)
        w = jx_lanczos._v_axpy(v_cur, tuple(-l for l in alpha), w, df)
        beta_next = jx_lanczos._s_sqrt(jx_lanczos._norm2(w, df), df)
        v_next = jx_lanczos._v_scale(w, jx_lanczos._s_inv(beta_next, df), df)
        return jx_lanczos._stack_lanes(v_next), alpha[0], beta_next[0]

    def pass1(matvec, step):
        prev, cur = port_start()
        al, be = torch.zeros(k, dtype=torch.float64), torch.zeros(k, dtype=torch.float64)
        V = np.zeros((k, dim), complex)
        for j in range(k):
            V[j] = cur.numpy()
            hv = (lanczos._matvec(prep, cur[None])[0] if matvec == "port"
                  else from_lanes(ref_mv(to_lanes(cur)[None])[0]))
            if step == "port":
                torch_lanczos.lanczos_step(hv, prev, cur, prev, al, be, j)
                prev, cur = cur, prev
            else:
                nxt, al_j, be_j = ref_step(to_lanes(hv), to_lanes(prev), to_lanes(cur),
                                           float(be[j - 1]) if j else 0.0)
                al[j], be[j] = float(al_j), float(be_j)
                prev, cur = cur, from_lanes(nxt)
        return al.numpy(), be.numpy(), V

    def ritz(al, be):
        """The tridiagonal's eigenpairs, ascending."""
        return eigh_tridiagonal(al, be[:-1])

    al_r, be_r = ref_pass1()
    al_p, be_p, V_p = pass1("port", "port")
    print("|alpha_j(port) - alpha_j(symmer_tpu)| at j = " + ", ".join(
        f"{j}: {abs(al_p[j] - al_r[j]):.1e}" for j in (0, 1, 2, 5, 10, 20, 40, 60, 100, 200)))

    s_of = {}
    for name, (al, be) in (("symmer_tpu", (al_r, be_r)), ("port", (al_p, be_p))):
        ev, S = ritz(al, be)
        scale = max(np.max(np.abs(ev)), 1.0)
        copies = int(np.sum(ev - ev[0] <= 1e-9 * scale))
        print(f"{name}: {copies} copies of the ground Ritz value, the lowest three at "
              f"E0 + {', '.join(f'{d:.1e}' for d in ev[:3] - ev[0])}")
        for i in range(3):
            w = np.abs(S[:, i])
            y = ref_pass2(al, be, S[:, i]) if name == "symmer_tpu" else S[:, i] @ V_p
            print(f"  copy {i}: weight by Krylov steps " + ", ".join(
                f"{lo}-{hi}: {np.linalg.norm(w[lo:hi]):.1e}" for lo, hi in RANGES)
                + f"; its Ritz vector: {noise(y)}, {qubits(y)} qubits")
        s_of[name] = S[:, 0]

    for scal, p2, fn in (("symmer_tpu", "symmer_tpu", ref_pass2), ("port", "port", port_pass2),
                         ("symmer_tpu", "port", port_pass2), ("port", "symmer_tpu", ref_pass2)):
        al, be = (al_r, be_r) if scal == "symmer_tpu" else (al_p, be_p)
        y = fn(al, be, s_of[scal])
        print(f"{scal} scalars through {p2}'s pass 2: {noise(y)}, {qubits(y)} qubits")

    for mv, st in (("symmer_tpu", "symmer_tpu"), ("symmer_tpu", "port"), ("port", "symmer_tpu")):
        al, be, V = pass1("ref" if mv == "symmer_tpu" else "port",
                          "ref" if st == "symmer_tpu" else "port")
        y = ritz(al, be)[1][:, 0] @ V
        print(f"pass 1 with {mv}'s matvec and {st}'s step: {noise(y)}, {qubits(y)} qubits")

    # the port's state under other orders of its sums
    def sequential(x):
        return torch.cumsum(x, -1)[..., -1]

    def eight_partials(x):
        s = torch.cumsum(x.reshape(*x.shape[:-1], -1, 8), -2)[..., -1, :]
        t = s[..., 0]
        for i in range(1, 8):
            t = t + s[..., i]
        return t

    pairwise = torch_lanczos.pairwise_sum
    for name, fn in (("sequential", sequential), ("eight running partial", eight_partials)):
        torch_lanczos.pairwise_sum = fn
        try:
            _, V = lanczos.lanczos_ground_state(*planes)
        finally:
            torch_lanczos.pairwise_sum = pairwise
        print(f"port with {name} sums: {noise(V[:, 0])}, {qubits(V[:, 0])} qubits")
    return 0


if __name__ == "__main__":
    sys.exit(main())
