"""The eigensolver slice: symmer_torch's Lanczos drivers against symmer_tpu.

The port runs on the CPU device here, so the kernel wrappers take their
plain torch versions (kernels/torch_lanczos.py).  Inputs are made with numpy
and handed to both packages.  Tolerances:
  - the group-diagonal table: bit for bit dense.group_diagonals and
    jx_lanczos._build_D_fn (float64 lanes, no double-float);
  - the grouped matvec: within 1e-14 relative of jx_lanczos._matvec_block
    (another summation order), and of the reference's per-term
    dense.matvec_device_fn;
  - energies: within 1e-10 of symmer_tpu's on the same operator; a
    non-degenerate state's overlap with symmer_tpu's at least 1 - 1e-8,
    eigenvector residuals below 1e-8;
  - prepare_operator's MemoryError: raised for exactly the (G, n) for which
    symmer_tpu's prepare_operator raises.
"""
import itertools

import numpy as np
import pytest
import torch

import symmer_tpu
import symmer_torch
from symmer_tpu.kernels import dense as jdense
from symmer_tpu.kernels import jx_lanczos
from symmer_torch import config as tconfig
from symmer_torch.kernels import cuda, lanczos, torch_lanczos
from symmer_torch.kernels import dense as tdense
from symmer_torch.operators import from_numpy_planes

from .conftest import dense_op

E_TOL = 1e-10


@pytest.fixture(autouse=True)
def cpu_device():
    old = tconfig.device
    tconfig.device = "cpu"
    yield
    tconfig.device = old


def hermitian(seed, n_qubits, n_terms):
    """(symmer_tpu op, symmer_torch op) of one random Hermitian operator."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2, (n_terms, n_qubits)).astype(bool)
    z = rng.integers(0, 2, (n_terms, n_qubits)).astype(bool)
    c = rng.normal(size=n_terms) + 1j * rng.normal(size=n_terms)
    op = symmer_tpu.PauliwordOp(np.hstack([x, z]), c)
    op = (op + op.dagger).multiply_by_constant(0.5).cleanup()
    return op, both(op)


def both(op):
    return from_numpy_planes(op.x_pack, op.z_pack, op.coeff_vec, op.n_qubits)


def doubled(seed):
    """h (2 qubits) tensor I: every eigenvalue twice."""
    op, _ = hermitian(seed, 2, 6)
    op = op.tensor(symmer_tpu.PauliwordOp.from_dictionary({"I": 1.0}))
    return op, both(op)


def planes(op):
    return op.x_pack, op.z_pack, op.coeff_vec, op.n_qubits


def assert_same_states(V1, V2, M=None, evals=None):
    """Columns equal up to a global phase each (overlap >= 1 - 1e-8)."""
    for i in range(V1.shape[1]):
        assert abs(np.vdot(V1[:, i], V2[:, i])) >= 1 - 1e-8
    if M is not None:
        for e, y in zip(evals, V2.T):
            assert np.linalg.norm(M @ y - e * y) < 1e-8


# -- the two kernels' plain versions -------------------------------------------

@pytest.mark.parametrize("n", [1, 3, 6, 8])
def test_build_group_diagonals_equals_host_and_jax_build(n):
    op, _ = hermitian(n, n, 4 * n + 3)
    ux, gidx, z_int, ph = jdense.group_scatter_inputs(*planes(op))
    _, host = jdense.group_diagonals(*planes(op))
    G = ux.shape[0]
    got = torch_lanczos.build_group_diagonals(
        torch.tensor(gidx), torch.tensor(z_int), torch.tensor(ph), G, n).numpy()
    assert np.array_equal(got.view(np.int64), host.view(np.int64))
    lanes = np.stack([ph.real, ph.imag], axis=-1)
    jax_D = np.asarray(jx_lanczos._build_D_fn(G, 1 << n, 2, False)(
        gidx.astype(np.int32), z_int.astype(np.int32), lanes))
    assert np.array_equal(np.stack([got.real, got.imag], -1).view(np.int64),
                          jax_D.view(np.int64))


@pytest.mark.parametrize("n,b", [(4, 1), (6, 3), (7, 4)])
def test_group_matvec_equals_jx_matvec_block(n, b):
    op, _ = hermitian(10 + n, n, 6 * n)
    ux, Dc = jdense.group_diagonals(*planes(op))
    rng = np.random.default_rng(n)
    V = rng.normal(size=(b, 1 << n)) + 1j * rng.normal(size=(b, 1 << n))
    got = torch_lanczos.group_matvec(torch.tensor(ux), torch.tensor(Dc), torch.tensor(V)).numpy()
    ux_b, D_b = jx_lanczos._ship_groups(ux, Dc, False, np.float64, np.int32)
    V_s = np.stack([V.real, V.imag], axis=-1)
    want = np.asarray(jx_lanczos._matvec_block((ux_b,), D_b, V_s, n, False, None))
    want = want[..., 0] + 1j * want[..., 1]
    assert np.abs(got - want).max() <= 1e-14 * np.abs(want).max()
    assert np.allclose(got, (dense_op(op) @ V.T).T, rtol=0, atol=1e-13 * np.abs(want).max())


@pytest.mark.parametrize("n,b", [(6, 1), (8, 2), (10, 4)])
def test_terms_matvec_equals_table_matvec(n, b):
    """The recomputing matvec's plain version on prepare_operator's sorted
    terms: group_matvec of the host table within 1e-13 of ||out||, and
    symmer_tpu's _matvec_block on the same table."""
    op, top = hermitian(60 + n, n, 8 * n)
    prep = lanczos.prepare_operator(*planes(top))
    rng = np.random.default_rng(n)
    V = rng.normal(size=(b, 1 << n)) + 1j * rng.normal(size=(b, 1 << n))
    got = cuda.group_matvec(prep.ux, prep.off, prep.z, prep.ph, torch.tensor(V)).numpy()
    ux, Dc = jdense.group_diagonals(*planes(op))
    want = torch_lanczos.group_matvec(torch.tensor(ux), torch.tensor(Dc), torch.tensor(V)).numpy()
    ux_b, D_b = jx_lanczos._ship_groups(ux, Dc, False, np.float64, np.int32)
    jax = np.asarray(jx_lanczos._matvec_block((ux_b,), D_b, np.stack([V.real, V.imag], -1),
                                              n, False, None))
    scale = np.linalg.norm(want)
    assert np.abs(got - want).max() <= 1e-13 * scale
    assert np.abs(got - (jax[..., 0] + 1j * jax[..., 1])).max() <= 1e-13 * scale


def test_matvec_device_fn_equals_reference():
    op, _ = hermitian(3, 5, 17)
    x_int, z_int = jdense.plane_ints(op.x_pack, 5), jdense.plane_ints(op.z_pack, 5)
    y = np.bitwise_count(op.x_pack & op.z_pack).sum(axis=1)
    pc = np.array([1, -1j, -1, 1j])[y % 4] * op.coeff_vec
    v = np.array([1, 1j]) @ np.random.default_rng(0).normal(size=(2, 32))
    want = np.asarray(jdense.matvec_device_fn(5)(x_int, z_int, pc, v))
    got = tdense.matvec_device_fn(5)(x_int, z_int, pc, torch.tensor(v)).numpy()
    assert np.abs(got - want).max() <= 1e-14 * np.abs(want).max()


@pytest.mark.parametrize("n", [12, 15, 17, 18, 20])
def test_prepare_operator_memory_error_matches_reference(monkeypatch, n):
    """For G around symmer_tpu's budget edge at each n, the port raises
    exactly where symmer_tpu does; nothing is built (both packages' builds
    are replaced by stubs)."""
    import symmer_torch.kernels.lanczos as tl

    def fake_inputs(G):
        return lambda x, z, c, nq: (np.arange(G), np.zeros(1, int), np.zeros(1, int),
                                    np.zeros(1, complex))

    monkeypatch.setattr(jx_lanczos, "_ship_groups_device", lambda *a: (None, None))
    monkeypatch.setattr(jx_lanczos, "_ship_groups", lambda *a: (None, None))
    monkeypatch.setattr(jdense, "group_diagonals", lambda *a: (None, None))
    monkeypatch.setattr(cuda, "build_group_diagonals", lambda *a: torch.zeros(1))
    # the first G whose counted table passes 2 GiB, and a few around it
    edge = next(G for G in itertools.count(1) if tl.reference_table_bytes(G, n) > 2 << 30)
    outcomes = set()
    for G in sorted({1, 2, edge // 2, edge // 2 + 1, edge - 1, edge, edge + 1, 3 * edge}):
        monkeypatch.setattr(jdense, "group_scatter_inputs", fake_inputs(G))
        monkeypatch.setattr(tdense, "group_scatter_inputs", fake_inputs(G))
        try:
            jx_lanczos.prepare_operator(None, None, None, n)
            jax_raises = False
        except MemoryError:
            jax_raises = True
        try:
            lanczos.prepare_operator(None, None, None, n)
            port_raises = False
        except MemoryError:
            port_raises = True
        assert port_raises == jax_raises, (G, n)
        outcomes.add(port_raises)
    assert outcomes == {False, True}


def test_prepare_operator_counts_what_it_allocates():
    """The grouped terms (ux, offsets, Z patterns, phases) and, on the CPU
    device only, the table; the terms sorted by group, stably."""
    op, top = hermitian(5, 6, 30)
    prep = lanczos.prepare_operator(*planes(top))
    G, T = jdense.group_count(op.x_pack, 6), op.n_terms
    assert prep.D.shape == (G, 64)
    assert prep.nbytes == G * 8 + (G + 1) * 4 + T * (4 + 16) + G * 64 * 16
    ux, gidx, z_int, ph = jdense.group_scatter_inputs(*planes(op))
    order = np.argsort(gidx, kind="stable")
    assert np.array_equal(prep.ux.numpy(), ux)
    assert np.array_equal(prep.off.numpy(), np.searchsorted(gidx[order], np.arange(G + 1)))
    assert np.array_equal(prep.z.numpy(), z_int[order]) and np.array_equal(prep.ph.numpy(), ph[order])


# -- the drivers against symmer_tpu ------------------------------------------

def test_lanczos_ground_state_matches_symmer_tpu():
    op, top = hermitian(21, 6, 24)
    M = dense_op(op)
    ej, Vj = jx_lanczos.lanczos_ground_state(*planes(op))
    et, Vt = lanczos.lanczos_ground_state(*planes(top))
    assert abs(et[0] - ej[0]) < E_TOL and abs(et[0] - np.linalg.eigvalsh(M)[0]) < E_TOL
    assert_same_states(Vj, Vt, M, et)


def run_recording(monkeypatch, fn):
    """(result, alphas, betas) of fn(), the scalars as the steps stored them."""
    seen = []
    plain = cuda.lanczos_step
    monkeypatch.setattr(cuda, "lanczos_step", lambda *a: seen.append(a[4:6]) or plain(*a))
    out = fn()
    monkeypatch.setattr(cuda, "lanczos_step", plain)
    return out, seen[-1][0].clone(), seen[-1][1].clone()


def same_bits(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and np.array_equal(a.view(np.int64), b.view(np.int64))


@pytest.mark.parametrize("which", ["H2", "LiH", "random16"])
def test_lanczos_independent_of_thread_count(monkeypatch, h2_fixture, which):
    """On the CPU device the recurrence has no BLAS call and its sums are
    pairwise trees: under 1 and 4 torch threads the alphas, betas, Ritz
    values and Ritz vectors are bit for bit the same (16 qubits: 2^16
    rows, where torch splits elementwise work across threads; LiH and the
    random operator with a short k, which needs no convergence).  H2's
    ground energy stays within 1e-10 of symmer_tpu's."""
    from .conftest import load_reference_hamiltonian

    k = 0
    if which == "H2":
        op = symmer_tpu.PauliwordOp.from_dictionary(h2_fixture["H_dict"])
    elif which == "LiH":
        op, k = symmer_tpu.PauliwordOp.from_dictionary(
            load_reference_hamiltonian("LiH_STO-3G_SINGLET_JW.json")["hamiltonian"]), 60
    else:
        op, k = hermitian(16, 16, 12)[0], 24
    runs = []
    old = torch.get_num_threads()
    try:
        for threads in (1, 4):
            torch.set_num_threads(threads)
            runs.append(run_recording(monkeypatch, lambda: lanczos.lanczos_ground_state(
                *planes(both(op)), k=k, n_eigs=2, _retry=0)))
    finally:
        torch.set_num_threads(old)
    ((e1, v1), a1, b1), ((e4, v4), a4, b4) = runs
    assert same_bits(a1.numpy(), a4.numpy()) and same_bits(b1.numpy(), b4.numpy())
    assert same_bits(e1, e4) and same_bits(v1, v4)
    if which == "H2":
        ej, _ = jx_lanczos.lanczos_ground_state(*planes(op))
        assert abs(e1[0] - ej[0]) < E_TOL


def test_plain_replay_rebuilds_the_step():
    """The plain pass-2 step rebuilds pass 1's v_{j+1} bit for bit from the
    scalars pass 1 stored, and adds S[j] v_cur into the Ritz vectors; it
    only reads hv."""
    rng = np.random.default_rng(3)
    vec = lambda: torch.tensor(rng.normal(size=256) + 1j * rng.normal(size=256))
    hv, v_prev, v_cur = vec(), vec(), vec()
    alphas, betas = torch.zeros(4, dtype=torch.float64), torch.tensor(rng.random(4) + 0.5)
    p1 = [t.clone() for t in (hv, v_prev, v_cur)]
    torch_lanczos.lanczos_step(*p1, p1[1], alphas, betas, 2)
    S = torch.tensor(rng.normal(size=(4, 2)))
    y = torch.zeros((2, 256), dtype=torch.complex128)
    p2 = [t.clone() for t in (hv, v_prev, v_cur)]
    torch_lanczos.lanczos_replay(*p2, alphas, betas, 2, S, y)
    assert same_bits(torch.view_as_real(p2[1]).numpy(), torch.view_as_real(p1[1]).numpy())
    assert torch.equal(p2[0], hv)
    assert torch.equal(y, S[2][:, None] * v_cur[None])
    assert abs(float(torch_lanczos.norm(p1[1])) - 1) < 1e-14


def test_lanczos_excited_states_distinct_match():
    op, top = hermitian(22, 5, 16)
    ej, _ = jx_lanczos.lanczos_ground_state(*planes(op), n_eigs=3)
    et, _ = lanczos.lanczos_ground_state(*planes(top), n_eigs=3)
    assert np.abs(et - ej).max() < 1e-7  # the higher Ritz values converge less
    assert abs(et[0] - ej[0]) < E_TOL and np.all(np.diff(et) > 1e-9)


def test_pass_two_replays_pass_one_bitwise(monkeypatch):
    """Every vector that pass 2 hands the matvec is bit for bit the one of
    the same step in pass 1 (the scalar driver on its replay route, where
    the basis is not kept, and the block driver)."""
    seen = []
    plain = lanczos._matvec
    monkeypatch.setattr(lanczos, "_matvec",
                        lambda prep, V, out=None: seen.append(V.clone()) or plain(prep, V, out))
    monkeypatch.setattr(lanczos, "keeps_basis", lambda *a: False)
    _, top = hermitian(23, 6, 20)
    for k, run in ((40, lambda: lanczos.lanczos_ground_state(*planes(top), k=40)),
                   (12, lambda: lanczos.lanczos_block_eigsh(*planes(top), n_vecs=3, k=12))):
        seen.clear()
        run()
        assert len(seen) >= 2 * k
        for a, b in zip(seen[:k], seen[k:2 * k]):
            assert torch.equal(torch.view_as_real(a), torch.view_as_real(b))


@pytest.mark.parametrize("which", ["H2", "LiH", "random16", "deflated", "retry"])
def test_basis_route_equals_replay_route(monkeypatch, h2_fixture, which):
    """Pass 2 from the Krylov basis that pass 1 keeps (one lanczos_ritz) and
    by replaying pass 1 (a matvec and a lanczos_replay a step, the rule
    patched) give bit for bit the same energies and vectors: H2, LiH and a
    16-qubit operator, two deflated sweeps of lanczos_lowest_eigsh, and a
    run that retries twice from k = 4 (each attempt asks the rule anew)."""
    from .conftest import load_reference_hamiltonian

    if which == "H2":
        op, k = symmer_tpu.PauliwordOp.from_dictionary(h2_fixture["H_dict"]), 0
    elif which == "LiH":
        op, k = symmer_tpu.PauliwordOp.from_dictionary(
            load_reference_hamiltonian("LiH_STO-3G_SINGLET_JW.json")["hamiltonian"]), 60
    elif which == "random16":
        op, k = hermitian(16, 16, 12)[0], 24
    else:
        op, k = hermitian(23, 6, 20)[0], 4
    args = planes(both(op))
    if which == "deflated":
        solve = lambda: lanczos.lanczos_lowest_eigsh(*args, n_vecs=2)
    elif which == "retry":
        solve = lambda: lanczos.lanczos_ground_state(*args, k=k, _retry=2)
    else:
        solve = lambda: lanczos.lanczos_ground_state(*args, k=k, n_eigs=2, _retry=0)
    rule, ritz, replay = lanczos.keeps_basis, cuda.lanczos_ritz, cuda.lanczos_replay
    runs = {}
    for route in ("basis", "replay"):
        seen = {"k": [], "ritz": 0, "replay": 0}

        def asked(kk, dim, dev, route=route, seen=seen):
            seen["k"].append(kk)
            return rule(kk, dim, dev) and route == "basis"

        monkeypatch.setattr(lanczos, "keeps_basis", asked)
        monkeypatch.setattr(cuda, "lanczos_ritz",
                            lambda *a, seen=seen: seen.__setitem__("ritz", seen["ritz"] + 1)
                            or ritz(*a))
        monkeypatch.setattr(cuda, "lanczos_replay",
                            lambda *a, seen=seen: seen.__setitem__("replay", seen["replay"] + 1)
                            or replay(*a))
        runs[route] = (solve(), seen)
    ((e1, v1), s1), ((e2, v2), s2) = runs["basis"], runs["replay"]
    assert same_bits(e1, e2) and same_bits(v1, v2)
    assert s1["replay"] == 0 and s1["ritz"] == (2 if which == "deflated" else 1)
    assert s2["ritz"] == 0 and s2["replay"] > 0
    assert s1["k"] == s2["k"]
    if which == "retry":
        assert s1["k"] == [4, 8, 16]


def test_ritz_from_basis_equals_the_replay_loop():
    """ritz_from_basis over the first k_eff rows of a basis that plain pass-1
    steps wrote row by row is bit for bit the y of k_eff plain replay steps
    (m = 3 Ritz vectors, k_eff < k, signed zeros in S)."""
    rng = np.random.default_rng(4)
    dim, k, k_eff = 128, 9, 7
    vec = lambda: torch.tensor(rng.normal(size=dim) + 1j * rng.normal(size=dim))
    alphas, betas = torch.zeros(k, dtype=torch.float64), torch.zeros(k, dtype=torch.float64)
    basis = torch.empty((k + 1, dim), dtype=torch.complex128)
    basis[0] = vec() / 12.0
    his = []
    for j in range(k):
        hv = vec()
        his.append(hv.clone())
        prev = basis[j - 1] if j else torch.zeros(dim, dtype=torch.complex128)
        torch_lanczos.lanczos_step(hv, prev, basis[j], basis[j + 1], alphas, betas, j)
    S = torch.tensor(rng.normal(size=(k_eff, 3)))
    S[2, 1] = -0.0
    v_prev, v_cur = torch.zeros(dim, dtype=torch.complex128), basis[0].clone()
    y = torch.zeros((3, dim), dtype=torch.complex128)
    for j in range(k_eff):
        torch_lanczos.lanczos_replay(his[j], v_prev, v_cur, alphas, betas, j, S, y)
        assert same_bits(torch.view_as_real(v_prev).numpy(),
                         torch.view_as_real(basis[j + 1]).numpy())
        v_prev, v_cur = v_cur, v_prev
    got = cuda.lanczos_ritz(basis, S, k_eff)
    assert same_bits(torch.view_as_real(got).numpy(), torch.view_as_real(y).numpy())


def test_lanczos_lowest_eigsh_multiplicity_matches():
    op, top = doubled(31)
    M = dense_op(op)
    ej, Vj = jx_lanczos.lanczos_lowest_eigsh(*planes(op), n_vecs=4)
    et, Vt = lanczos.lanczos_lowest_eigsh(*planes(top), n_vecs=4)
    assert np.abs(et - ej).max() < E_TOL
    assert np.allclose(et, np.linalg.eigvalsh(M)[:4], atol=E_TOL)
    assert np.allclose(Vt.conj().T @ Vt, np.eye(4), atol=1e-8)
    for e, y in zip(et, Vt.T):
        assert np.linalg.norm(M @ y - e * y) < 1e-8


def test_lanczos_lowest_eigsh_positive_complement_matches():
    d = {"IYI": -0.914978610534862, "XII": -0.4789641639460487,
         "III": 0.9330343570099389, "ZYI": 0.923948417825471}
    op = symmer_tpu.PauliwordOp.from_dictionary(d)
    ej, _ = jx_lanczos.lanczos_lowest_eigsh(*planes(op), n_vecs=3)
    et, _ = lanczos.lanczos_lowest_eigsh(*planes(both(op)), n_vecs=3)
    assert len(et) == 3 and np.abs(et - ej).max() < E_TOL
    assert np.allclose(et, np.linalg.eigvalsh(dense_op(op))[:3], atol=E_TOL)


def test_lanczos_lowest_eigsh_stop_callback_matches():
    op, top = hermitian(32, 4, 10)
    calls = {}
    for name, fn, o in (("jax", jx_lanczos.lanczos_lowest_eigsh, op),
                        ("port", lanczos.lanczos_lowest_eigsh, top)):
        log = calls.setdefault(name, [])

        def stop(vals, vecs, log=log):
            log.append((len(vals), vecs.shape))
            return len(vals) >= 2

        ev, V = fn(*planes(o), n_vecs=5, stop=stop)
        assert len(ev) == 2 and V.shape == (16, 2)
        calls[name + "_evals"] = ev
    assert calls["jax"] == calls["port"] == [(1, (16, 1)), (2, (16, 2))]
    assert np.abs(calls["jax_evals"] - calls["port_evals"]).max() < E_TOL


@pytest.mark.parametrize("which,block", [("doubled", None), ("random", 3)])
def test_lanczos_block_eigsh_matches(which, block):
    op, top = doubled(41) if which == "doubled" else hermitian(42, 5, 18)
    M = dense_op(op)
    n = 4 if which == "doubled" else 5
    ej, Vj = jx_lanczos.lanczos_block_eigsh(*planes(op), n_vecs=n, block=block)
    et, Vt = lanczos.lanczos_block_eigsh(*planes(top), n_vecs=n, block=block)
    assert np.abs(et - ej).max() < E_TOL
    assert np.allclose(et, np.linalg.eigvalsh(M)[:n], atol=E_TOL)
    for e, y in zip(et, Vt.T):
        assert np.linalg.norm(M @ y - e * y) < 1e-8
    if which == "random":
        assert_same_states(Vj[:, :1], Vt[:, :1])


def test_lanczos_block_eigsh_identity_breakdown_matches():
    """H = 2 I: the block recurrence breaks down at the first residual (pure
    rounding noise); both packages keep only the start block."""
    op = symmer_tpu.PauliwordOp.from_dictionary({"III": 2.0})
    ej, Vj = jx_lanczos.lanczos_block_eigsh(*planes(op), n_vecs=3, block=2)
    et, Vt = lanczos.lanczos_block_eigsh(*planes(both(op)), n_vecs=3, block=2)
    assert len(et) == len(ej) == 2
    assert np.allclose(et, 2.0, atol=E_TOL)
    assert np.allclose(Vt.conj().T @ Vt, np.eye(2), atol=1e-8)


def test_block_qr_mgs_matches_and_replays():
    rng = np.random.default_rng(5)
    W = rng.normal(size=(4, 64)) + 1j * rng.normal(size=(4, 64))
    W[3] = W[0] + 2 * W[1]  # a dependent column: a zero diagonal of R
    Qj, Rre_j, Rim_j = jx_lanczos._block_qr_mgs(np.stack([W.real, W.imag], -1), False)
    Qt, Rre, Rim = lanczos._block_qr_mgs(torch.tensor(W))
    Qj = np.asarray(Qj)
    assert np.allclose(Qt.numpy()[:3], Qj[:3, :, 0] + 1j * Qj[:3, :, 1], atol=1e-14)
    assert np.allclose(Rre.numpy(), np.asarray(Rre_j)[..., 0], atol=1e-13)
    assert np.allclose(Rim.numpy(), np.asarray(Rim_j)[..., 0], atol=1e-13)
    assert float(Rre[3, 3]) < 1e-13
    again = lanczos._block_apply_inv_R(torch.tensor(W), Rre, Rim)
    assert torch.equal(torch.view_as_real(again), torch.view_as_real(Qt))


# -- the public wrappers -----------------------------------------------------

def test_exact_gs_energy_device_h2_matches(h2_fixture):
    from symmer_tpu.utils import exact_gs_energy_device as jax_gs
    from symmer_torch.utils import exact_gs_energy_device

    op = symmer_tpu.PauliwordOp.from_dictionary(h2_fixture["H_dict"])
    H = both(op)
    gs, psi = exact_gs_energy_device(H)
    gs_j, psi_j = jax_gs(op)
    assert abs(gs - h2_fixture["fci_energy"]) < E_TOL and abs(gs - gs_j) < E_TOL
    assert abs(float(np.real(H.expval(psi.normalize))) - gs) < E_TOL
    assert abs(np.vdot(psi_j.to_sparse_matrix.toarray().ravel(),
                       psi.to_sparse_matrix.toarray().ravel())) >= 1 - 1e-8


def test_exact_gs_energy_device_particle_number_matches(h2_fixture):
    from symmer_tpu.utils import exact_gs_energy_device as jax_gs
    from symmer_torch.utils import exact_gs_energy_device

    N = {"IIII": 2.0, "ZIII": -0.5, "IZII": -0.5, "IIZI": -0.5, "IIIZ": -0.5}
    op = symmer_tpu.PauliwordOp.from_dictionary(h2_fixture["H_dict"])
    gs, _ = exact_gs_energy_device(both(op), n_particles=2, n_eigs=4,
                                   number_operator=symmer_torch.PauliwordOp.from_dictionary(N))
    gs_j, _ = jax_gs(op, n_particles=2, n_eigs=4,
                     number_operator=symmer_tpu.PauliwordOp.from_dictionary(N))
    assert abs(gs - h2_fixture["fci_energy"]) < 1e-8 and abs(gs - gs_j) < E_TOL


@pytest.mark.parametrize("H,N,n_particles,energy,index", [
    # an 8-fold ground multiplet with no sector match: the budget grows to
    # the level above, where |1111> lives
    ({"ZIII": -2.0}, {"IIII": 2.0, "ZIII": -0.5, "IZII": -0.5, "IIZI": -0.5, "IIIZ": -0.5},
     4, 2.0, 15),
    # the 2-particle state inside the degenerate ground space of -Z0 Z1
    ({"ZZ": -1.0}, {"II": 1.0, "ZI": -0.5, "IZ": -0.5}, 2, -1.0, 3),
])
def test_exact_gs_energy_device_sector_in_multiplet(H, N, n_particles, energy, index):
    from symmer_torch.utils import exact_gs_energy_device

    gs, psi = exact_gs_energy_device(
        symmer_torch.PauliwordOp.from_dictionary(H), n_particles=n_particles,
        number_operator=symmer_torch.PauliwordOp.from_dictionary(N))
    assert abs(gs - energy) < 1e-9
    assert abs(abs(psi.to_dense_matrix.reshape(-1)[index]) - 1.0) < 1e-9


@pytest.mark.parametrize("method", ["block", "deflate", "auto"])
def test_exact_lowest_states_device_matches(method):
    from symmer_tpu.utils import exact_lowest_states_device as jax_low
    from symmer_torch.utils import exact_lowest_states_device

    op, top = doubled(51)
    M = dense_op(op)
    et, states = exact_lowest_states_device(top, 3, method=method)
    ej, _ = jax_low(op, 3, method="deflate" if method == "deflate" else "block")
    assert len(states) == 3 and np.abs(et - ej).max() < E_TOL
    assert np.allclose(et, np.linalg.eigvalsh(M)[:3], atol=E_TOL)
    for e, psi in zip(et, states):
        assert abs(top.expval(psi.normalize) - e) < 1e-8


@pytest.mark.parametrize("method,band_passes,sweeps", [("auto", 0, 3), ("deflate", 0, 3),
                                                       ("block", 1, 0)])
def test_exact_lowest_states_device_routes(method, band_passes, sweeps):
    """'auto' runs the deflated restarts (three sweeps for three states);
    'block' finishes in one band pass, without deflated sweeps, where it
    converges."""
    from symmer_torch.profiling import kernel_stats
    from symmer_torch.utils import exact_lowest_states_device

    _, top = doubled(51)
    kernel_stats.reset()
    exact_lowest_states_device(top, 3, method=method)
    assert kernel_stats.device_calls["lanczos_block_eigsh"] == band_passes
    assert kernel_stats.device_calls["lanczos_ground_state"] == sweeps


def test_exact_lowest_states_device_block_falls_back_on_identity():
    from symmer_tpu.utils import exact_lowest_states_device as jax_low
    from symmer_torch.utils import exact_lowest_states_device

    d = {"II": -1.5}
    et, states = exact_lowest_states_device(symmer_torch.PauliwordOp.from_dictionary(d), 3,
                                            method="block")
    ej, _ = jax_low(symmer_tpu.PauliwordOp.from_dictionary(d), 3, method="block")
    assert len(states) == 3 and np.allclose(et, -1.5, atol=E_TOL)
    assert np.abs(et - ej).max() < E_TOL


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, top = hermitian(1, 3, 5)
    tconfig.device = "cuda"
    with pytest.raises(RuntimeError, match="is_available"):
        lanczos.prepare_operator(*planes(top))


def test_block_eigsh_drops_ghosts_on_a_molecule():
    """LiH (12 qubits): the band recurrence runs long past convergence and
    returns copies of the ground pair (symmer_tpu's block driver reports
    the ground energy twice here); the port keeps the distinct ones, equal
    to scipy's eigsh with multiplicity."""
    from scipy.sparse.linalg import eigsh

    from .conftest import load_reference_hamiltonian

    data = load_reference_hamiltonian("LiH_STO-3G_SINGLET_JW.json")
    H = symmer_torch.PauliwordOp.from_dictionary(data["hamiltonian"])
    want = np.sort(eigsh(H.to_sparse_matrix, k=4, which="SA")[0])
    et, Vt = lanczos.lanczos_block_eigsh(*planes(H), n_vecs=4)
    assert np.abs(et - want).max() < 1e-9
    assert np.allclose(Vt.conj().T @ Vt, np.eye(4), atol=1e-8)
