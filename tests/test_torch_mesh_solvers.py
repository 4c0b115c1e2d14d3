"""The eigensolvers and the VQE engine on a mesh: symmer_torch against symmer_tpu.

symmer_tpu runs on its 8 virtual CPU devices (tests/conftest.py) under
``use_mesh(n_devices=N)`` or with ``mesh=get_mesh(N)``; the port on
``Mesh([cpu] * N)``, where the Lanczos matvec's rows are split into one
block a shard (the plain row-range matvec on the CPU device) and the VQE
objective's terms into one slice a shard.  Inputs are made with numpy and
handed to both packages.  Tolerances:
  - eigenvalues within 1e-10 of symmer_tpu's; Ritz vectors equal up to a
    phase, |<y_tpu|y_port>| >= 1 - 1e-8 as in tests/test_torch_lanczos.py
    (both drivers stop at a Paige residual of 1e-9 of the spectral scale,
    so single components differ by ~1e-8; a degenerate cluster: the
    singular values of the overlap of the two bases);
  - the port's mesh route bit for bit its own one-device route (the row
    blocks of the plain matvec are its whole product's rows);
  - the VQE energy within 1e-12 and the gradient within 1e-10 of
    ``jx_vqe`` under the mesh and of the port's one-device engine (the
    shards' sums add the terms in another order);
  - prepare_operator's MemoryError: raised for exactly the budgets for
    which symmer_tpu's raises, with the mesh's shards counted.
"""
import numpy as np
import pytest
import torch

import symmer_torch
import symmer_tpu
from symmer_tpu.evolution import jx_vqe
from symmer_tpu.kernels import dense as jdense
from symmer_tpu.kernels import jx_lanczos
from symmer_tpu.parallel.mesh import get_mesh as jax_mesh
from symmer_tpu.profiling import kernel_stats as jstats
from symmer_tpu.utils import exact_gs_energy_device as jax_gs
from symmer_tpu.utils import exact_lowest_states_device as jax_low

from symmer_torch import config as tconfig
from symmer_torch.evolution import VQE_Driver, device_vqe
from symmer_torch.kernels import cuda, lanczos, torch_lanczos
from symmer_torch.operators import from_numpy_planes, from_numpy_state
from symmer_torch.parallel.mesh import Mesh
from symmer_torch.profiling import kernel_stats as tstats
from symmer_torch.utils import exact_gs_energy_device, exact_lowest_states_device

from .conftest import H2_JW_DICT, dense_op, load_reference_hamiltonian

E_TOL = 1e-10
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def cpu_device():
    old = (tconfig.device, tconfig.mesh)
    tconfig.device = "cpu"
    yield
    tconfig.device, tconfig.mesh = old


def port_mesh(N):
    return Mesh([CPU] * N)


def top(op):
    return from_numpy_planes(op.x_pack, op.z_pack, op.coeff_vec, op.n_qubits)


def tstate(psi):
    return from_numpy_state(psi._s_pack, psi._amps, psi.n_qubits)


def planes(op):
    return op.x_pack, op.z_pack, op.coeff_vec, op.n_qubits


def hermitian(seed, n_qubits, n_terms):
    """A random Hermitian symmer_tpu operator."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2, (n_terms, n_qubits)).astype(bool)
    z = rng.integers(0, 2, (n_terms, n_qubits)).astype(bool)
    c = rng.normal(size=n_terms) + 1j * rng.normal(size=n_terms)
    op = symmer_tpu.PauliwordOp(np.hstack([x, z]), c)
    return (op + op.dagger).multiply_by_constant(0.5).cleanup()


def lih_taper():
    """Tapered LiH (8 qubits), its tapered UCCSD operator and reference state."""
    data = load_reference_hamiltonian("LiH_STO-3G_SINGLET_JW.json")
    QT = symmer_tpu.QubitTapering(symmer_tpu.PauliwordOp.from_dictionary(data["hamiltonian"]))
    H = QT.taper_it(ref_state=np.asarray(data["data"]["hf_array"]))
    CC = QT.taper_it(aux_operator=symmer_tpu.PauliwordOp.from_dictionary(
        data["data"]["auxiliary_operators"]["UCCSD_operator"]))
    return H, CC, QT.tapered_ref_state.normalize


def h2_taper():
    """Tapered H2 (1 qubit) and its reference state."""
    QT = symmer_tpu.QubitTapering(symmer_tpu.PauliwordOp.from_dictionary(H2_JW_DICT))
    return QT.taper_it(ref_state=np.array([1, 1, 0, 0])), QT.tapered_ref_state.normalize


def same_bits(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and np.array_equal(a.view(np.int64), b.view(np.int64))


def assert_same_states(evals, V1, V2):
    """Equal eigenspaces: for each cluster of eigenvalues within 1e-8, the
    singular values of V1^H V2 over the cluster at least 1 - 1e-8 (the
    overlap's modulus for a single vector: equal up to a phase)."""
    i = 0
    while i < len(evals):
        j = i + 1
        while j < len(evals) and evals[j] - evals[i] <= 1e-8:
            j += 1
        s = np.linalg.svd(V1[:, i:j].conj().T @ V2[:, i:j], compute_uv=False)
        assert s.min() >= 1 - 1e-8, (i, j, s)
        i = j


# -- the row-range matvec ----------------------------------------------------

@pytest.mark.parametrize("b", [1, 4])
def test_row_range_matvec_is_the_whole_products_rows(b):
    """The plain versions with rows=(r0, r1), table and terms, bit for bit
    the whole product's rows for random blocks (a single row, unaligned
    edges, all rows)."""
    op = hermitian(70 + b, 9, 60)
    prep = lanczos.prepare_operator(*planes(top(op)))
    rng = np.random.default_rng(b)
    V = torch.tensor(rng.normal(size=(b, 512)) + 1j * rng.normal(size=(b, 512)))
    terms = (prep.ux, prep.off, prep.z, prep.ph)
    whole_table = torch_lanczos.group_matvec(prep.ux, prep.D, V)
    whole_terms = cuda.group_matvec(*terms, V)
    blocks = [(0, 512), (0, 1), (511, 512), (128, 256)]
    blocks += [tuple(sorted(rng.choice(513, 2, replace=False))) for _ in range(6)]
    for r0, r1 in blocks:
        got = torch_lanczos.group_matvec(prep.ux, prep.D, V, (r0, r1))
        assert got.shape == (b, r1 - r0)
        assert torch.equal(torch.view_as_real(got), torch.view_as_real(whole_table[:, r0:r1]))
        got = cuda.group_matvec(*terms, V, rows=(r0, r1))
        assert torch.equal(torch.view_as_real(got), torch.view_as_real(whole_terms[:, r0:r1]))
    for bad in ((3, 3), (-1, 4), (0, 513)):
        with pytest.raises(ValueError, match="not a range"):
            torch_lanczos.group_matvec(prep.ux, prep.D, V, bad)


# -- the table budget under a mesh --------------------------------------------

def _decisions(op, budget, N, monkeypatch):
    """(symmer_tpu raises, the port raises) MemoryError in prepare_operator
    with both budgets set to `budget` bytes, on N shards (N = 1: no mesh)."""
    monkeypatch.setattr(jx_lanczos, "_D_BUDGET_BYTES", budget)
    monkeypatch.setattr(lanczos, "_D_BUDGET_BYTES", budget)
    out = []
    for prepare, mesh in ((jx_lanczos.prepare_operator, jax_mesh(N) if N > 1 else None),
                          (lanczos.prepare_operator, port_mesh(N) if N > 1 else None)):
        try:
            prepare(*planes(op), mesh=mesh)
            out.append(False)
        except MemoryError:
            out.append(True)
    return tuple(out)


def test_mesh_budget_solves_what_one_device_cannot(monkeypatch):
    """A budget between the operator's counted table and twice it: both
    packages raise MemoryError on one device, and both solve on a 2-shard
    mesh (the port's budget used to ignore the mesh), the energies within
    1e-10."""
    op = hermitian(3, 7, 30)
    counted = lanczos.reference_table_bytes(jdense.group_count(op.x_pack, 7), 7)
    budget = counted * 3 // 4
    assert budget < counted < 2 * budget
    monkeypatch.setattr(jx_lanczos, "_D_BUDGET_BYTES", budget)
    monkeypatch.setattr(lanczos, "_D_BUDGET_BYTES", budget)
    with pytest.raises(MemoryError):
        jax_gs(op)
    with pytest.raises(MemoryError):
        exact_gs_energy_device(top(op))
    with symmer_tpu.use_mesh(n_devices=2):
        e_j, _ = jax_gs(op)
    with symmer_torch.use_mesh(mesh=port_mesh(2)):
        e_t, _ = exact_gs_energy_device(top(op))
    assert abs(e_t - e_j) < E_TOL
    assert abs(e_t - np.linalg.eigvalsh(dense_op(op))[0]) < E_TOL


@pytest.mark.parametrize("N", [2, 4])
def test_mesh_budget_edge_matches_reference(monkeypatch, N):
    """On both sides of the edge budget * N == counted (strictly greater
    raises), the port's MemoryError decision is symmer_tpu's."""
    op = hermitian(3, 7, 30)
    counted = lanczos.reference_table_bytes(jdense.group_count(op.x_pack, 7), 7)
    edge = -(-counted // N)
    seen = set()
    for budget in (edge - 1, edge, counted - 1, counted):
        jax_raises, port_raises = _decisions(op, budget, N, monkeypatch)
        assert port_raises == jax_raises, (N, budget)
        assert port_raises == (counted > budget * N)
        seen.add(port_raises)
    assert seen == {False, True}
    assert _decisions(op, counted - 1, 1, monkeypatch) == (True, True)


# -- the drivers against symmer_tpu ------------------------------------------

@pytest.mark.parametrize("system", ["random7", "lih"])
def test_lanczos_drivers_on_a_mesh(system):
    """The three drivers under a mesh (a 7-qubit operator on 8 shards,
    tapered LiH on 2): eigenvalues within 1e-10 of symmer_tpu's on its
    mesh and of the dense spectrum, the same eigenspaces, and (on the
    7-qubit operator) bit for bit the port's one-device run; both packages
    record the mesh route.  symmer_tpu's block driver keeps its ghosts
    (ROADMAP Queue 3: tapered LiH's ground energy comes back twice), so
    there each of its values is one of the port's and the ground states
    compare.  Tapered LiH takes two deflated sweeps, not three: each sweep
    compiles symmer_tpu's segments anew (the locked count is static)."""
    if system == "random7":
        op, N, n_low = hermitian(21, 7, 30), 8, 3
    else:
        op, N, n_low = lih_taper()[0], 2, 2
    exact = np.linalg.eigvalsh(dense_op(op))
    jm, tm = jax_mesh(N), port_mesh(N)
    assert lanczos.prepare_operator(*planes(top(op)), mesh=tm).mesh is tm
    for name, kw in (("lanczos_ground_state", {}), ("lanczos_lowest_eigsh", dict(n_vecs=n_low)),
                     ("lanczos_block_eigsh", dict(n_vecs=3))):
        jstats.reset()
        tstats.reset()
        ej, Vj = getattr(jx_lanczos, name)(*planes(op), mesh=jm, **kw)
        et, Vt = getattr(lanczos, name)(*planes(op), mesh=tm, **kw)
        kind = "lanczos_block_eigsh" if name == "lanczos_block_eigsh" else "lanczos_ground_state"
        assert jstats.mesh_calls[kind] >= 1 and tstats.mesh_calls[kind] >= 1, name
        assert np.abs(et - exact[:len(et)]).max() < E_TOL, name
        if name == "lanczos_block_eigsh":
            assert len(et) == len(ej) and all(np.abs(et - e).min() < E_TOL for e in ej)
            assert_same_states(et[:1], Vj[:, :1], Vt[:, :1])
        else:
            assert len(et) == len(ej) and np.abs(et - ej).max() < E_TOL, name
            assert_same_states(et, Vj, Vt)
        if system == "random7":
            e1, V1 = getattr(lanczos, name)(*planes(op), **kw)
            assert same_bits(et, e1) and same_bits(Vt, V1), name


def test_pass_two_replays_pass_one_on_a_mesh(monkeypatch):
    """Every vector that pass 2 hands the row-sharded matvec on the replay
    route (the basis rule patched to refuse) is bit for bit the one of the
    same step in pass 1; with the basis kept, pass 2 makes no matvec and
    gives the same state bit for bit."""
    seen = []
    plain = lanczos._matvec_mesh
    monkeypatch.setattr(lanczos, "_matvec_mesh",
                        lambda prep, V, out=None: seen.append(V.clone()) or plain(prep, V, out))
    op = hermitian(23, 6, 20)
    e_kept, v_kept = lanczos.lanczos_ground_state(*planes(op), k=40, mesh=port_mesh(4))
    assert len(seen) == 40
    seen.clear()
    monkeypatch.setattr(lanczos, "keeps_basis", lambda *a: False)
    e, v = lanczos.lanczos_ground_state(*planes(op), k=40, mesh=port_mesh(4))
    assert len(seen) == 80
    for a, b in zip(seen[:40], seen[40:]):
        assert torch.equal(torch.view_as_real(a), torch.view_as_real(b))
    assert same_bits(e, e_kept) and same_bits(v, v_kept)


def test_exact_gs_energy_device_particle_number_on_a_mesh(h2_fixture):
    """The sector search (deflated sweeps from one prepared operator) under
    use_mesh: symmer_tpu's energy within 1e-10 and the port's one-device
    result bit for bit."""
    Nop = {"IIII": 2.0, "ZIII": -0.5, "IZII": -0.5, "IIZI": -0.5, "IIIZ": -0.5}
    op = symmer_tpu.PauliwordOp.from_dictionary(h2_fixture["H_dict"])
    kw = dict(n_particles=2, n_eigs=4)
    with symmer_tpu.use_mesh(n_devices=2):
        jstats.reset()
        e_j, _ = jax_gs(op, number_operator=symmer_tpu.PauliwordOp.from_dictionary(Nop), **kw)
        assert jstats.mesh_calls["lanczos_ground_state"] >= 1
    nop = symmer_torch.PauliwordOp.from_dictionary(Nop)
    with symmer_torch.use_mesh(mesh=port_mesh(2)):
        tstats.reset()
        e_t, psi_t = exact_gs_energy_device(top(op), number_operator=nop, **kw)
        assert tstats.mesh_calls["lanczos_ground_state"] >= 1
    e_1, psi_1 = exact_gs_energy_device(top(op), number_operator=nop, **kw)
    assert abs(e_t - e_j) < E_TOL and abs(e_t - h2_fixture["fci_energy"]) < 1e-8
    assert same_bits(e_t, e_1)
    assert same_bits(psi_t.to_dense_matrix, psi_1.to_dense_matrix)


@pytest.mark.parametrize("method", ["block", "deflate"])
def test_exact_lowest_states_device_on_a_mesh(method):
    op = hermitian(31, 6, 24)
    with symmer_tpu.use_mesh(n_devices=4):
        e_j, _ = jax_low(op, 3, method=method)
    with symmer_torch.use_mesh(mesh=port_mesh(4)):
        e_t, s_t = exact_lowest_states_device(top(op), 3, method=method)
    e_1, s_1 = exact_lowest_states_device(top(op), 3, method=method)
    assert len(e_t) == 3 and np.abs(e_t - e_j).max() < E_TOL
    assert same_bits(e_t, e_1)
    assert all(same_bits(a.to_dense_matrix, b.to_dense_matrix) for a, b in zip(s_t, s_1))


def test_mesh_that_fails_mesh_ok_runs_one_device():
    """8 shards cannot split 2^(4 // 2) = 4 rows of symmer_tpu's table: both
    packages run one device, with the same energy."""
    op = hermitian(5, 4, 12)
    with symmer_tpu.use_mesh(n_devices=8):
        jstats.reset()
        e_j, _ = jax_gs(op)
    assert jstats.mesh_calls["lanczos_ground_state"] == 0
    assert jstats.device_calls["lanczos_ground_state"] >= 1
    with symmer_torch.use_mesh(mesh=port_mesh(8)):
        assert lanczos.prepare_operator(*planes(top(op)), mesh=tconfig.mesh).mesh is None
        tstats.reset()
        e_t, _ = exact_gs_energy_device(top(op))
    assert tstats.mesh_calls["lanczos_ground_state"] == 0
    assert tstats.device_calls["lanczos_ground_state"] >= 1
    assert abs(e_t - e_j) < E_TOL
    assert not lanczos._mesh_ok(port_mesh(3), 8) and lanczos._mesh_ok(port_mesh(4), 4)
    assert not lanczos._mesh_ok(port_mesh(1), 8) and not lanczos._mesh_ok(None, 8)


# -- the VQE engine ------------------------------------------------------------

def _vqe_system(system):
    if system == "h2":
        H, ref = h2_taper()
        return H, symmer_tpu.PauliwordOp.from_list(["Y", "X"]), ref
    H, CC, ref = lih_taper()
    return H, CC, ref


@pytest.mark.parametrize("system,N", [("h2", 2), ("lih", 2), ("lih", 3)])
def test_vqe_engine_on_a_mesh(system, N):
    """The engine under use_mesh: the terms cut into N slices (3 shards, not
    a power of two, and H2's 1-qubit taper, where only the VQE shards):
    energy within 1e-12 and gradient within 1e-10 of jx_vqe on symmer_tpu's
    mesh and of the port's one-device engine."""
    H, gens, ref = _vqe_system(system)
    gens = symmer_tpu.PauliwordOp.from_planes(gens.x_pack, gens.z_pack,
                                              np.ones(gens.n_terms), gens.n_qubits)
    with symmer_tpu.use_mesh(n_devices=N):
        want = jx_vqe.DeviceVQEEngine(H, gens, ref)
    with symmer_torch.use_mesh(mesh=port_mesh(N)):
        got = device_vqe.DeviceVQEEngine(top(H), top(gens), tstate(ref))
    one = device_vqe.DeviceVQEEngine(top(H), top(gens), tstate(ref))
    assert got.mesh is not None and got.mesh.size == N and len(got._H) == N
    assert one.mesh is None and len(one._H) == 1
    rng = np.random.default_rng(N)
    for _ in range(2):
        x = rng.normal(size=gens.n_terms) * 0.3
        e = got.loss(x)
        assert abs(e - want.loss(x)) <= 1e-12 and abs(e - one.loss(x)) <= 1e-12
        g = got.gradient(x)
        assert np.abs(g - want.gradient(x)).max() <= 1e-10
        assert np.abs(g - one.gradient(x)).max() <= 1e-10


def test_vqe_driver_on_a_mesh_reaches_fci():
    """VQE_Driver.run (BFGS) with device_array under use_mesh reaches the
    tapered H2 ground energy within 1e-6, as tests/test_evolution/
    test_variational.py runs symmer_tpu's; the engine is the mesh's."""
    H, ref = h2_taper()
    fci = np.linalg.eigvalsh(dense_op(H))[0]
    with symmer_torch.use_mesh(mesh=port_mesh(2)):
        drv = VQE_Driver(top(H), excitation_ops=symmer_torch.PauliwordOp.from_list(["Y"]),
                         ref_state=tstate(ref))
        drv.verbose = False
        drv.expectation_eval = "device_array"
        out, _ = drv.run(x0=np.array([0.1]), method="BFGS")
        assert drv._device_engine().mesh is tconfig.mesh
    assert abs(out["fun"] - fci) < 1e-6


def test_vqe_engine_key_depends_on_the_mesh():
    H, ref = h2_taper()
    args = (top(H), symmer_torch.PauliwordOp.from_list(["Y"]), tstate(ref))
    k1 = device_vqe.DeviceVQEEngine.key(*args)
    with symmer_torch.use_mesh(mesh=port_mesh(2)):
        k2 = device_vqe.DeviceVQEEngine.key(*args)
    with symmer_torch.use_mesh(mesh=port_mesh(4)):
        k4 = device_vqe.DeviceVQEEngine.key(*args)
    assert len({k1, k2, k4}) == 3
    assert k1 == device_vqe.DeviceVQEEngine.key(*args)


def test_pool_gradient_is_one_device_under_a_mesh():
    """device_pool_gradient ignores the mesh, as symmer_tpu's does: bit for
    bit the one-device result, and within 1e-10 of jx_vqe's."""
    H, pool, ref = lih_taper()
    pool = symmer_tpu.PauliwordOp.from_planes(pool.x_pack, pool.z_pack, np.ones(pool.n_terms),
                                              pool.n_qubits)
    gens = symmer_tpu.PauliwordOp.from_planes(pool.x_pack[:3], pool.z_pack[:3], np.ones(3),
                                              pool.n_qubits)
    x = np.array([0.1, -0.2, 0.3])
    args = (top(H), top(gens), tstate(ref), top(pool), x)
    one = device_vqe.device_pool_gradient(*args)
    with symmer_torch.use_mesh(mesh=port_mesh(2)):
        sharded = device_vqe.device_pool_gradient(*args)
    assert same_bits(sharded, one)
    want = jx_vqe.device_pool_gradient(H, gens, ref, pool, x)
    assert np.abs(one - want).max() <= 1e-10
