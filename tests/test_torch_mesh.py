"""The mesh layer through the public API: symmer_torch against symmer_tpu.

symmer_tpu runs on its 8 virtual CPU devices (tests/conftest.py) under
``use_mesh(n_devices=N)``; the port under ``use_mesh(mesh=Mesh([cpu] * N))``
(N shards of the CPU device, the plain versions of its kernels).  The same
inputs, made with numpy, go through both packages and through the port's
one-device route.  The port's term order and the shard of a term differ
from symmer_tpu's (another row hash), so operators compare as term sets,
coefficients within 1e-12 relative; expectation values within 1e-10
relative (energies).  ``kernel_stats.mesh_calls`` shows each route taken
in both packages.
"""
import numpy as np
import pytest
import torch

import symmer_torch
import symmer_tpu
from symmer_torch import config as tconfig
from symmer_torch.parallel import mesh as tmesh
from symmer_torch.parallel import sharded as tsharded
from symmer_torch.profiling import kernel_stats as tstats
from symmer_tpu.config import config as jconfig
from symmer_tpu.profiling import kernel_stats as jstats

RTOL = 1e-12
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def low_mesh_threshold():
    old_t = (tconfig.backend, tconfig.device, tconfig.mesh_threshold, tconfig.mesh)
    old_j = (jconfig.backend, jconfig.mesh_threshold)
    tconfig.backend, tconfig.device, tconfig.mesh_threshold = "device", "cpu", 64
    jconfig.mesh_threshold = 64
    yield
    tconfig.backend, tconfig.device, tconfig.mesh_threshold, tconfig.mesh = old_t
    jconfig.backend, jconfig.mesh_threshold = old_j


def both(x, z, c, nq):
    return (symmer_tpu.PauliwordOp.from_planes(x, z, c, nq),
            symmer_torch.PauliwordOp.from_planes(x, z, c, nq))


def dup_planes(rng, nq, T, distinct, density=0.5):
    W = -(-nq // 64)
    mask = np.uint64((1 << nq % 64) - 1) if nq % 64 else np.uint64(2**64 - 1)

    def plane(n):
        p = np.zeros((n, W), np.uint64)
        for _ in range(int(1 / density)):
            p |= rng.integers(0, 2**63, (n, W), dtype=np.uint64) << np.uint64(1)
        p &= rng.integers(0, 2**63, (n, W), dtype=np.uint64) << np.uint64(1)
        p[:, -1] &= mask
        return p

    x, z = plane(distinct), plane(distinct)
    idx = rng.integers(0, distinct, T)
    return x[idx], z[idx], rng.normal(size=T) + 1j * rng.normal(size=T)


def assert_same_terms(got, want):
    d1, d2 = got.to_dictionary, want.to_dictionary
    assert set(d1) == set(d2)
    for k, v in d2.items():
        assert abs(d1[k] - v) <= RTOL * max(abs(d1[k]), abs(v)), (k, d1[k], v)


def run_all(N, fn_j, fn_t, kind):
    """symmer_tpu on N virtual devices, the port on N CPU shards and on one
    device; each mesh route taken once."""
    jstats.reset()
    with symmer_tpu.use_mesh(n_devices=N):
        out_j = fn_j()
    assert jstats.mesh_calls[kind] == 1
    tstats.reset()
    with symmer_torch.use_mesh(mesh=tmesh.Mesh([CPU] * N)) as mesh:
        assert tconfig.mesh is mesh and mesh.size == N
        out_t = fn_t()
    assert tstats.mesh_calls[kind] == 1
    tstats.reset()
    single = fn_t()
    assert tstats.mesh_calls[kind] == 0 and tstats.device_calls[kind] >= 1
    return out_j, out_t, single


N_SHARDS = [2, 4, 8]


@pytest.mark.parametrize("N", N_SHARDS)
def test_cleanup(N):
    rng = np.random.default_rng(N)
    opj, opt = both(*dup_planes(rng, 70, 1024, 300), 70)
    out_j, out_t, single = run_all(N, opj.cleanup, opt.cleanup, "cleanup")
    assert_same_terms(out_t, single)
    assert_same_terms(out_t, symmer_torch.PauliwordOp.from_planes(
        out_j.x_pack, out_j.z_pack, out_j.coeff_vec, 70))


@pytest.mark.parametrize("N", N_SHARDS)
def test_multiply(N):
    rng = np.random.default_rng(10 + N)
    aj, at = both(*dup_planes(rng, 70, 256, 100), 70)
    bj, bt = both(*dup_planes(rng, 70, 24, 24), 70)
    out_j, out_t, single = run_all(N, lambda: aj * bj, lambda: at * bt, "multiply")
    assert_same_terms(out_t, single)
    assert_same_terms(out_t, symmer_torch.PauliwordOp.from_planes(
        out_j.x_pack, out_j.z_pack, out_j.coeff_vec, 70))


@pytest.mark.parametrize("N", N_SHARDS)
def test_perform_rotations(N):
    """A non-Clifford sequence with Clifford runs between its rotations."""
    rng = np.random.default_rng(20 + N)
    opj, opt = both(*dup_planes(rng, 70, 512, 100), 70)
    rj, rt = [], []
    for angle in (0.25, None, np.pi / 2, 0.45):
        x, z, _ = dup_planes(rng, 70, 1, 1, density=0.1)
        pj, pt = both(x, z, np.ones(1, complex), 70)
        rj.append((pj, angle))
        rt.append((pt, angle))
    out_j, out_t, single = run_all(N, lambda: opj.perform_rotations(rj),
                                   lambda: opt.perform_rotations(rt), "perform_rotations")
    assert_same_terms(out_t, single)
    assert_same_terms(out_t, symmer_torch.PauliwordOp.from_planes(
        out_j.x_pack, out_j.z_pack, out_j.coeff_vec, 70))


def synthetic(rng, nq, T, n_sym):
    """bench.py:647-664: n_sym planted Z2 symmetries."""
    block = nq // n_sym
    xb = rng.integers(0, 2, (T, nq)).astype(bool)
    zb = rng.integers(0, 2, (T, nq)).astype(bool)
    for k in range(n_sym):
        parity = xb[:, k * block:(k + 1) * block].sum(axis=1) & 1
        xb[parity == 1, k * block] ^= True
    coeffs = (rng.integers(-8, 9, T) + 1j * rng.integers(-8, 9, T)).astype(complex)
    return np.hstack([xb, zb]), coeffs


@pytest.mark.parametrize("N", N_SHARDS)
def test_taper_projection(N):
    """QubitTapering.taper_it on an operator above the lowered threshold:
    the fused projection (clifford_rotate_project) on the mesh."""
    rng = np.random.default_rng(30 + N)
    symp, coeffs = synthetic(rng, 32, 600, 2)
    Hj = symmer_tpu.PauliwordOp(symp, coeffs).cleanup()
    Ht = symmer_torch.PauliwordOp(symp, coeffs).cleanup()
    ref = np.zeros(32, dtype=int)
    jconfig.backend = "device"
    out_j, out_t, single = run_all(
        N, lambda: symmer_tpu.QubitTapering(Hj).taper_it(ref_state=ref),
        lambda: symmer_torch.QubitTapering(Ht).taper_it(ref_state=ref),
        "clifford_rotate_project")
    assert out_t.n_qubits == out_j.n_qubits == 30
    assert_same_terms(out_t, single)
    assert_same_terms(out_t, symmer_torch.PauliwordOp.from_planes(
        out_j.x_pack, out_j.z_pack, out_j.coeff_vec, 30))


@pytest.mark.parametrize("N", N_SHARDS)
def test_expval(N):
    """<psi|O|psi> with the terms sharded: the partial sums added in shard
    order."""
    rng = np.random.default_rng(40 + N)
    nq, B, T = 40, 24, 600
    s = rng.integers(0, 2, (B, nq))
    amps = rng.normal(size=B) + 1j * rng.normal(size=B)
    psi_j = symmer_tpu.QuantumState(s, amps)
    psi_t = symmer_torch.QuantumState(s, amps)
    sp = psi_t._s_pack
    hop = rng.integers(0, B, (T // 2, 2))
    x = np.vstack([np.zeros((T - T // 2, sp.shape[1]), np.uint64), sp[hop[:, 0]] ^ sp[hop[:, 1]]])
    z = dup_planes(rng, nq, T, T, density=0.3)[1]
    opj, opt = both(x, z, rng.normal(size=T) + 1j * rng.normal(size=T), nq)
    e_j, e_t, e_1 = run_all(N, lambda: opj.expval(psi_j), lambda: opt.expval(psi_t), "expval")
    scale = max(abs(e_1), 1.0)
    assert abs(e_t - e_1) <= 1e-10 * scale and abs(e_t - e_j) <= 1e-10 * scale


def test_three_shards_take_the_one_device_route():
    """The exchange needs a power-of-two mesh: 3 shards return None and the
    call runs on one device; expval, a plain sum, runs on any mesh of 2+."""
    rng = np.random.default_rng(5)
    x, z, c = dup_planes(rng, 70, 512, 200)
    op = symmer_torch.PauliwordOp.from_planes(x, z, c, 70)
    mesh = tmesh.Mesh([CPU] * 3)
    assert not tsharded._usable(mesh) and tsharded._usable(tmesh.Mesh([CPU] * 4))
    assert tsharded.cleanup(x, z, c, 1e-15, mesh) is None
    single = op.cleanup()
    tstats.reset()
    with symmer_torch.use_mesh(mesh=mesh):
        out = op.cleanup()
        assert op.expval(symmer_torch.QuantumState(np.zeros((1, 70), int), [1.0])) is not None
    assert tstats.mesh_calls["cleanup"] == 0 and tstats.mesh_calls["expval"] == 1
    assert_same_terms(out, single)
    assert [(a == b).all() for a, b in ((out.x_pack, single.x_pack),)] == [True]


def test_mesh_threshold_gates_and_use_mesh_restores():
    rng = np.random.default_rng(6)
    op = symmer_torch.PauliwordOp.from_planes(*dup_planes(rng, 10, 32, 16), 10)
    assert tconfig.mesh is None
    mesh = tmesh.Mesh([CPU] * 2)
    tstats.reset()
    with symmer_torch.use_mesh(mesh=mesh) as m:
        assert tconfig.mesh is m is mesh
        op.cleanup()  # 32 terms, below the threshold of 64
        with symmer_torch.use_mesh(mesh=tmesh.Mesh([CPU] * 4)) as inner:
            assert tconfig.mesh is inner
        assert tconfig.mesh is mesh
    assert tconfig.mesh is None
    assert tstats.mesh_calls["cleanup"] == 0 and tstats.device_calls["cleanup"] == 1


def test_get_mesh_and_use_mesh_default():
    """With config.device = 'cpu' the default mesh is the one CPU device: a
    mesh the exchange rejects, so the routes stay on one device; with CUDA
    configured and absent it raises, as config.torch_device() does."""
    mesh = tmesh.get_mesh()
    assert mesh.devices == (CPU,) and mesh.axis_names == ("terms",)
    assert tmesh.get_mesh(axis_name="nu").axis_names == ("nu",)
    with symmer_torch.use_mesh() as m:
        assert m.size == 1 and not tsharded._usable(m)
    shards = tmesh.shard_terms(np.arange(10).reshape(5, 2), tmesh.Mesh([CPU] * 2))
    assert [s.tolist() for s in shards] == [[[0, 1], [2, 3], [4, 5]], [[6, 7], [8, 9], [0, 0]]]
    rep = tmesh.replicate(np.arange(3), tmesh.Mesh([CPU] * 2))
    assert rep[0] is rep[1] and rep[0].tolist() == [0, 1, 2]
    if not torch.cuda.is_available():
        tconfig.device = "cuda"
        with pytest.raises(RuntimeError, match="is_available"):
            tmesh.get_mesh()


def test_shards_of_another_device_type_are_refused():
    """No fallback that hides the device: a mesh whose shards are not of
    config.device's type raises in the routes and the brute force."""
    from symmer_torch.kernels import torch_noncon

    rng = np.random.default_rng(7)
    op = symmer_torch.PauliwordOp.from_planes(*dup_planes(rng, 70, 256, 100), 70)
    mesh = tmesh.Mesh(["meta"] * 2)
    with symmer_torch.use_mesh(mesh=mesh):
        with pytest.raises(ValueError, match="mesh shards on"):
            op.cleanup()
    F = rng.integers(0, 2, (8, 3))
    with pytest.raises(ValueError, match="mesh shards on"):
        torch_noncon.brute_force_minimise(F, np.zeros(8), rng.normal(size=8), np.ones(8),
                                          np.zeros((0, 8)), 3, CPU, mesh)


def test_distributed_init_single_process_noop():
    """No coordinator, one process: nothing is initialised, the local device
    count comes back and get_mesh spans it."""
    import torch.distributed as dist

    n = symmer_torch.distributed_init()
    assert n == 1 and tmesh.get_mesh().size == n
    assert not dist.is_initialized()


def test_distributed_init_explicit_group_and_launcher_env(monkeypatch):
    """Explicit arguments form a gloo group (one process on localhost); a
    launcher's variables that lead nowhere leave the process single."""
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    try:
        assert symmer_torch.distributed_init(f"127.0.0.1:{port}", num_processes=1,
                                             process_id=0) == 1
        assert dist.is_initialized() and dist.get_world_size() == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    import datetime

    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(port))
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    assert symmer_torch.distributed_init(timeout=datetime.timedelta(seconds=1)) == 1
    assert not dist.is_initialized()


def test_wide_multiply_and_commutes_match_the_host():
    """The word axis split over 8 shards (2000 qubits: 32 words, 4 a shard)."""
    mesh = tmesh.Mesh([CPU] * 8)
    rng = np.random.default_rng(21)
    for _ in range(4):
        a, b = (symmer_torch.PauliwordOp.from_planes(
            *dup_planes(rng, 2000, 1, 1), 2000) for _ in range(2))
        host = a * b
        out = tsharded.distributed_wide_multiply(a, b, mesh=mesh)
        assert np.array_equal(out.x_pack, host.x_pack)
        assert np.array_equal(out.z_pack, host.z_pack)
        assert np.allclose(out.coeff_vec, host.coeff_vec, rtol=0, atol=1e-14)
        assert tsharded.distributed_wide_commutes(a, b, mesh=mesh) == bool(a.commutes(b))
    with pytest.raises(ValueError):
        tsharded.distributed_wide_multiply(host + a, b, mesh=mesh)
    assert tsharded.distributed_wide_multiply(a, b) is None  # no mesh configured


def test_sharded_brute_force_against_symmer_tpu():
    """The noncontextual search split over the mesh (test_mesh.py:53's
    analogue): symmer_tpu's sharded result within 1e-12 relative, the
    port's one-device search bit for bit."""
    from symmer_torch.kernels import torch_noncon
    from symmer_tpu.kernels import jx_noncon
    from symmer_tpu.parallel.mesh import get_mesh

    rng = np.random.default_rng(1)
    M, n_free, n_cl = 60, 9, 3
    clique = rng.integers(-1, n_cl, M)
    args = (rng.integers(0, 2, (M, n_free)), rng.integers(0, 2, M), rng.normal(size=M),
            (clique < 0).astype(float),
            np.array([(clique == i) for i in range(n_cl)], float))
    e_j, k_j = jx_noncon.brute_force_minimise(*args, n_free, mesh=get_mesh(8))
    e_1, k_1 = torch_noncon.brute_force_minimise(*args, n_free, CPU)
    e_8, k_8 = torch_noncon.brute_force_minimise(*args, n_free, CPU, mesh=tmesh.Mesh([CPU] * 8))
    assert (e_8, k_8) == (e_1, k_1)
    assert abs(e_8 - e_j) <= RTOL * max(1.0, abs(e_j)) and k_8 == k_j


def test_noncontextual_solve_passes_the_mesh(monkeypatch):
    """NoncontextualOp's device search (2^10 assignments and more) hands
    config.mesh to the split, and the energy is the one-device search's."""
    from symmer_torch.kernels import torch_noncon
    from symmer_torch.operators import NoncontextualOp

    seen = []
    orig = torch_noncon.brute_force_minimise
    monkeypatch.setattr(torch_noncon, "brute_force_minimise",
                        lambda *a: seen.append(a[7]) or orig(*a))
    np.random.seed(2)
    tconfig.backend = "host"
    nc = NoncontextualOp.random(11, n_cliques=3, n_commuting_terms=100)
    tconfig.backend = "device"
    assert 1 << nc.symmetry_generators.n_terms >= 1024
    nc.solve()
    e_1 = nc.energy
    mesh = tmesh.Mesh([CPU] * 4)
    with symmer_torch.use_mesh(mesh=mesh):
        nc.solve()
    assert seen == [None, mesh]
    assert nc.energy == e_1
