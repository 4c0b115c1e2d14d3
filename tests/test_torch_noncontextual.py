"""The noncontextual machinery: symmer_torch against symmer_tpu.

check_noncontextual_adj against jx_core's; the plain brute-force search
(the K12 plain version) against jx_noncon, energies within 1e-12 relative
and indices equal wherever the minimum is separated from the next energy by
more than 1e-12 relative; AntiCommutingOp.unitary_partitioning (seq_rot,
LCU), NoncontextualOp.from_hamiltonian, solve and get_energies_batch against
symmer_tpu.  Random operators come from symmer_tpu's generators under a
seeded global numpy RNG, built once and carried across as planes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symmer_tpu
import symmer_torch
from symmer_tpu.config import config as jconfig
from symmer_tpu.kernels import jx_core, jx_noncon, np_core, pack
from symmer_torch import config as tconfig
from symmer_torch.kernels import dispatch as tdispatch
from symmer_torch.kernels import torch_core, torch_noncon
from symmer_torch.operators import from_numpy_planes
from symmer_torch.profiling import kernel_stats

from .conftest import load_reference_hamiltonian

RTOL = 1e-12


@pytest.fixture(autouse=True)
def device_backends(monkeypatch):
    old = (tconfig.backend, tconfig.device, jconfig.backend)
    tconfig.backend, tconfig.device, jconfig.backend = "device", "cpu", "host"
    # the small inputs here take the device path of every entry
    monkeypatch.setattr(tdispatch, "DEVICE_FLOOR", 0)
    yield
    tconfig.backend, tconfig.device, jconfig.backend = old


def to_torch(op):
    return from_numpy_planes(op.x_pack, op.z_pack, op.coeff_vec, op.n_qubits)


def noncontextual_on_host(op_j):
    """The port's NoncontextualOp of a symmer_tpu operator, built on the
    port's host path: the same generators, in the same order, as
    symmer_tpu's host path finds (the device cleanup orders terms
    differently, and the generators it finds are an equivalent set)."""
    backend, tconfig.backend = tconfig.backend, "host"
    try:
        return symmer_torch.operators.NoncontextualOp.from_PauliwordOp(to_torch(op_j))
    finally:
        tconfig.backend = backend


def assert_same_op(a, b, rtol=RTOL):
    assert a.n_qubits == b.n_qubits and a.n_terms == b.n_terms
    ra, rb = np.hstack([a.x_pack, a.z_pack]), np.hstack([b.x_pack, b.z_pack])
    oa, ob = np.lexsort(ra.T[::-1]), np.lexsort(rb.T[::-1])
    assert np.array_equal(ra[oa], rb[ob])
    ca, cb = a.coeff_vec[oa], b.coeff_vec[ob]
    scale = np.maximum(np.maximum(np.abs(ca), np.abs(cb)), np.finfo(float).tiny)
    assert np.all(np.abs(ca - cb) <= rtol * scale)


def random_noncontextual(seed, n_qubits, n_cliques, n_commuting_terms=None):
    np.random.seed(seed)
    return symmer_tpu.operators.NoncontextualOp.random(
        n_qubits=n_qubits, n_cliques=n_cliques, n_commuting_terms=n_commuting_terms
    )


# -- check_noncontextual_adj ------------------------------------------------------

def adjacency_case(seed, n_qubits, n_cliques, variant):
    """(x, z): a noncontextual operator, the same with one term added that
    makes it contextual, or with identity padding rows (which commute with
    everything)."""
    nc = random_noncontextual(seed, n_qubits, n_cliques)
    x, z = nc.x_pack, nc.z_pack
    if variant == "padded":
        pad = np.zeros((3, x.shape[1]), np.uint64)
        return np.vstack([x, pad]), np.vstack([z, pad])
    if variant == "contextual":
        rng = np.random.default_rng(seed)
        for _ in range(100):
            xx = np.vstack([x, pack.pack_bits(rng.random((1, n_qubits)) < 0.5, n_qubits)])
            zz = np.vstack([z, pack.pack_bits(rng.random((1, n_qubits)) < 0.5, n_qubits)])
            if not symmer_torch.operators.check_adjmat_noncontextual(
                ~np_core.anticommutes(xx, zz, xx, zz)
            ):
                return xx, zz
        raise AssertionError("no contextual extension found")
    return x, z


@pytest.mark.parametrize("variant", ["noncontextual", "contextual", "padded"])
@pytest.mark.parametrize("seed,n_qubits,n_cliques", [(1, 4, 3), (2, 5, 2), (3, 3, 5)])
def test_check_noncontextual_adj_matches_jx_core(seed, n_qubits, n_cliques, variant):
    x, z = adjacency_case(seed, n_qubits, n_cliques, variant)
    adj = ~np_core.anticommutes(x, z, x, z)
    got = bool(torch_core.check_noncontextual_adj(torch.from_numpy(adj)))
    want = bool(jx_core.check_noncontextual_adj(jnp.asarray(adj)))
    assert got == want == symmer_torch.operators.check_adjmat_noncontextual(adj)
    assert got is (variant != "contextual")


@pytest.mark.parametrize("n_rows,n_cols", [(1, 1), (3, 70), (65, 64), (130, 129)])
def test_pack_bool_rows_matches_pack_bits(n_rows, n_cols):
    a = np.random.default_rng(n_cols).random((n_rows, n_cols)) < 0.5
    got = torch_core.pack_bool_rows(torch.from_numpy(a)).numpy().view(np.uint64)
    assert np.array_equal(got, pack.pack_bits(a, n_cols))


# -- the brute-force search -------------------------------------------------------

def search_inputs(seed, M, n_free, n_cliques, degenerate=False):
    """jx_noncon's arguments from a seeded generator: each term in S0 or in
    exactly one clique."""
    rng = np.random.default_rng(seed)
    F = rng.integers(0, 2, (M, n_free)).astype(float)
    if degenerate:
        F[:, 0] = 0  # a generator no term uses: every energy appears twice
    fixed = rng.integers(0, 2, M).astype(float)
    base = rng.normal(size=M)
    clique = rng.integers(-1, n_cliques, M) if n_cliques else np.full(M, -1)
    mCi = np.array([(clique == i).astype(float) for i in range(n_cliques)]).reshape(-1, M)
    return F, fixed, base, (clique < 0).astype(float), mCi


def all_energies(F, fixed, base, mS0, mCi, n_free):
    """Host energies of every assignment, in enumeration order."""
    k = np.arange(1 << n_free)
    neg = 1 - ((k[:, None] >> np.arange(n_free - 1, -1, -1)) & 1)
    par = (neg @ F.T + fixed[None, :]) % 2
    signed = (1 - 2 * par) * base[None, :]
    return signed @ mS0 - np.sqrt(((signed @ mCi.T) ** 2).sum(axis=1))


@pytest.mark.parametrize("M,n_free,n_cliques,degenerate", [
    (5, 1, 0, False), (40, 6, 3, False), (300, 10, 2, False), (64, 8, 0, False),
    (50, 7, 4, True), (17, 12, 1, False), (200, 9, 3, True),
])
def test_brute_force_matches_jx_noncon(M, n_free, n_cliques, degenerate):
    args = search_inputs(M + n_free, M, n_free, n_cliques, degenerate)
    e_j, k_j = jx_noncon.brute_force_minimise(*args, n_free)
    e_t, k_t = torch_noncon.brute_force_minimise(*args, n_free, torch.device("cpu"))
    assert abs(e_t - e_j) <= RTOL * max(1.0, abs(e_j))
    E = all_energies(*args, n_free)
    assert abs(E[k_t] - e_t) <= RTOL * max(1.0, abs(e_t))
    second = np.partition(E, 1)[1]
    if second - E.min() > RTOL * max(1.0, abs(E.min())):
        assert k_t == k_j == int(np.argmin(E))
    else:  # a near-tie: any index whose energy reaches the minimum
        assert E[k_t] - E.min() <= RTOL * max(1.0, abs(E.min()))
    assert np.array_equal(torch_noncon.nu_from_index(k_t, n_free),
                          jx_noncon.nu_from_index(k_t, n_free))


def test_brute_force_chunks_and_all_terms_in_s0():
    """Chunked enumeration (several chunks, the fold across them) and an
    operator with every term in S0."""
    F, fixed, base, mS0, mCi = search_inputs(9, 30, 9, 0)
    dev = torch.device("cpu")
    g, b, off, nc = torch_noncon.kernel_inputs(F, fixed, base, mS0, mCi, dev)
    assert nc == 0 and off.tolist() == [0, 30]
    e1, k1 = torch_noncon.brute_force_plain(g, b, off, 9, nc)
    e2, k2 = torch_noncon.brute_force_plain(g, b, off, 9, nc, chunk=7)
    assert float(e1) == float(e2) and int(k1) == int(k2)
    E = all_energies(F, fixed, base, mS0, mCi, 9)
    assert int(k1) == int(np.argmin(E))


def test_kernel_inputs_segments_and_checks():
    F, fixed, base, mS0, mCi = search_inputs(4, 12, 3, 2)
    g, b, off, nc = torch_noncon.kernel_inputs(F, fixed, base, mS0, mCi, torch.device("cpu"))
    clique = np.where(mS0 > 0, -1, np.argmax(mCi, axis=0))
    assert off.tolist() == [0, *np.cumsum([np.sum(clique == c) for c in (-1, 0, 1)])]
    order = np.argsort(clique, kind="stable")
    weights = 1 << np.arange(2, -1, -1)
    assert np.array_equal(g.numpy() & 0x7FFFFFFF, (F[order] @ weights).astype(np.int64))
    assert np.array_equal(g.numpy() >> 31, fixed[order].astype(np.int64))
    assert np.array_equal(b.numpy(), base[order])
    bad = mCi.copy()
    bad[:, 0] = 1
    with pytest.raises(ValueError, match="more than one clique"):
        torch_noncon.kernel_inputs(F, fixed, base, (bad.sum(0) == 0).astype(float), bad, "cpu")
    with pytest.raises(ValueError, match="complement"):
        torch_noncon.kernel_inputs(F, fixed, base, np.ones(12), mCi, "cpu")
    with pytest.raises(ValueError, match="not in"):
        torch_noncon.kernel_inputs(np.zeros((12, 32)), fixed, base, mS0, mCi, "cpu")


# -- operators ----------------------------------------------------------------------

@pytest.mark.parametrize("up_method", ["seq_rot", "LCU"])
@pytest.mark.parametrize("n_qubits,s_index", [(2, None), (3, None), (3, 2)])
def test_unitary_partitioning_matches_symmer_tpu(up_method, n_qubits, s_index):
    """On the port's host path (as symmer_tpu's runs at this size): the
    same decomposition, term by term."""
    tconfig.backend = "host"
    np.random.seed(10 + n_qubits)
    ac_j = symmer_tpu.operators.AntiCommutingOp.from_PauliwordOp(
        symmer_tpu.utils.random_anitcomm_2n_1_PauliwordOp(n_qubits)
    )
    ac_t = symmer_torch.operators.AntiCommutingOp.from_PauliwordOp(to_torch(ac_j))
    got = ac_t.unitary_partitioning(s_index=s_index, up_method=up_method)
    want = ac_j.unitary_partitioning(s_index=s_index, up_method=up_method)
    assert_same_op(got[0], want[0])
    assert len(got[1]) == len(want[1])
    for (r_t, a_t), (r_j, a_j) in zip(got[1], want[1]):
        assert_same_op(r_t, r_j)
        assert abs(a_t - a_j) <= RTOL * max(1.0, abs(a_j))
    assert abs(got[2] - want[2]) <= RTOL * want[2]
    assert_same_op(got[3], want[3])
    if up_method == "LCU":
        assert_same_op(ac_t.R_LCU, ac_j.R_LCU)


@pytest.fixture(scope="module")
def lih_pair():
    data = load_reference_hamiltonian("LiH_STO-3G_SINGLET_JW.json")
    H_j = symmer_tpu.PauliwordOp.from_dictionary(data["hamiltonian"])
    hf = np.asarray(data["data"]["hf_array"])
    return to_torch(H_j), H_j, hf


@pytest.mark.parametrize("strategy", ["diag", "SingleSweep_magnitude"])
def test_from_hamiltonian_and_solve_match_symmer_tpu(lih_pair, strategy):
    """On the port's device path: equal term sets and energies."""
    H_t, H_j, hf = lih_pair
    nc_t = symmer_torch.operators.NoncontextualOp.from_hamiltonian(H_t, strategy=strategy)
    nc_j = symmer_tpu.operators.NoncontextualOp.from_hamiltonian(H_j, strategy=strategy)
    assert_same_op(nc_t, nc_j)
    assert nc_t.n_cliques == nc_j.n_cliques
    assert nc_t.symmetry_generators.n_terms == nc_j.symmetry_generators.n_terms
    for ref in (None, hf):
        nc_t.solve(ref_state=ref)
        nc_j.solve(ref_state=ref)
        assert abs(nc_t.energy - nc_j.energy) <= RTOL * abs(nc_j.energy)


@pytest.mark.parametrize("n_cliques", [0, 3])
def test_solve_on_the_device_search(n_cliques, monkeypatch):
    """A search of >= 1024 assignments takes the device brute force (here
    its plain version) and reaches symmer_tpu's host energy."""
    nc_j = random_noncontextual(20 + n_cliques, 11, n_cliques, n_commuting_terms=100)
    nc_t = noncontextual_on_host(nc_j)
    free = nc_t.symmetry_generators.n_terms
    assert 1 << free >= 1024
    nc_j.solve()
    calls = []
    orig = torch_noncon.brute_force_minimise
    monkeypatch.setattr(torch_noncon, "brute_force_minimise",
                        lambda *a: calls.append(1) or orig(*a))
    nc_t.solve()
    assert calls == [1]
    assert abs(nc_t.energy - nc_j.energy) <= RTOL * max(1.0, abs(nc_j.energy))


def test_get_energies_batch_device_matches_host():
    nc_j = random_noncontextual(7, 7, 3)
    nc_t = noncontextual_on_host(nc_j)
    G = nc_t.symmetry_generators.n_terms
    nu = 2 * np.random.default_rng(0).integers(0, 2, (1500, G)) - 1
    dev = nc_t.get_energies_batch(nu)  # K >= 1024 on backend 'device'
    tconfig.backend = "host"
    host = nc_t.get_energies_batch(nu)
    want = nc_j.get_energies_batch(nu)
    scale = np.maximum(1.0, np.abs(host))
    assert np.all(np.abs(dev - host) <= RTOL * scale)
    assert np.all(np.abs(host - want) <= RTOL * scale)


def test_is_noncontextual_operator_paths_agree():
    """PauliwordOp.is_noncontextual: the device check (>= 1024 rows under
    backend 'device') and the host adjacency path give symmer_tpu's answer."""
    nc_j = random_noncontextual(5, 10, 3)
    H_t = to_torch(nc_j)
    kernel_stats.reset()
    assert H_t.is_noncontextual and kernel_stats.device_calls["is_noncontextual"] == 1
    tconfig.backend = "host"
    assert to_torch(nc_j).is_noncontextual
