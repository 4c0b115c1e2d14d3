"""The VQE engine's runs over coset tiles and its X-grouped overlaps
(symmer_torch/kernels/torch_vqe.py) on the CPU, against symmer_tpu.

The plain versions of the redesigned K15 kernels, which the CPU device
runs and which the kernels equal bit for bit on the card:

  - the fused forward (``rotate_runs``) bit for bit against P sequential
    ``rotate`` calls, on random generators cut into many runs and on the
    H2 taper's;
  - the run partition (``plan_runs``): every x of a run lies in its tile's
    subspace S, dim S = d <= d_max with the low row bits in S, the cosets
    partition the rows, B(m_k) = x_k and the tile-coordinate signs agree
    with the rows';
  - the adjoint sweep's gradient within 1e-10 of ``jx_vqe``'s jax.grad
    and within 1e-12 of torch.autograd through ``torch_vqe.energy`` (the
    same float64 operations, summed in another order); the sweep consumes
    the saved vectors, so a second backward through one graph raises, as
    it does on the card;
  - the X-grouped pool gradient within 1e-10 of ``jx_vqe``'s
    ``_jitted_pool_grad`` (through ``device_pool_gradient``);
  - VQE_Driver.run and ADAPT_VQE.optimize on tapered H2 and LiH with the
    generators cut into many small runs, their energies within 1e-8 of
    symmer_tpu's, as tests/test_torch_evolution.py pins them with the
    default runs.
"""
import numpy as np
import pytest
import torch

from symmer_tpu import PauliwordOp as JOp
from symmer_tpu.evolution import jx_vqe
from symmer_tpu.evolution import variational_optimization as jvo

from symmer_torch import config as tconfig
from symmer_torch.evolution import ADAPT_VQE, VQE_Driver, device_vqe
from symmer_torch.kernels import torch_vqe

from .test_torch_evolution import h2_taper, lih_taper, random_system, top, tstate


@pytest.fixture(autouse=True)
def cpu_device():
    old = (tconfig.backend, tconfig.device)
    tconfig.device = "cpu"
    yield
    tconfig.backend, tconfig.device = old


def bits(t):
    return torch.view_as_real(t).view(torch.int64)


def random_generators(rng, n, P):
    """(x, z, ph) of P generators: x's from a few patterns in stretches of
    one x (as UCCSD's come), some x = 0, ph = (-i)^{|Y|} c with c = +-1."""
    dim = 1 << n
    pool = rng.integers(0, dim, size=max(2, P // 4))
    x = np.repeat(pool, rng.integers(1, 10, size=pool.size))[:P]
    x = np.concatenate([x, rng.integers(0, dim, size=P - x.size)]).astype(np.int64)
    x[rng.random(P) < 0.15] = 0
    z = rng.integers(0, dim, size=P).astype(np.int64)
    y = np.array([bin(int(a) & int(b)).count("1") for a, b in zip(x, z)])
    return x, z, (-1j) ** (y % 4) * rng.choice([1.0, -1.0], size=P)


def state(rng, n):
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return torch.tensor(v / np.linalg.norm(v))


def sequential(psi, x, z, ph, t):
    for k in range(x.size):
        psi = torch_vqe.rotate(psi, int(x[k]), int(z[k]), ph[k].real, ph[k].imag, np.cos(t[k]),
                               np.sin(t[k]))
    return psi


FORWARD_CASES = [(1, 4, None), (2, 6, 1), (3, 12, 2), (5, 30, 3), (6, 40, 6), (7, 60, 4),
                 (8, 50, None)]


@pytest.mark.parametrize("n,P,tile_bits", FORWARD_CASES)
def test_fused_forward_equals_sequential_rotations(n, P, tile_bits):
    rng = np.random.default_rng(n * 31 + P)
    x, z, ph = random_generators(rng, n, P)
    plan = torch_vqe.plan_runs(x, z, ph, n, tile_bits=tile_bits)
    t = rng.normal(size=P)
    cs = torch.tensor(np.stack([np.cos(t), np.sin(t)], 1))
    psi = state(rng, n)
    assert torch.equal(bits(torch_vqe.rotate_runs(psi, plan, cs)), bits(sequential(psi, x, z, ph, t)))


def test_fused_forward_on_the_h2_taper():
    """The H2 taper's generators (X, Y and Z on its one qubit) and its HF
    state, whose exact zeros keep their signs."""
    H, ref = h2_taper()
    gens = top(JOp.from_list(["Y", "X", "Z", "Y"]))
    x, z, ph = device_vqe.term_arrays(gens)
    psi = torch.tensor(tstate(ref).to_dense_matrix.reshape(-1), dtype=torch.complex128)
    t = np.array([0.3, -1.1, 0.7, 2.0])
    cs = torch.tensor(np.stack([np.cos(t), np.sin(t)], 1))
    plan = torch_vqe.plan_runs(x, z, ph, H.n_qubits)
    assert torch.equal(bits(torch_vqe.rotate_runs(psi, plan, cs)), bits(sequential(psi, x, z, ph, t)))


@pytest.mark.parametrize("n,P,tile_bits", FORWARD_CASES + [(9, 300, None), (4, 40, 4)])
def test_run_partition(n, P, tile_bits):
    rng = np.random.default_rng(n * 7 + P)
    x, z, ph = random_generators(rng, n, P)
    if n == 9:  # one x throughout: runs cut at MAX_RUN generators
        x[:] = x[0]
    plan = torch_vqe.plan_runs(x, z, ph, n, tile_bits=tile_bits)
    D = plan.tile_bits
    assert D == min(n, tile_bits or torch_vqe.default_tile_bits(n))
    fold = min(torch_vqe.FOLD_BITS, max(D - 1, 0))
    assert plan.run_off[0] == 0 and plan.run_off[-1] == plan.stretch_mask.size
    assert plan.stretch_off[0] == 0 and plan.stretch_off[-1] == P
    for r in range(plan.n_runs):
        basis = [int(b) for b in plan.basis[r]]
        piv = [(b & -b).bit_length() - 1 for b in basis]
        assert piv == sorted(set(piv)) and int(plan.pivots[r]) == sum(1 << p for p in piv)
        assert all(not (b >> p) & 1 for i, b in enumerate(basis) for q, p in enumerate(piv) if i != q)
        assert piv[:fold] == list(range(fold))  # the low row bits lead every tile
        rows = torch_vqe.tile_rows(plan, r)
        assert np.array_equal(np.sort(rows.reshape(-1)), np.arange(1 << n))  # the cosets partition
        offs = torch_vqe.tile_offsets(plan, r)
        reps = torch_vqe.coset_reps(plan, r)
        for s in range(int(plan.run_off[r]), int(plan.run_off[r + 1])):
            m = int(plan.stretch_mask[s])
            k0, k1 = int(plan.stretch_off[s]), int(plan.stretch_off[s + 1])
            assert 0 < k1 - k0 <= torch_vqe.MAX_STRETCH
            for k in range(k0, k1):
                assert offs[m] == x[k]  # x_k = B(m_k): every x lies in S
                sgn_rows = np.array([bin(int(v) & int(z[k])).count("1") & 1 for v in rows.reshape(-1)])
                sgn_tile = np.array([(bin(int(rep) & int(z[k])).count("1")
                                      + bin(j & int(plan.gzc[k])).count("1")) & 1
                                     for rep in reps for j in range(1 << D)])
                assert np.array_equal(sgn_rows, sgn_tile)
        gens = plan.stretch_off[plan.run_off[r + 1]] - plan.stretch_off[plan.run_off[r]]
        assert 0 < gens <= torch_vqe.MAX_RUN


def test_runs_are_greedy_and_split_shared_x():
    """Two x's that do not fit one tile alternate: every generator starts a
    run, so the runs split the generators that share an x."""
    n = 6
    x = np.array([0b100000, 0b010000, 0b100000, 0b010000], np.int64)
    plan = torch_vqe.plan_runs(x, np.zeros(4, np.int64), np.ones(4), n, tile_bits=3)
    assert plan.n_runs == 4  # {e0, e1} + one x fills d = 3
    plan = torch_vqe.plan_runs(x, np.zeros(4, np.int64), np.ones(4), n, tile_bits=4)
    assert plan.n_runs == 1 and list(plan.stretch_off) == [0, 1, 2, 3, 4]


@pytest.mark.parametrize("case", ["h2", 0, 1, 2, 3])
@pytest.mark.parametrize("tile_bits", [None, 2])
def test_sweep_gradient_matches_jax_grad(monkeypatch, case, tile_bits):
    if tile_bits is not None:
        monkeypatch.setattr(torch_vqe, "default_tile_bits", lambda n: min(n, tile_bits))
    if case == "h2":
        H, ref = h2_taper()
        gens, r = JOp.from_list(["Y", "X", "Z"]), np.random.default_rng(11)
    else:
        H, gens, ref, r = random_system(case + 10)
    want = jx_vqe.DeviceVQEEngine(H, gens, ref)
    eng = device_vqe.DeviceVQEEngine(top(H), top(gens), tstate(ref))
    hx, hz, hph = (torch.as_tensor(a) for a in device_vqe.term_arrays(top(H)))
    gx, gz, gph = (torch.as_tensor(a) for a in device_vqe.term_arrays(top(gens)))
    x = r.normal(size=gens.n_terms)
    g = eng.gradient(x)
    assert np.abs(g - want.gradient(x)).max() <= 1e-10
    xt = torch.tensor(x, requires_grad=True)
    torch_vqe.energy(xt, eng._psi0, gx, gz, gph, hx, hz, hph).backward()
    assert np.abs(g - xt.grad.numpy()).max() <= 1e-12



def test_second_backward_raises():
    """The sweep consumes the vectors saved for backward (on the card it
    overwrites them), so a second backward through one graph raises."""
    H, gens, ref, r = random_system(12)
    eng = device_vqe.DeviceVQEEngine(top(H), top(gens), tstate(ref))
    x = torch.tensor(r.normal(size=gens.n_terms), requires_grad=True)
    e = device_vqe._Energy.apply(x, eng)
    e.backward(retain_graph=True)
    with pytest.raises(RuntimeError, match="modified by an inplace operation"):
        e.backward()

@pytest.mark.parametrize("case", ["h2", 0, 1, 2])
def test_x_grouped_pool_gradient_matches_jax(case):
    if case == "h2":
        H, ref = h2_taper()
        gens, r = JOp.from_list(["Y", "X"]), np.random.default_rng(5)
    else:
        H, gens, ref, r = random_system(case + 20)
    pool = JOp.random(H.n_qubits, 24, density=0.5)
    # repeat X parts so that the groups hold several Paulis
    pool = JOp.from_planes(np.concatenate([pool.x_pack, pool.x_pack[:8]]),
                           np.concatenate([pool.z_pack, pool.z_pack[8:16]]),
                           np.ones(32), H.n_qubits)
    x = r.normal(size=gens.n_terms)
    want = jx_vqe.device_pool_gradient(H, gens, ref, pool, x)
    got = device_vqe.device_pool_gradient(top(H), top(gens), tstate(ref), top(pool), x)
    assert np.abs(got - want).max() <= 1e-10


def _drivers(H, gens, ref, jcls, tcls, kw):
    j, t = jcls(H, **{kw: gens}, ref_state=ref), tcls(top(H), **{kw: top(gens)},
                                                     ref_state=tstate(ref))
    for d in (j, t):
        d.verbose = False
        d.expectation_eval = "device_array"
    return j, t


@pytest.mark.parametrize("mol", ["h2", "lih"])
def test_drivers_with_many_runs(monkeypatch, mol):
    """Tiles of 2^2 rows cut LiH's tapered UCCSD generators into many runs;
    the drivers' energies still match symmer_tpu's."""
    monkeypatch.setattr(torch_vqe, "default_tile_bits", lambda n: min(n, 2))
    if mol == "h2":
        H, ref = h2_taper()
        gens = JOp.from_list(["Y", "X"])
    else:
        H, gens, ref = lih_taper()
    j, t = _drivers(H, gens, ref, jvo.VQE_Driver, VQE_Driver, "excitation_ops")
    x0 = np.full(j.n_params, 0.05)
    assert abs(t.run(x0=x0, method="BFGS", options={"maxiter": 3})[0]["fun"]
               - j.run(x0=x0, method="BFGS", options={"maxiter": 3})[0]["fun"]) <= 1e-8
    j, t = _drivers(H, gens, ref, jvo.ADAPT_VQE, ADAPT_VQE, "excitation_pool")
    assert abs(t.optimize(max_cycles=2)["result"]["fun"]
               - j.optimize(max_cycles=2)["result"]["fun"]) <= 1e-8
