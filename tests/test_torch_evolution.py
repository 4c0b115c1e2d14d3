"""The evolution layer of symmer_torch against symmer_tpu on the same inputs.

Inputs are built in symmer_tpu from numpy seeds and carried into the port
by ``from_numpy_planes`` / ``from_numpy_state``; the port runs its device
path on the CPU device (the plain versions of its kernels).  Tolerances:

  - the engine's energy 1e-11 and gradient 1e-10 against
    ``jx_vqe.DeviceVQEEngine`` (float64 on both sides; the port sums the
    observable by X groups and rows pairwise, the reference term by term);
  - the pool gradient 1e-10 against ``jx_vqe.device_pool_gradient``;
  - the adjoint backward 1e-12 against torch.autograd through the plain
    forward (``torch_vqe.energy``), which takes the same operations in
    another order;
  - the drivers' final energies 1e-8 (BFGS over energies and gradients
    that agree to ~1e-15, a few iterations);
  - CircuitSymmerlator, the QASM decomposition and the topology scores
    exactly or to 1e-12 (the same host arithmetic).
"""
import numpy as np
import pytest
import torch

from symmer_tpu import PauliwordOp as JOp
from symmer_tpu import QuantumState as JState
from symmer_tpu import QubitTapering as JTapering
from symmer_tpu.evolution import jx_vqe
from symmer_tpu.evolution import utils as jutils
from symmer_tpu.evolution import variational_optimization as jvo
from symmer_tpu.evolution._parse import safe_angle_eval as j_safe_angle_eval
from symmer_tpu.evolution.circuit_symmerlator import CircuitSymmerlator as JSim
from symmer_tpu.evolution.decomposition import PauliwordOp_to_QASM as j_to_qasm
from symmer_tpu.evolution.decomposition import qasm_to_PauliwordOp as j_from_qasm

import symmer_torch
from symmer_torch import config as tconfig
from symmer_torch import process
from symmer_torch.evolution import ADAPT_VQE, CircuitSymmerlator, VQE_Driver, device_vqe
from symmer_torch.evolution import utils as tutils
from symmer_torch.evolution._parse import safe_angle_eval
from symmer_torch.evolution.decomposition import PauliwordOp_to_QASM, qasm_to_PauliwordOp
from symmer_torch.kernels import cuda, torch_vqe
from symmer_torch.operators import from_numpy_planes, from_numpy_state

from .conftest import H2_JW_DICT, load_reference_hamiltonian


@pytest.fixture(autouse=True)
def cpu_device():
    old = (tconfig.backend, tconfig.device)
    tconfig.device = "cpu"
    yield
    tconfig.backend, tconfig.device = old


def top(op):
    return from_numpy_planes(op.x_pack, op.z_pack, op.coeff_vec, op.n_qubits)


def tstate(psi):
    return from_numpy_state(psi._s_pack, psi._amps, psi.n_qubits)


def same_op(a, b, tol=1e-12):
    da, db = a.cleanup().to_dictionary, b.cleanup().to_dictionary
    assert set(da) == set(db)
    assert all(abs(da[k] - db[k]) <= tol for k in da)


def h2_taper():
    H = JOp.from_dictionary(H2_JW_DICT)
    QT = JTapering(H)
    return QT.taper_it(ref_state=np.array([1, 1, 0, 0])), QT.tapered_ref_state.normalize


def lih_taper():
    data = load_reference_hamiltonian("LiH_STO-3G_SINGLET_JW.json")
    QT = JTapering(JOp.from_dictionary(data["hamiltonian"]))
    H = QT.taper_it(ref_state=np.asarray(data["data"]["hf_array"]))
    CC = QT.taper_it(aux_operator=JOp.from_dictionary(
        data["data"]["auxiliary_operators"]["UCCSD_operator"]))
    return H, CC, QT.tapered_ref_state.normalize


def random_system(seed):
    """As tests/test_evolution/test_variational.py:225 builds them: a random
    real observable on 2-6 qubits, random generators (duplicates allowed,
    identities dropped as prepare_for_evolution drops them), a random
    reference state of a few basis states."""
    r = np.random.default_rng(seed)
    n = int(r.integers(2, 7))
    H = JOp.random(n, int(r.integers(4, 20)), density=0.6).cleanup()
    H.coeff_vec = H.coeff_vec.real.astype(complex)
    g = JOp.random(n, int(r.integers(1, 6)), density=0.6)
    keep = np.any(g.symp_matrix, axis=1)
    gens = JOp.from_planes(g.x_pack[keep], g.z_pack[keep], np.ones(int(keep.sum())), n)
    ref = JState.random(n, int(r.integers(1, 4))).normalize
    return H, gens, ref, r


def system(case):
    if case == "h2":
        H, ref = h2_taper()
        gens = JOp.from_list(["Y", "X", "Z"])
        return H, gens, ref, np.random.default_rng(11)
    return random_system(case)


CASES = ["h2", 0, 1, 2, 3, 4]


@pytest.mark.parametrize("case", CASES)
def test_engine_matches_jx_vqe(case):
    H, gens, ref, r = system(case)
    want = jx_vqe.DeviceVQEEngine(H, gens, ref)
    got = device_vqe.DeviceVQEEngine(top(H), top(gens), tstate(ref))
    for _ in range(3):
        x = r.normal(size=gens.n_terms)
        assert abs(got.loss(x) - want.loss(x)) <= 1e-11
        assert np.abs(got.gradient(x) - want.gradient(x)).max() <= 1e-10


@pytest.mark.parametrize("case", CASES)
def test_pool_gradient_matches_jx_vqe(case):
    H, gens, ref, r = system(case)
    pool = JOp.random(H.n_qubits, 9, density=0.5)
    pool.coeff_vec[:] = 1
    x = r.normal(size=gens.n_terms)
    want = jx_vqe.device_pool_gradient(H, gens, ref, pool, x)
    got = device_vqe.device_pool_gradient(top(H), top(gens), tstate(ref), top(pool), x)
    assert np.abs(got - want).max() <= 1e-10


@pytest.mark.parametrize("case", CASES)
def test_adjoint_backward_matches_autograd(case):
    H, gens, ref, r = system(case)
    eng = device_vqe.DeviceVQEEngine(top(H), top(gens), tstate(ref))
    hx, hz, hph = (torch.as_tensor(a) for a in device_vqe.term_arrays(top(H)))
    gx, gz, gph = (torch.as_tensor(a) for a in device_vqe.term_arrays(top(gens)))
    x = r.normal(size=gens.n_terms)
    xt = torch.tensor(x, requires_grad=True)
    e = torch_vqe.energy(xt, eng._psi0, gx, gz, gph, hx, hz, hph)
    e.backward()
    assert abs(float(e) - eng.loss(x)) <= 1e-12
    assert np.abs(xt.grad.numpy() - eng.gradient(x)).max() <= 1e-12


def test_engine_gradient_is_an_autograd_function():
    H, gens, ref, r = system("h2")
    eng = device_vqe.DeviceVQEEngine(top(H), top(gens), tstate(ref))
    x = torch.tensor(r.normal(size=3), requires_grad=True)
    e = device_vqe._Energy.apply(x, eng)
    assert e.grad_fn is not None
    (2 * e).backward()
    assert np.allclose(x.grad.numpy(), 2 * eng.gradient(x.detach().numpy()), atol=0, rtol=0)
    assert eng.gradient([0.0, 0.0, 0.0]).shape == (3,)


def test_engine_guards():
    H, ref = h2_taper()
    with pytest.raises(AssertionError, match="real \\+-1"):
        device_vqe.DeviceVQEEngine(top(H), top(JOp.from_list(["X"], [1j])), tstate(ref))
    with pytest.raises(AssertionError, match="real \\+-1"):
        device_vqe.device_pool_gradient(top(H), top(JOp.from_list(["Y"], [0.5])), tstate(ref),
                                        top(JOp.from_list(["X"])), [0.1])
    big = symmer_torch.PauliwordOp.from_list(["Z" * 27])
    with pytest.raises(AssertionError, match="27 qubits"):
        device_vqe.DeviceVQEEngine(big, symmer_torch.PauliwordOp.empty(27),
                                   symmer_torch.QuantumState.zero(27))


def test_engine_on_missing_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    H, gens, ref, _ = system("h2")
    tconfig.device = "cuda"
    with pytest.raises(RuntimeError, match="is_available"):
        device_vqe.DeviceVQEEngine(top(H), top(gens), tstate(ref))
    drv = VQE_Driver(top(H), excitation_ops=top(gens), ref_state=tstate(ref))
    drv.expectation_eval = "device_array"
    with pytest.raises(RuntimeError, match="is_available"):
        drv.f(np.zeros(3))


def test_engine_key_is_content_based():
    H, gens, ref, _ = system("h2")
    k = device_vqe.DeviceVQEEngine.key(top(H), top(gens), tstate(ref))
    assert k == device_vqe.DeviceVQEEngine.key(top(H), top(gens), tstate(ref))
    tconfig.device = "cuda"
    assert k != device_vqe.DeviceVQEEngine.key(top(H), top(gens), tstate(ref))


def _drivers(H, gens, ref, cls_pair):
    jcls, tcls = cls_pair
    j = jcls(H, excitation_ops=gens, ref_state=ref) if jcls is jvo.VQE_Driver else jcls(
        H, excitation_pool=gens, ref_state=ref)
    t = tcls(top(H), excitation_ops=top(gens), ref_state=tstate(ref)) if tcls is VQE_Driver \
        else tcls(top(H), excitation_pool=top(gens), ref_state=tstate(ref))
    for d in (j, t):
        d.verbose = False
        d.expectation_eval = "device_array"
    return j, t


@pytest.mark.parametrize("mol", ["h2", "lih"])
def test_vqe_run_matches(mol):
    if mol == "h2":
        H, ref = h2_taper()
        gens = JOp.from_list(["Y", "X"])
    else:
        H, gens, ref = lih_taper()
    j, t = _drivers(H, gens, ref, (jvo.VQE_Driver, VQE_Driver))
    x0 = np.full(j.n_params, 0.05)
    jout, _ = j.run(x0=x0, method="BFGS", options={"maxiter": 5})
    tout, hist = t.run(x0=x0, method="BFGS", options={"maxiter": 5})
    assert abs(tout["fun"] - jout["fun"]) <= 1e-8
    assert len(hist["energy"]) == len(hist["params"]) >= 2


@pytest.mark.parametrize("mol", ["h2", "lih"])
def test_adapt_optimize_matches(mol):
    if mol == "h2":
        H, ref = h2_taper()
        pool = JOp.from_list(["X", "Y", "Z"])
    else:
        H, pool, ref = lih_taper()
    j, t = _drivers(H, pool, ref, (jvo.ADAPT_VQE, ADAPT_VQE))
    jout, tout = j.optimize(max_cycles=3), t.optimize(max_cycles=3)
    # tied pool scores may pick different members: compare energies
    assert abs(tout["result"]["fun"] - jout["result"]["fun"]) <= 1e-8
    assert tout["ref_state"] == jout["ref_state"]


def test_adapt_pool_gradient_matches_host_commutators():
    H, pool, ref = lih_taper()
    _, t = _drivers(H, pool, ref, (jvo.ADAPT_VQE, ADAPT_VQE))
    dev = t.pool_gradient()
    t.expectation_eval = "symbolic_direct"
    host = t.pool_gradient()
    assert np.abs(dev - host).max() <= 1e-10


# -- CircuitSymmerlator -------------------------------------------------------

GATES = ["x", "y", "z", "h", "s", "sdg", "sx", "sy", "sz", "cx", "cy", "cz", "swap",
         "t", "tdg", "rx", "ry", "rz", "ccx"]


def random_circuit(seed, n=4, depth=25):
    r = np.random.default_rng(seed)
    steps = []
    for _ in range(depth):
        g = GATES[int(r.integers(len(GATES)))]
        k = 3 if g == "ccx" else 2 if g in ("cx", "cy", "cz", "swap") else 1
        q = [int(v) for v in r.choice(n, size=k, replace=False)]
        steps.append((g, q, float(r.normal()) if g in ("rx", "ry", "rz") else None))
    return steps


def run_circuit(cls, n, steps):
    sim = cls(n)
    for g, q, angle in steps:
        if angle is None:
            sim.gate_map[g](*q)
        else:
            sim.gate_map[g](*q, angle=angle)
    return sim


@pytest.mark.parametrize("seed", range(4))
def test_circuit_symmerlator_matches(seed):
    steps = random_circuit(seed)
    j, t = run_circuit(JSim, 4, steps), run_circuit(CircuitSymmerlator, 4, steps)
    assert len(j.sequence) == len(t.sequence)
    for (jp, ja), (tp, ta) in zip(j.sequence, t.sequence):
        assert jp.to_dictionary == tp.to_dictionary and ja == ta
    obs = JOp.random(4, 12, density=0.5).cleanup()
    same_op(j.apply_sequence(obs), t.apply_sequence(top(obs)))
    assert abs(j.evaluate(obs) - t.evaluate(top(obs))) <= 1e-12


def test_circuit_symmerlator_device_path_matches_host():
    steps = random_circuit(7, n=6, depth=40)
    obs = JOp.random(6, 30, density=0.5).cleanup()
    tconfig.backend = "host"
    host = run_circuit(CircuitSymmerlator, 6, steps).evaluate(top(obs))
    tconfig.backend = "device"
    dev = run_circuit(CircuitSymmerlator, 6, steps).evaluate(top(obs))
    assert abs(dev - host) <= 1e-12


def test_circuit_symmerlator_from_qasm_matches():
    qasm = (
        'OPENQASM 2.0;\ninclude "qelib1.inc";\nqreg q[3];\nh q[0];\ncx q[0],q[1];\n'
        "rz(pi/4) q[1];\ns q[2];\ncz q[1],q[2];\nry(-3*pi/8) q[0];\nt q[2];\nswap q[0],q[2];\n"
    )
    j, t = JSim.from_qasm(qasm), CircuitSymmerlator.from_qasm(qasm)
    obs = JOp.random(3, 10, density=0.6).cleanup()
    assert abs(j.evaluate(obs) - t.evaluate(top(obs))) <= 1e-12
    same_op(j.apply_sequence(obs), t.apply_sequence(top(obs)))


def test_qiskit_import_twin():
    pytest.importorskip("qiskit")
    from qiskit import QuantumCircuit

    qc = QuantumCircuit(2)
    qc.h(0)
    qc.cx(0, 1)
    obs = JOp.from_list(["ZZ", "XX"])
    assert abs(JSim.from_qiskit(qc).evaluate(obs)
               - CircuitSymmerlator.from_qiskit(qc).evaluate(top(obs))) <= 1e-12


# -- decomposition, _parse, utils, process --------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_qasm_round_trip_matches(seed):
    op = JOp.random(4, 3, density=0.6).cleanup()
    op.coeff_vec = np.random.default_rng(seed).normal(size=op.n_terms).astype(complex)
    qasm = j_to_qasm(op, ref_state=np.array([1, 0, 1, 0]))
    assert PauliwordOp_to_QASM(top(op), ref_state=np.array([1, 0, 1, 0])) == qasm
    same_op(j_from_qasm(qasm, negate_angles=True),
            qasm_to_PauliwordOp(qasm, negate_angles=True))
    same_op(j_from_qasm(qasm, reverse=True), qasm_to_PauliwordOp(qasm, reverse=True))


@pytest.mark.parametrize("expr", [
    "__import__('os')", "().__class__", "pi.real", "2**2**2**2**2**2", "1/0", "foo",
    "[1]", "lambda: 1", "1 if 1 else 2", "",
])
def test_safe_angle_eval_rejects(expr):
    with pytest.raises(ValueError):
        j_safe_angle_eval(expr)
    with pytest.raises(ValueError):
        safe_angle_eval(expr)


@pytest.mark.parametrize("expr", ["pi/4", "-3*pi/2", "2**-1", "+0.5e-3", "(1+2)*pi"])
def test_safe_angle_eval_accepts(expr):
    assert safe_angle_eval(expr) == j_safe_angle_eval(expr)


def topologies():
    import networkx as nx

    return [nx.path_graph(5), nx.cycle_graph(6), nx.grid_2d_graph(2, 3),
            nx.star_graph(4), nx.complete_graph(3)]


@pytest.mark.parametrize("seed", range(4))
def test_topology_scores_match(seed):
    op = JOp.random(6, 4, density=0.5)
    if seed == 3:
        op = op.append(JOp.from_list(["IIIIII"]))
    jg, tg = jutils.get_CNOT_connectivity_graph(op), tutils.get_CNOT_connectivity_graph(top(op))
    edges = lambda g: {(min(u, v), max(u, v), w) for u, v, w in g.edges(data="weight")}
    assert edges(jg) == edges(tg)
    for topo in topologies():
        for depth in (1, 2, 3):
            assert (tutils.topology_match_score(top(op), topo, max_depth=depth)
                    == jutils.topology_match_score(op, topo, max_depth=depth))


def _square(i, shared):
    return i * i + shared


@pytest.mark.parametrize("method", ["vectorised", "single_thread", "mp"])
def test_process_methods(method):
    old = process.method
    process.method = method
    try:
        offset = 3

        @process.parallelize
        def local(i, shared):  # a local function: 'mp' forks, nothing is pickled
            return i * shared + offset

        assert local(range(23), 2) == [2 * i + 3 for i in range(23)]
        assert process.parallelize(_square)([], 1) == []
    finally:
        process.method = old


def test_process_mp_raises_worker_errors():
    old = process.method
    process.method = "mp"
    try:
        @process.parallelize
        def fails(i, shared):
            if i == 5:
                raise KeyError("item 5")
            return i

        with pytest.raises(RuntimeError, match="item 5"):
            fails(range(8), None)
        with pytest.raises(ValueError, match="Invalid processing method"):
            process.method = "ray"
            fails(range(2), None)
    finally:
        process.method = old


def test_process_mp_refuses_to_fork_a_cuda_context(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    old = process.method
    process.method = "mp"
    try:
        tconfig.backend, tconfig.device = "device", "cuda"
        with pytest.raises(RuntimeError, match="forked child"):
            process.parallelize(_square)(range(4), 0)
        tconfig.backend = "host"  # host-only work forks
        assert process.parallelize(_square)(range(4), 0) == [0, 1, 4, 9]
    finally:
        process.method = old


def test_vqe_gradient_host_path_under_mp():
    """VQE_Driver.gradient's host path (parameter shift) through process
    'mp' equals the device engine's adjoint gradient."""
    H, gens, ref, r = system("h2")
    drv = VQE_Driver(top(H), excitation_ops=top(gens), ref_state=tstate(ref))
    drv.verbose = False
    x = r.normal(size=3)
    drv.expectation_eval = "device_array"
    want = drv.gradient(x)
    old = process.method
    process.method = "mp"
    try:
        drv.expectation_eval = "sparse_array"
        got = drv.gradient(x)
    finally:
        process.method = old
    assert np.abs(got - want).max() <= 1e-10
    assert cuda.launches["vqe_rotate"] == 0  # the CPU device launches nothing
