"""The contextual-subspace slice as a whole: symmer_torch against symmer_tpu
and the pins.

Taper -> ContextualSubspace("SingleSweep_magnitude") -> update_stabilizers ->
project_onto_subspace runs on the port's device path (here the CPU device:
the plain torch versions of the kernels).  The four pinned CS-VQE energies
hold to 1e-10 (tests/test_projection/test_molecule_parity.py:56-62); the Be
projected operator and projected state equal symmer_tpu's term by term,
coefficients within 1e-12 relative; DeviceOperator.expval agrees with the
host PauliwordOp.expval within 1e-12 relative.
"""
import numpy as np
import pytest

import symmer_tpu
import symmer_torch
from symmer_tpu.config import config as jconfig
from symmer_torch import config as tconfig
from symmer_torch.kernels import dispatch as tdispatch
from symmer_torch.operators import from_numpy_planes, from_numpy_state
from symmer_torch.profiling import kernel_stats

from .conftest import load_reference_hamiltonian

RTOL = 1e-12
# tests/test_projection/test_molecule_parity.py:57-63
CSVQE_3Q_GS_EXACT = {
    "Be_STO-3G_SINGLET_JW.json": -14.389536593826167,
    "HF_STO-3G_SINGLET_JW.json": -98.57548286236913,
    "H2O_STO-3G_SINGLET_JW.json": -74.96895047987964,
    "BeH2_STO-3G_SINGLET_JW.json": -15.567765366038305,
}


@pytest.fixture(autouse=True)
def device_backends(monkeypatch):
    old = (tconfig.backend, tconfig.device, jconfig.backend)
    tconfig.backend, tconfig.device, jconfig.backend = "device", "cpu", "auto"
    # the small inputs here take the device path of every entry
    monkeypatch.setattr(tdispatch, "DEVICE_FLOOR", 0)
    yield
    tconfig.backend, tconfig.device, jconfig.backend = old


def ground_energy(op) -> float:
    return float(np.linalg.eigvalsh(op.to_sparse_matrix.toarray())[0])


def assert_same_op(a, b, rtol=RTOL):
    assert a.n_qubits == b.n_qubits and a.n_terms == b.n_terms
    ra, rb = np.hstack([a.x_pack, a.z_pack]), np.hstack([b.x_pack, b.z_pack])
    oa, ob = np.lexsort(ra.T[::-1]), np.lexsort(rb.T[::-1])
    assert np.array_equal(ra[oa], rb[ob])
    ca, cb = a.coeff_vec[oa], b.coeff_vec[ob]
    scale = np.maximum(np.maximum(np.abs(ca), np.abs(cb)), np.finfo(float).tiny)
    assert np.all(np.abs(ca - cb) <= rtol * scale)


def assert_same_state(a, b, rtol=RTOL):
    da = {r.tobytes(): c for r, c in zip(a._s_pack, a._amps)}
    db = {r.tobytes(): c for r, c in zip(b._s_pack, b._amps)}
    assert da.keys() == db.keys()
    for k in da:
        assert abs(da[k] - db[k]) <= rtol * max(abs(da[k]), abs(db[k]))


def molecule(name):
    data = load_reference_hamiltonian(name)
    H_j = symmer_tpu.PauliwordOp.from_dictionary(data["hamiltonian"])
    H_t = from_numpy_planes(H_j.x_pack, H_j.z_pack, H_j.coeff_vec, H_j.n_qubits)
    return H_t, H_j, np.asarray(data["data"]["hf_array"]), data


def cs_flow(pkg, H, hf, n_qubits=3, with_reference=False):
    qt = pkg.QubitTapering(H)
    H_taper = qt.taper_it(ref_state=hf)
    cs = pkg.ContextualSubspace(
        H_taper, noncontextual_strategy="SingleSweep_magnitude",
        reference_state=qt.tapered_ref_state if with_reference else None,
    )
    cs.update_stabilizers(n_qubits, strategy="aux_preserving")
    return qt, cs, cs.project_onto_subspace()


@pytest.mark.parametrize("name,pinned", sorted(CSVQE_3Q_GS_EXACT.items()))
def test_cs_vqe_energy_pinned_1e10(name, pinned):
    H_t, _, hf, _ = molecule(name)
    kernel_stats.reset()
    _, _, H_cs = cs_flow(symmer_torch, H_t, hf)
    assert H_cs.n_qubits == 3
    assert abs(ground_energy(H_cs) - pinned) < 1e-10
    # the projection and the state projection ran on the device path
    assert kernel_stats.device_calls["clifford_rotate_project"] >= 1
    assert kernel_stats.device_calls["apply_state"] >= 1


@pytest.mark.parametrize("with_reference", [False, True])
@pytest.mark.parametrize("backend", ["device", "host"])
def test_be_projection_matches_symmer_tpu(backend, with_reference):
    tconfig.backend = backend
    H_t, H_j, hf, _ = molecule("Be_STO-3G_SINGLET_JW.json")
    qt_t, cs_t, got = cs_flow(symmer_torch, H_t, hf, with_reference=with_reference)
    qt_j, cs_j, want = cs_flow(symmer_tpu, H_j, hf, with_reference=with_reference)
    assert_same_op(got, want)
    assert abs(cs_t.noncontextual_operator.energy - cs_j.noncontextual_operator.energy) <= (
        RTOL * abs(cs_j.noncontextual_operator.energy)
    )
    assert_same_state(cs_t.project_state(qt_t.tapered_ref_state),
                      cs_j.project_state(qt_j.tapered_ref_state))


@pytest.mark.parametrize("name", ["Be_STO-3G_SINGLET_JW.json", "H2O_STO-3G_SINGLET_JW.json"])
def test_device_operator_expval(name):
    """DeviceOperator.expval of the tapered operator against its tapered HF
    state, a superposition with duplicate rows, and a non-Hermitian
    operator: the host PauliwordOp.expval and symmer_tpu's within 1e-12."""
    H_t, H_j, hf, _ = molecule(name)
    qt_j = symmer_tpu.QubitTapering(H_j)
    Ht_j = qt_j.taper_it(ref_state=hf)
    Ht_t = from_numpy_planes(Ht_j.x_pack, Ht_j.z_pack, Ht_j.coeff_vec, Ht_j.n_qubits)
    n = Ht_j.n_qubits
    rng = np.random.default_rng(n)
    ref = qt_j.tapered_ref_state
    rows = np.vstack([ref.state_matrix, rng.integers(0, 2, (6, n)), ref.state_matrix])
    amps = rng.normal(size=8) + 1j * rng.normal(size=8)
    states = [ref, symmer_tpu.QuantumState(rows, amps)]
    ops = [(Ht_t, Ht_j)]
    np.random.seed(1)
    A_j = symmer_tpu.PauliwordOp.random(n, 40)
    C_j = (Ht_j * A_j - A_j * Ht_j).multiply_by_constant(1j) + A_j  # non-Hermitian
    ops.append((from_numpy_planes(C_j.x_pack, C_j.z_pack, C_j.coeff_vec, n), C_j))
    for op_t, op_j in ops:
        dev = op_t.to_device()
        for psi_j in states:
            psi_t = from_numpy_state(psi_j._s_pack, psi_j._amps, n)
            got = dev.expval(psi_t)
            tconfig.backend = "host"
            host = op_t.expval(psi_t)
            tconfig.backend = "device"
            want = op_j.expval(psi_j)
            for other in (host, want):
                assert abs(got - other) <= RTOL * max(abs(got), abs(other))
    assert abs(got.imag) > 1e-6  # the non-Hermitian part is exercised


def test_device_operator_expval_checks_qubits():
    H_t, _, _, _ = molecule("Be_STO-3G_SINGLET_JW.json")
    psi = symmer_torch.QuantumState(np.zeros((1, H_t.n_qubits - 1), dtype=int))
    with pytest.raises(ValueError, match="qubits"):
        H_t.to_device().expval(psi)


def test_n2_noncontextual_solve_without_reference():
    """Tapered N2 (15 qubits) with no reference state: the brute force runs
    over every symmetry generator of the noncontextual part (2^14
    assignments, the device search) and reaches symmer_tpu's energy."""
    H_t, H_j, hf, _ = molecule("N2_STO-3G_SINGLET_JW.json")
    Ht_j = symmer_tpu.QubitTapering(H_j).taper_it(ref_state=hf)
    Ht_t = symmer_torch.QubitTapering(H_t).taper_it(ref_state=hf)
    assert_same_op(Ht_t, Ht_j)
    cs_t = symmer_torch.ContextualSubspace(Ht_t, noncontextual_strategy="SingleSweep_magnitude")
    jconfig.backend = "host"
    cs_j = symmer_tpu.ContextualSubspace(Ht_j, noncontextual_strategy="SingleSweep_magnitude")
    assert cs_t.noncontextual_operator.symmetry_generators.n_terms == 14
    e_t, e_j = cs_t.noncontextual_operator.energy, cs_j.noncontextual_operator.energy
    assert abs(e_t - e_j) <= RTOL * abs(e_j)


def test_utils_host_parts_match_symmer_tpu():
    """symmer_torch.utils (the host parts of symmer_tpu.utils): the exact
    ground energy (sparse and matrix-free), the random anticommuting set
    under one seed, tensor and product lists."""
    import symmer_tpu.utils as jutils
    import symmer_torch.utils as tutils

    H_t, H_j, hf, _ = molecule("Be_STO-3G_SINGLET_JW.json")
    Ht_j = symmer_tpu.QubitTapering(H_j).taper_it(ref_state=hf)
    Ht_t = from_numpy_planes(Ht_j.x_pack, Ht_j.z_pack, Ht_j.coeff_vec, Ht_j.n_qubits)
    e_j = jutils.exact_gs_energy(Ht_j.to_sparse_matrix)[0]
    for e in (tutils.exact_gs_energy(Ht_t.to_sparse_matrix)[0],
              tutils.exact_gs_energy_matrix_free(Ht_t)[0]):
        assert abs(e - e_j) < 1e-10
    np.random.seed(5)
    ac_j = jutils.random_anitcomm_2n_1_PauliwordOp(3)
    np.random.seed(5)
    ac_t = tutils.random_anitcomm_2n_1_PauliwordOp(3)
    assert_same_op(ac_t, ac_j)
    parts_j = [ac_j[i] for i in range(3)]
    parts_t = [ac_t[i] for i in range(3)]
    assert_same_op(tutils.tensor_list(parts_t), jutils.tensor_list(parts_j))
    assert_same_op(tutils.product_list(parts_t), jutils.product_list(parts_j))


def test_mgh2_cs_flow_device_equals_host():
    """MgH2 (22 -> 17 -> 8 qubits, tapered reference state and UCCSD
    operator): the device path equals the port's host path term for term.
    The device cleanup keeps the host path's first-occurrence term order,
    so the magnitude-sorted noncontextual sweep breaks ties alike."""
    data = load_reference_hamiltonian("MgH2_STO-3G_SINGLET_JW.json")
    out = {}
    for backend in ("device", "host"):
        tconfig.backend = backend
        H = symmer_torch.PauliwordOp.from_dictionary(data["hamiltonian"])
        qt = symmer_torch.QubitTapering(H)
        H_taper = qt.taper_it(ref_state=np.asarray(data["data"]["hf_array"]))
        cs = symmer_torch.ContextualSubspace(
            H_taper, noncontextual_strategy="SingleSweep_magnitude",
            reference_state=qt.tapered_ref_state.normalize,
        )
        aux = qt.taper_it(aux_operator=symmer_torch.PauliwordOp.from_dictionary(
            data["data"]["auxiliary_operators"]["UCCSD_operator"]))
        cs.update_stabilizers(8, aux_operator=aux, strategy="aux_preserving")
        out[backend] = (cs.noncontextual_operator, cs.project_onto_subspace())
    assert_same_op(out["device"][0], out["host"][0], rtol=0)
    assert out["device"][1].n_qubits == 8
    assert_same_op(out["device"][1], out["host"][1])
