"""symmer_torch operators against symmer_tpu on the same inputs.

The port runs its device path on the CPU device (backend="device",
device="cpu": the plain torch versions of the kernels); symmer_tpu runs its
host path.  Operators must be equal term sets with coefficients within
1e-12 relative.  The last group ports the pending-projection guard tests of
tests/test_operators/test_device_operator.py for the methods on the slice.
"""
import numpy as np
import pytest

import symmer_tpu
import symmer_torch
from symmer_tpu.config import config as jconfig
from symmer_torch import config as tconfig
from symmer_torch.kernels import dispatch as tdispatch
from symmer_torch.operators import DeviceOperator, from_numpy_planes
from symmer_torch.profiling import kernel_stats

RTOL = 1e-12


@pytest.fixture(autouse=True)
def torch_device_path(monkeypatch):
    old = (tconfig.backend, tconfig.device, jconfig.backend)
    tconfig.backend, tconfig.device, jconfig.backend = "device", "cpu", "host"
    # the small inputs here take the device path of every entry
    monkeypatch.setattr(tdispatch, "DEVICE_FLOOR", 0)
    yield
    tconfig.backend, tconfig.device, jconfig.backend = old


def ops(n_qubits, n_terms, seed, density=0.3, n_diagonal=0):
    """The same random operator in both packages; the first ``n_diagonal``
    terms are I/Z-only."""
    rng = np.random.default_rng(seed)
    symp = rng.random((n_terms, 2 * n_qubits)) < density
    symp[:n_diagonal, :n_qubits] = False
    c = rng.normal(size=n_terms) + 1j * rng.normal(size=n_terms)
    return symmer_torch.PauliwordOp(symp, c), symmer_tpu.PauliwordOp(symp, c)


def pauli(n_qubits, seed):
    t, j = ops(n_qubits, 1, seed, 0.2)
    t.coeff_vec[:] = 1
    j.coeff_vec[:] = 1
    return t, j


def assert_same(a, b, rtol=RTOL):
    assert a.n_qubits == b.n_qubits
    assert a.n_terms == b.n_terms
    ra, rb = np.hstack([a.x_pack, a.z_pack]), np.hstack([b.x_pack, b.z_pack])
    oa, ob = np.lexsort(ra.T[::-1]), np.lexsort(rb.T[::-1])
    assert np.array_equal(ra[oa], rb[ob])
    ca, cb = a.coeff_vec[oa], b.coeff_vec[ob]
    scale = np.maximum(np.maximum(np.abs(ca), np.abs(cb)), np.finfo(float).tiny)
    assert np.all(np.abs(ca - cb) <= rtol * scale)


@pytest.mark.parametrize("n_qubits", [1, 64, 65, 130])
def test_cleanup_and_product(n_qubits):
    t, j = ops(n_qubits, 300, n_qubits)
    kernel_stats.reset()
    assert_same(t.cleanup(), j.cleanup())
    t2, j2 = ops(n_qubits, 40, n_qubits + 1)
    assert_same(t * t2, j * j2)
    assert_same(t2 * t2, j2 * j2)
    assert kernel_stats.device_calls["cleanup"] >= 1
    assert kernel_stats.device_calls["multiply"] >= 2


def test_product_zero_threshold_none_keeps_exact_zeros():
    t, j = ops(20, 30, 3)
    got = t.__mul__(t.multiply_by_constant(0), zero_threshold=None)
    want = j.__mul__(j.multiply_by_constant(0), zero_threshold=None)
    assert got.n_terms > 0 and np.all(got.coeff_vec == 0)
    assert_same(got, want)


@pytest.mark.parametrize("n_qubits", [63, 65, 130])
def test_perform_rotations_mixed(n_qubits):
    t, j = ops(n_qubits, 200, 10 + n_qubits)
    angles = [0.3, None, np.pi, -np.pi / 2, 0.71, 3 * np.pi / 2, None]
    rots = [pauli(n_qubits, 50 + k) for k in range(len(angles))]
    got = t.perform_rotations([(r[0], a) for r, a in zip(rots, angles)])
    want = j.perform_rotations([(r[1], a) for r, a in zip(rots, angles)])
    assert got.n_terms > t.cleanup().n_terms  # the non-Clifford steps grew it
    assert_same(got, want)


@pytest.mark.parametrize("n_qubits", [1, 65])
def test_commutes_termwise_and_adjacency(n_qubits):
    t, j = ops(n_qubits, 90, 20 + n_qubits)
    t2, j2 = ops(n_qubits, 35, 21 + n_qubits)
    assert np.array_equal(t.commutes_termwise(t2), j.commutes_termwise(j2))
    assert np.array_equal(t.adjacency_matrix, j.adjacency_matrix)
    assert kernel_stats.device_calls["anticommutes"] >= 2


def test_host_backend_matches_device_backend():
    t, _ = ops(70, 150, 30)
    tconfig.backend = "host"
    host = (t * t).perform_rotations([(pauli(70, 31)[0], 0.4)])
    tconfig.backend = "device"
    assert_same((t * t).perform_rotations([(pauli(70, 31)[0], 0.4)]), host)


def test_from_numpy_planes_roundtrip_bit_exact():
    _, j = ops(130, 80, 40)
    t = from_numpy_planes(j.x_pack, j.z_pack, j.coeff_vec, j.n_qubits)
    assert np.array_equal(t.x_pack, j.x_pack) and np.array_equal(t.z_pack, j.z_pack)
    assert np.array_equal(t.coeff_vec.view(np.uint64), j.coeff_vec.view(np.uint64))
    assert t.x_pack is not j.x_pack
    back = t.to_device().to_host()
    jb = symmer_tpu.PauliwordOp.from_planes(back.x_pack, back.z_pack, back.coeff_vec, 130)
    assert_same(jb, j)
    with pytest.raises(ValueError, match="words per row"):
        from_numpy_planes(j.x_pack, j.z_pack, j.coeff_vec, 200)
    with pytest.raises(ValueError, match="coefficients"):
        from_numpy_planes(j.x_pack, j.z_pack, j.coeff_vec[:-1], 130)


def test_device_operator_chain():
    H, Hj = ops(40, 120, 41, 0.1, n_diagonal=60)
    G, Gj = ops(40, 30, 42, 0.1, n_diagonal=15)
    rots = [(pauli(40, 43 + k), a) for k, a in enumerate([0.3, None, np.pi, 0.9])]
    dev = (H.to_device().cleanup() * G.to_device()).perform_rotations(
        [(r[0], a) for r, a in rots]
    )
    want = (Hj.cleanup() * Gj).perform_rotations([(r[1], a) for r, a in rots])
    assert isinstance(dev, DeviceOperator) and dev.n_terms == want.n_terms
    assert_same(dev.to_host(), want)
    diag = ~np.any(want.x_pack != 0, axis=1)
    assert diag.any()
    e = complex(np.sum(want.coeff_vec[diag]))
    assert abs(dev.expval_iz() - e) <= RTOL * max(1.0, abs(e))
    assert "DeviceOperator" in repr(dev) and dev.copy() is dev


def test_device_operator_fully_cancelled():
    t = symmer_torch.PauliwordOp.from_list(["XZ", "XZ"], [1, -1])
    d = t.to_device().cleanup()
    assert d.n_terms == 0
    assert d.to_host() == t.cleanup()
    # a fully cancelled non-Clifford step continues from one zero row
    r = symmer_torch.PauliwordOp.from_list(["ZI"])
    assert d.perform_rotations([(r, 0.3)], zero_threshold=None).n_terms == 1
    assert d.perform_rotations([(r, 0.3)]).n_terms == 0


def test_device_operator_expval_matches_symmer_tpu():
    """DeviceOperator.expval runs the state kernel: it agrees with
    symmer_tpu's DeviceOperator.expval and the host path."""
    t, j = ops(6, 10, 44, n_diagonal=4)
    rows = np.array([[0] * 6, [1, 0, 1, 0, 0, 1], [0] * 6])
    amps = np.array([0.6, 0.3 - 0.4j, 0.1j])
    got = t.to_device().expval(symmer_torch.QuantumState(rows, amps))
    want = j.to_device().expval(symmer_tpu.QuantumState(rows, amps))
    host = j.expval(symmer_tpu.QuantumState(rows, amps))
    assert abs(got) > 1e-3
    for other in (want, host):
        assert abs(got - other) <= RTOL * abs(other)


# -- pending-projection (_free_mask) guards (859b97b) -------------------------

def _planted_taper(n_qubits=12, n_terms=400, n_sym=2, seed=0):
    rng = np.random.default_rng(seed)
    block = n_qubits // n_sym
    xb = rng.integers(0, 2, (n_terms, n_qubits)).astype(bool)
    zb = rng.integers(0, 2, (n_terms, n_qubits)).astype(bool)
    for k in range(n_sym):
        parity = xb[:, k * block : (k + 1) * block].sum(axis=1) & 1
        xb[parity == 1, k * block] ^= True
    H = symmer_torch.PauliwordOp(np.hstack([xb, zb]), rng.normal(size=n_terms)).cleanup()
    ref = np.zeros(n_qubits, dtype=int)
    t_host = symmer_torch.QubitTapering(H).taper_it(ref_state=ref)
    qt_d = symmer_torch.QubitTapering(H)
    t_dev = qt_d.taper_it(ref_state=ref, aux_operator=H.to_device())
    return H, t_host, t_dev, qt_d


def _single_x(n_qubits, qubit):
    s = ["I"] * n_qubits
    s[qubit] = "X"
    return symmer_torch.PauliwordOp.from_list(["".join(s)])


def test_resident_rotation_after_projection_keeps_reduction():
    H, t_host, t_dev, qt = _planted_taper()
    q_full = list(qt.free_qubit_indices)[2]
    want = t_host.perform_rotations([(_single_x(t_host.n_qubits, 2), 0.4)])
    got = t_dev.perform_rotations([(_single_x(H.n_qubits, q_full), 0.4)]).to_host()
    assert got.n_qubits == t_host.n_qubits
    assert got == want


def test_resident_rotation_on_stabilized_qubit_rejected():
    H, _, t_dev, qt = _planted_taper()
    stab_q = int(np.setdiff1d(np.arange(H.n_qubits), qt.free_qubit_indices)[0])
    with pytest.raises(ValueError, match="stabilized"):
        t_dev.perform_rotations([(_single_x(H.n_qubits, stab_q), 0.4)])


def test_resident_second_projection_rejected():
    H, _, t_dev, _ = _planted_taper()
    qt_fresh = symmer_torch.QubitTapering(H)
    with pytest.raises(ValueError, match="pending projection"):
        qt_fresh.taper_it(sector=np.ones(qt_fresh.n_taper, dtype=int), aux_operator=t_dev)
    with pytest.raises(ValueError, match="pending projection"):
        t_dev.clifford_rotate_project(
            [], qt_fresh.symmetry_generators.rotate_onto_single_qubit_paulis(),
            np.ones(H.n_qubits, dtype=bool),
        )


def test_resident_multiply_mixed_masks_rejected():
    H, _, t_dev, _ = _planted_taper()
    with pytest.raises(ValueError, match="free-qubit masks differ"):
        t_dev.multiply(H.to_device())


def test_resident_multiply_same_mask_matches_host():
    _, t_host, t_dev, _ = _planted_taper()
    assert t_dev.multiply(t_dev).to_host() == (t_host * t_host).cleanup()


def test_auto_backend_routes_by_size():
    t, j = ops(70, 60, 45)
    tconfig.backend, old = "auto", tconfig.device_threshold
    tconfig.device_threshold = 60 * 2 * 50  # term-words of a 60 x 50 product
    try:
        kernel_stats.reset()
        assert_same(t.cleanup(), j.cleanup())          # 60 x 2 words: host
        assert_same(t * t, j * j)                      # 60 x 60 x 2 words: device
        assert kernel_stats.host_calls["cleanup"] >= 1
        assert kernel_stats.device_calls["multiply"] == 1
        assert kernel_stats.device_calls["cleanup"] == 0
    finally:
        tconfig.device_threshold = old
