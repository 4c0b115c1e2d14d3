"""The tapering slice as a whole: symmer_torch against symmer_tpu and the pins.

QubitTapering(H).taper_it(..., aux_operator=H.to_device()) runs resident on
the port's device path (here the CPU device: plain torch versions of the
kernels).  Energies must match their pins to 1e-10 (BASELINE.md:29-30); the
synthetic taper must equal symmer_tpu's term set with coefficients within
1e-12 relative.
"""
import numpy as np
import pytest

import symmer_tpu
import symmer_torch
from symmer_tpu.config import config as jconfig
from symmer_torch import config as tconfig
from symmer_torch.kernels import dispatch as tdispatch
from symmer_torch.profiling import kernel_stats

from .conftest import load_reference_hamiltonian

LIH_TAPERED_GS_EXACT = -7.8827622309719985  # tests/test_projection/test_molecule_parity.py:56


@pytest.fixture(autouse=True)
def torch_device_path(monkeypatch):
    old = (tconfig.backend, tconfig.device, jconfig.backend)
    tconfig.backend, tconfig.device, jconfig.backend = "device", "cpu", "auto"
    # the small inputs here take the device path of every entry
    monkeypatch.setattr(tdispatch, "DEVICE_FLOOR", 0)
    yield
    tconfig.backend, tconfig.device, jconfig.backend = old


def ground_energy(op) -> float:
    return float(np.linalg.eigvalsh(op.to_sparse_matrix.toarray())[0])


@pytest.mark.parametrize("resident", [True, False])
def test_h2_taper_equals_fci(h2_fixture, resident):
    H = symmer_torch.PauliwordOp.from_dictionary(h2_fixture["H_dict"])
    qt = symmer_torch.QubitTapering(H)
    out = qt.taper_it(
        ref_state=h2_fixture["hf_array"],
        aux_operator=H.to_device() if resident else None,
    )
    if resident:
        assert isinstance(out, symmer_torch.DeviceOperator)
        out = out.to_host()
    assert out.n_qubits == 1
    assert abs(ground_energy(out) - h2_fixture["fci_energy"]) < 1e-10


def test_lih_taper_pinned_1e10():
    data = load_reference_hamiltonian("LiH_STO-3G_SINGLET_JW.json")
    H = symmer_torch.PauliwordOp.from_dictionary(data["hamiltonian"])
    kernel_stats.reset()
    out = symmer_torch.QubitTapering(H).taper_it(
        ref_state=np.asarray(data["data"]["hf_array"]), aux_operator=H.to_device()
    ).to_host()
    assert out.n_qubits == 8
    assert abs(ground_energy(out) - LIH_TAPERED_GS_EXACT) < 1e-10
    # the symmetry search and the stabilizer rotations went through the
    # device dispatch (anticommutes, perform_rotations)
    assert kernel_stats.device_calls["anticommutes"] >= 1
    assert kernel_stats.device_calls["perform_rotations"] >= 1


def _synthetic(n_qubits, n_terms, n_sym, seed):
    """bench.py:647-664: n_sym planted Z2 symmetries."""
    rng = np.random.default_rng(seed)
    block = n_qubits // n_sym
    xb = rng.integers(0, 2, (n_terms, n_qubits)).astype(bool)
    zb = rng.integers(0, 2, (n_terms, n_qubits)).astype(bool)
    for k in range(n_sym):
        parity = xb[:, k * block : (k + 1) * block].sum(axis=1) & 1
        xb[parity == 1, k * block] ^= True
    coeffs = rng.normal(size=n_terms) + 1j * rng.normal(size=n_terms)
    return np.hstack([xb, zb]), coeffs


def assert_same(a, b, rtol=1e-12):
    assert a.n_qubits == b.n_qubits and a.n_terms == b.n_terms
    ra, rb = np.hstack([a.x_pack, a.z_pack]), np.hstack([b.x_pack, b.z_pack])
    oa, ob = np.lexsort(ra.T[::-1]), np.lexsort(rb.T[::-1])
    assert np.array_equal(ra[oa], rb[ob])
    ca, cb = a.coeff_vec[oa], b.coeff_vec[ob]
    scale = np.maximum(np.maximum(np.abs(ca), np.abs(cb)), np.finfo(float).tiny)
    assert np.all(np.abs(ca - cb) <= rtol * scale)


@pytest.mark.parametrize("sector", ["ref_state", "explicit"])
def test_synthetic_taper_matches_symmer_tpu(sector):
    """64 qubits x 8000 terms, 3 symmetries (bench.py:979), resident."""
    symp, c = _synthetic(64, 8000, 3, 7)
    Ht = symmer_torch.PauliwordOp(symp, c).cleanup()
    Hj = symmer_tpu.PauliwordOp(symp, c).cleanup()
    ref = np.zeros(64, dtype=int)
    qt, qj = symmer_torch.QubitTapering(Ht), symmer_tpu.QubitTapering(Hj)
    assert qt.n_taper == qj.n_taper == 3
    kw = (dict(ref_state=ref) if sector == "ref_state"
          else dict(sector=np.array([1, -1, -1])))
    kernel_stats.reset()
    got = qt.taper_it(aux_operator=Ht.to_device(), **kw).to_host()
    want = qj.taper_it(**kw)
    assert got.n_qubits == 61
    assert_same(got, want)
    # the host-in/host-out fused projection (dispatch.clifford_rotate_project)
    assert_same(symmer_torch.QubitTapering(Ht).taper_it(**kw), want)
    assert kernel_stats.device_calls["clifford_rotate_project"] == 1
    # the port's host path (native C++)
    tconfig.backend = "host"
    assert_same(symmer_torch.QubitTapering(Ht).taper_it(**kw), want)
    assert np.array_equal(qt.free_qubit_indices, qj.free_qubit_indices)
