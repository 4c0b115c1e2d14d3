"""The vendored host layer of symmer_torch agrees bit for bit with symmer_tpu's.

symmer_torch copies pack, np_core, gf2, state_core and the native C++
library (it must not import symmer_tpu, which pulls in jax).  Seeded random
inputs go through both copies; every output must be identical.
"""
import numpy as np
import pytest

from symmer_tpu.kernels import gf2 as j_gf2
from symmer_tpu.kernels import np_core as j_np
from symmer_tpu.kernels import pack as j_pack
from symmer_tpu.kernels import state_core as j_state
from symmer_tpu.native import gf2core as j_native
from symmer_torch.kernels import gf2 as t_gf2
from symmer_torch.kernels import np_core as t_np
from symmer_torch.kernels import pack as t_pack
from symmer_torch.kernels import state_core as t_state
from symmer_torch.native import gf2core as t_native

QUBITS = [1, 63, 64, 65, 130]


def planes(rng, rows, n_qubits, density=0.5):
    return j_pack.pack_bits(rng.random((rows, n_qubits)) < density, n_qubits)


def dup_operator(rng, n_qubits, n_unique, n_rows):
    ux, uz = planes(rng, n_unique, n_qubits), planes(rng, n_unique, n_qubits)
    idx = rng.integers(0, n_unique, n_rows)
    c = rng.normal(size=n_rows) + 1j * rng.normal(size=n_rows)
    return ux[idx], uz[idx], c


def assert_identical(a, b):
    assert len(a) == len(b)
    for u, v in zip(a, b):
        u, v = np.asarray(u), np.asarray(v)
        assert u.dtype == v.dtype and u.shape == v.shape
        assert np.array_equal(u.view(np.uint8), v.view(np.uint8))


def test_native_library_built_for_both():
    assert j_native is not None and t_native is not None


@pytest.mark.parametrize("n_qubits", QUBITS)
def test_pack_roundtrips(n_qubits):
    rng = np.random.default_rng(n_qubits)
    bits = rng.random((40, n_qubits)) < 0.5
    assert_identical([t_pack.pack_bits(bits, n_qubits)], [j_pack.pack_bits(bits, n_qubits)])
    p = j_pack.pack_bits(bits, n_qubits)
    keep = rng.random(n_qubits) < 0.6
    assert_identical([t_pack.select_columns(p, keep)], [j_pack.select_columns(p, keep)])
    assert_identical([t_pack.unpack_bits(p, n_qubits)], [j_pack.unpack_bits(p, n_qubits)])


@pytest.mark.parametrize("n_qubits", QUBITS)
@pytest.mark.parametrize("th", [1e-15, None])
def test_cleanup_identical(n_qubits, th):
    rng = np.random.default_rng(1 + n_qubits)
    x, z, c = dup_operator(rng, n_qubits, 100, 600)
    assert_identical(t_np.cleanup(x, z, c, th), j_np.cleanup(x, z, c, th))


@pytest.mark.parametrize("n_qubits", QUBITS)
@pytest.mark.parametrize("sizes", [(10, 7), (60, 40)])
def test_multiply_cleanup_host_identical(n_qubits, sizes):
    rng = np.random.default_rng(2 + n_qubits)
    x1, z1, c1 = dup_operator(rng, n_qubits, sizes[0], sizes[0])
    x2, z2, c2 = dup_operator(rng, n_qubits, sizes[1], sizes[1])
    assert_identical(
        t_np.multiply_cleanup_host(x1, z1, c1, x2, z2, c2, 1e-15),
        j_np.multiply_cleanup_host(x1, z1, c1, x2, z2, c2, 1e-15),
    )


@pytest.mark.parametrize("n_qubits", QUBITS)
@pytest.mark.parametrize("m", [(30, 20), (700, 500)])
def test_anticommutes_identical(n_qubits, m):
    rng = np.random.default_rng(3 + n_qubits)
    x1, z1 = planes(rng, m[0], n_qubits), planes(rng, m[0], n_qubits)
    x2, z2 = planes(rng, m[1], n_qubits), planes(rng, m[1], n_qubits)
    assert_identical(
        [t_np.anticommutes(x1, z1, x2, z2)], [j_np.anticommutes(x1, z1, x2, z2)]
    )


@pytest.mark.parametrize("n_qubits", QUBITS)
def test_clifford_sequence_and_rotation_identical(n_qubits):
    rng = np.random.default_rng(4 + n_qubits)
    x, z, c = dup_operator(rng, n_qubits, 300, 300)
    rx, rz = planes(rng, 12, n_qubits, 0.2), planes(rng, 12, n_qubits, 0.2)
    m4s = rng.integers(0, 4, 12)
    assert_identical(
        t_np.clifford_sequence(x, z, c, rx, rz, m4s),
        j_np.clifford_sequence(x, z, c, rx, rz, m4s),
    )
    assert_identical(
        t_np.rotate_single_cleanup(x, z, c, rx[0], rz[0], 0.3, 1e-15),
        j_np.rotate_single_cleanup(x, z, c, rx[0], rz[0], 0.3, 1e-15),
    )


@pytest.mark.parametrize("n_qubits,rows", [(40, 30), (100, 6000), (130, 9000)])
def test_kernel_basis_symplectic_identical(n_qubits, rows):
    """Symmetry search (the native verified sketch above 4096 rows)."""
    rng = np.random.default_rng(5 + n_qubits)
    xb = rng.random((rows, n_qubits)) < 0.5
    for k in range(4):  # planted symmetries: even X overlap with 4 blocks
        blk = slice(k * (n_qubits // 4), (k + 1) * (n_qubits // 4))
        xb[xb[:, blk].sum(axis=1) % 2 == 1, blk.start] ^= True
    x = j_pack.pack_bits(xb, n_qubits)
    z = planes(rng, rows, n_qubits)
    got = t_gf2.kernel_basis_symplectic(z, n_qubits, x, n_qubits)
    assert got.shape[0] >= 4
    assert_identical([got], [j_gf2.kernel_basis_symplectic(z, n_qubits, x, n_qubits)])
    m = rng.random((50, 90)) < 0.3
    assert_identical([t_gf2.rref_bool(m, reorder=True)], [j_gf2.rref_bool(m, reorder=True)])


def test_state_core_identical():
    rng = np.random.default_rng(6)
    x, z, c = dup_operator(rng, 70, 40, 40)
    s = planes(rng, 25, 70)
    amps = rng.normal(size=25) + 1j * rng.normal(size=25)
    assert_identical(
        [t_state.termwise_expval(x, z, s, amps)], [j_state.termwise_expval(x, z, s, amps)]
    )
    assert_identical(
        t_state.cleanup_state(*t_state.apply_to_ket(x, z, c, s, amps), 1e-15),
        j_state.cleanup_state(*j_state.apply_to_ket(x, z, c, s, amps), 1e-15),
    )
    assert t_state.expval(x, z, c, s, amps) == j_state.expval(x, z, c, s, amps)
