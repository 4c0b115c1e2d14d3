"""symmer_torch.kernels.torch_core against symmer_tpu.kernels.jx_core.

The same seeded numpy inputs go through each plain-torch function (on the
CPU device) and its JAX counterpart.  anticommutes and clifford_scan must
match exactly (bit for bit); the cleanup family must give equal term sets
with coefficients within 1e-12 relative (the sums run in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmer_tpu.kernels import jx_core, np_core, pack
from symmer_tpu.kernels.pallas_gf2 import anticommutes_tiled
from symmer_torch.kernels import cuda, torch_core

RTOL = 1e-12
QUBITS = [1, 63, 64, 65, 130]


def planes(rng, rows, n_qubits, density=0.5):
    return pack.pack_bits(rng.random((rows, n_qubits)) < density, n_qubits)


def coeffs(rng, rows):
    return rng.normal(size=rows) + 1j * rng.normal(size=rows)


def tt(a):
    """host uint64 planes / float arrays -> CPU torch tensor."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    return torch.from_numpy(a.copy())


def jj(a):
    """host uint64 planes -> jax uint32 planes."""
    return jnp.asarray(pack.to_u32(np.ascontiguousarray(a, np.uint64)))


def from_torch(x, z, cr, ci):
    return (x.numpy().view(np.uint64), z.numpy().view(np.uint64),
            cr.numpy() + 1j * ci.numpy())


def from_jax(x, z, cr, ci, n):
    n = int(n)
    return (pack.from_u32(np.asarray(x[:n])), pack.from_u32(np.asarray(z[:n])),
            np.asarray(cr[:n]) + 1j * np.asarray(ci[:n]))


def assert_same_terms(a, b, rtol=RTOL):
    (xa, za, ca), (xb, zb, cb) = a, b
    assert xa.shape[0] == xb.shape[0], (xa.shape, xb.shape)
    ra, rb = np.hstack([xa, za]), np.hstack([xb, zb])
    oa, ob = np.lexsort(ra.T[::-1]), np.lexsort(rb.T[::-1])
    assert np.array_equal(ra[oa], rb[ob])
    ca, cb = ca[oa], cb[ob]
    scale = np.maximum(np.maximum(np.abs(ca), np.abs(cb)), np.finfo(float).tiny)
    assert np.all(np.abs(ca - cb) <= rtol * scale)


@pytest.mark.parametrize("n_qubits", QUBITS)
def test_popcount_and_parity(n_qubits):
    rng = np.random.default_rng(n_qubits)
    w = planes(rng, 200, n_qubits)
    w = np.vstack([w, np.full((1, w.shape[1]), np.uint64(2**64 - 1))])
    t = tt(w)
    assert np.array_equal(torch_core.popcount(t).numpy(), np.bitwise_count(w).astype(np.int64))
    assert np.array_equal(torch_core.parity64(t).numpy(), np.bitwise_count(w).astype(np.int64) & 1)
    z = planes(rng, w.shape[0], n_qubits)
    assert np.array_equal(
        torch_core.y_count(t, tt(z)).numpy(), np.asarray(jx_core.y_count(jj(w), jj(z)))
    )


@pytest.mark.parametrize("n_qubits", QUBITS)
@pytest.mark.parametrize("m1,m2", [(300, 70), (10, 600), (257, 4)])
def test_anticommutes_matches_jax_and_pallas(n_qubits, m1, m2):
    rng = np.random.default_rng(m1 * 1000 + n_qubits)
    x1, z1 = planes(rng, m1, n_qubits), planes(rng, m1, n_qubits)
    x2, z2 = planes(rng, m2, n_qubits), planes(rng, m2, n_qubits)
    got = torch_core.anticommutes(tt(x1), tt(z1), tt(x2), tt(z2)).numpy()
    want = np.asarray(jx_core.anticommutes(jj(x1), jj(z1), jj(x2), jj(z2)))
    assert got.dtype == bool and np.array_equal(got, want)
    # the Pallas TPU kernel in interpret mode, as tests/test_kernels/test_pallas.py runs it
    pallas = np.asarray(anticommutes_tiled(jj(x1), jj(z1), jj(x2), jj(z2)))
    assert np.array_equal(got, pallas)
    # the CUDA wrapper takes the plain version for CPU tensors
    assert np.array_equal(cuda.anticommutes(tt(x1), tt(z1), tt(x2), tt(z2)).numpy(), want)


def test_anticommutes_chunked_rows():
    """Row chunks of the plain version tile the output exactly."""
    rng = np.random.default_rng(5)
    x1, z1, x2, z2 = (planes(rng, m, 70) for m in (50, 50, 9, 9))
    old = torch_core._AC_CHUNK
    torch_core._AC_CHUNK = 2 * 9 * 2  # two rows per chunk
    try:
        got = torch_core.anticommutes(tt(x1), tt(z1), tt(x2), tt(z2)).numpy()
    finally:
        torch_core._AC_CHUNK = old
    assert np.array_equal(got, np_core.anticommutes(x1, z1, x2, z2))


@pytest.mark.parametrize("n_qubits", QUBITS)
def test_mul_single_and_anticommutes_single(n_qubits):
    rng = np.random.default_rng(7 + n_qubits)
    x, z, c = planes(rng, 120, n_qubits), planes(rng, 120, n_qubits), coeffs(rng, 120)
    xr, zr = planes(rng, 1, n_qubits)[0], planes(rng, 1, n_qubits)[0]
    got = torch_core.mul_single(tt(x), tt(z), tt(c.real), tt(c.imag), tt(xr), tt(zr))
    want = jx_core.mul_single(jj(x), jj(z), jnp.asarray(c.real), jnp.asarray(c.imag),
                              jj(xr[None])[0], jj(zr[None])[0])
    assert np.array_equal(got[0].numpy().view(np.uint64), pack.from_u32(np.asarray(want[0])))
    assert np.array_equal(got[1].numpy().view(np.uint64), pack.from_u32(np.asarray(want[1])))
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    assert np.array_equal(got[3].numpy(), np.asarray(want[3]))
    ac = torch_core.anticommutes_single(tt(x), tt(z), tt(xr), tt(zr)).numpy()
    assert np.array_equal(ac, np.asarray(
        jx_core.anticommutes_single(jj(x), jj(z), jj(xr[None])[0], jj(zr[None])[0])
    ))


@pytest.mark.parametrize("n_qubits", QUBITS)
def test_clifford_scan_bitwise(n_qubits):
    rng = np.random.default_rng(11 + n_qubits)
    T, D = 300, 40
    x, z, c = planes(rng, T, n_qubits), planes(rng, T, n_qubits), coeffs(rng, T)
    c[:5] = [0.0, -0.0, 1.0, -1.0, 0.0]  # signed zeros must survive bit for bit
    rx, rz = planes(rng, D, n_qubits, 0.2), planes(rng, D, n_qubits, 0.2)
    rm = rng.integers(-5, 6, D)
    got = torch_core.clifford_scan(tt(x), tt(z), tt(c.real), tt(c.imag), tt(rx), tt(rz),
                                   torch.tensor(rm))
    want = jx_core.clifford_scan(jj(x), jj(z), jnp.asarray(c.real), jnp.asarray(c.imag),
                                 jj(rx), jj(rz), jnp.asarray(rm, jnp.int32))
    assert np.array_equal(got[0].numpy().view(np.uint64), pack.from_u32(np.asarray(want[0])))
    assert np.array_equal(got[1].numpy().view(np.uint64), pack.from_u32(np.asarray(want[1])))
    for g, w in zip(got[2:], want[2:]):
        assert np.array_equal(g.numpy().view(np.int64), np.asarray(w).view(np.int64))
    # and against the host oracle (np_core.clifford_sequence)
    hx, hz, hc = np_core.clifford_sequence(x, z, c, rx, rz, rm % 4)
    assert np.array_equal(got[0].numpy().view(np.uint64), hx)
    assert np.allclose(got[2].numpy() + 1j * got[3].numpy(), hc, rtol=0, atol=0)


def test_row_signature_groups_by_row():
    rng = np.random.default_rng(3)
    base = planes(rng, 400, 130), planes(rng, 400, 130)
    idx = rng.integers(0, 400, 3000)
    x, z = base[0][idx], base[1][idx]
    ka, kb = torch_core.row_signature(tt(x), tt(z))
    sig = np.stack([ka.numpy(), kb.numpy()], 1)
    _, inv_sig = np.unique(sig, axis=0, return_inverse=True)
    _, inv_row = np.unique(np.hstack([x, z]), axis=0, return_inverse=True)
    # same partition of the rows: equal signatures iff equal rows
    pairs = set(zip(inv_sig.ravel().tolist(), inv_row.ravel().tolist()))
    assert len(pairs) == len(set(inv_sig.ravel().tolist())) == len(set(inv_row.ravel().tolist()))


def _dup_operator(rng, n_qubits, n_unique, n_rows):
    ux, uz = planes(rng, n_unique, n_qubits), planes(rng, n_unique, n_qubits)
    idx = rng.integers(0, n_unique, n_rows)
    return ux[idx], uz[idx], coeffs(rng, n_rows)


def _jax_cleanup(x, z, c, th, pad=0):
    T = x.shape[0]
    xp = np.vstack([x, np.zeros((pad, x.shape[1]), np.uint64)])
    zp = np.vstack([z, np.zeros((pad, z.shape[1]), np.uint64)])
    cp = np.concatenate([c, np.ones(pad)])  # padding carries junk: n_valid masks it
    return from_jax(*jx_core.cleanup_sorted(
        jj(xp), jj(zp), jnp.asarray(cp.real), jnp.asarray(cp.imag), T,
        None if th is None else jnp.asarray(th),
    ))


@pytest.mark.parametrize("n_qubits", QUBITS)
@pytest.mark.parametrize("th", [1e-15, None])
def test_cleanup_matches_jax(n_qubits, th):
    rng = np.random.default_rng(17 + n_qubits)
    x, z, c = _dup_operator(rng, n_qubits, 150, 1000)
    c[:40] = 0.0  # rows whose whole group may be exact zeros
    got = from_torch(*torch_core.cleanup_sorted(tt(x), tt(z), tt(c.real), tt(c.imag), th))
    # n_valid < bucket on the JAX side: the padding rows are ignored
    assert_same_terms(got, _jax_cleanup(x, z, c, th, pad=24))
    assert_same_terms(got, np_core.cleanup(x, z, c, th))


def test_cleanup_total_cancellation_and_zero_threshold_none():
    rng = np.random.default_rng(19)
    x, z = planes(rng, 50, 65), planes(rng, 50, 65)
    c = coeffs(rng, 50)
    X, Z, C = np.vstack([x, x]), np.vstack([z, z]), np.concatenate([c, -c])
    args = (tt(X), tt(Z), tt(C.real), tt(C.imag))
    got = torch_core.cleanup_sorted(*args, 1e-15)
    assert got[0].shape == (0, 2) and got[2].shape == (0,)
    assert _jax_cleanup(X, Z, C, 1e-15)[0].shape[0] == 0
    # threshold None: dedup only, the 50 exact zeros are kept
    kept = from_torch(*torch_core.cleanup_sorted(*args, None))
    assert kept[0].shape[0] == 50 and np.all(kept[2] == 0)
    assert_same_terms(kept, _jax_cleanup(X, Z, C, None))
    empty = torch_core.cleanup_sorted(*(a[:0] for a in args), 1e-15)
    assert all(t.shape[0] == 0 for t in empty)


@pytest.mark.parametrize("n_qubits", QUBITS)
@pytest.mark.parametrize("th", [1e-15, None])
def test_mul_pairs_cleanup_matches_jax(n_qubits, th):
    rng = np.random.default_rng(23 + n_qubits)
    x1, z1, c1 = _dup_operator(rng, n_qubits, 25, 30)
    x2, z2, c2 = _dup_operator(rng, n_qubits, 15, 20)
    got = from_torch(*torch_core.mul_pairs_cleanup(
        tt(x1), tt(z1), tt(c1.real), tt(c1.imag),
        tt(x2), tt(z2), tt(c2.real), tt(c2.imag), th,
    ))
    want = from_jax(*jx_core.mul_pairs_cleanup(
        jj(x1), jj(z1), jnp.asarray(c1.real), jnp.asarray(c1.imag),
        jj(x2), jj(z2), jnp.asarray(c2.real), jnp.asarray(c2.imag),
        None if th is None else jnp.asarray(th),
    ))
    assert_same_terms(got, want)
    assert_same_terms(got, np_core.multiply_cleanup_host(x1, z1, c1, x2, z2, c2, th))


@pytest.mark.parametrize("n_qubits", QUBITS)
def test_rotate_nonclifford_cleanup(n_qubits):
    rng = np.random.default_rng(29 + n_qubits)
    x, z, c = _dup_operator(rng, n_qubits, 200, 260)
    xr, zr = planes(rng, 1, n_qubits, 0.3)[0], planes(rng, 1, n_qubits, 0.3)[0]
    t = 0.37
    args = (tt(x), tt(z), tt(c.real), tt(c.imag), tt(xr), tt(zr), np.cos(t), np.sin(t))
    got = from_torch(*torch_core.rotate_nonclifford_cleanup(*args, 1e-15))
    want = from_jax(*jx_core.rotate_nonclifford_cleanup(
        jj(x), jj(z), jnp.asarray(c.real), jnp.asarray(c.imag),
        jj(xr[None])[0], jj(zr[None])[0], None, x.shape[0], jnp.asarray(1e-15),
        trig=(jnp.asarray(np.cos(t)), jnp.asarray(np.sin(t))),
    ))
    assert_same_terms(got, want)
    # zero_threshold=None: dedup only, and only anticommuting terms grow a
    # P Q row -- the host semantics (np_core.rotate_single_cleanup)
    got_nt = from_torch(*torch_core.rotate_nonclifford_cleanup(*args, None))
    assert_same_terms(got_nt, np_core.rotate_single_cleanup(x, z, c, xr, zr, t, None))


@pytest.mark.parametrize("n_qubits", [64, 65, 130])
def test_clifford_project_cleanup_matches_jax(n_qubits):
    from symmer_tpu.kernels import dispatch as jdispatch

    rng = np.random.default_rng(31 + n_qubits)
    x, z, c = _dup_operator(rng, n_qubits, 300, 400)
    D, S = 6, 3
    rx, rz = planes(rng, D, n_qubits, 0.1), planes(rng, D, n_qubits, 0.1)
    ms = rng.integers(-3, 4, D)
    qubits = rng.choice(n_qubits, S, replace=False)
    stab = np.zeros((S, n_qubits), bool)
    stab[np.arange(S), qubits] = True
    W = pack.n_words_for(n_qubits)
    sx, sz = np.zeros((S, W), np.uint64), pack.pack_bits(stab, n_qubits)
    sx[1] = sz[1]  # one Y-type stabilizer
    signs = np.array([1, -1, -1])
    free = np.ones(n_qubits, bool)
    free[qubits] = False
    zmask, xmask, neg_x, neg_z, col_keep = jdispatch.stabilizer_masks(sx, sz, signs, free)
    got = from_torch(*torch_core.clifford_project_cleanup(
        tt(x), tt(z), tt(c.real), tt(c.imag), tt(rx), tt(rz), torch.tensor(ms),
        tt(sx), tt(sz), tt(neg_x), tt(neg_z), tt(col_keep), 1e-15,
    ))
    row = lambda a: jj(a[None])[0]
    want = from_jax(*jx_core.clifford_project_cleanup(
        jj(x), jj(z), jnp.asarray(c.real), jnp.asarray(c.imag), x.shape[0],
        jj(rx), jj(rz), jnp.asarray(ms, jnp.int32), jj(sx), jj(sz),
        row(neg_x), row(neg_z), row(col_keep), jnp.asarray(1e-15),
    ))
    assert got[0].shape[0] > 0
    assert_same_terms(got, want)


def test_expval_iz_sum_matches_jax():
    rng = np.random.default_rng(37)
    x, z, c = planes(rng, 300, 65, 0.01), planes(rng, 300, 65), coeffs(rng, 300)
    got = torch_core.expval_iz_sum(tt(x), tt(c.real), tt(c.imag))
    want = jx_core.expval_iz_sum(jj(x), jnp.asarray(c.real), jnp.asarray(c.imag), 300)
    g = complex(float(got[0]), float(got[1]))
    w = complex(float(want[0]), float(want[1]))
    assert (np.sum(~np.any(x != 0, axis=1))) > 0
    assert abs(g - w) <= RTOL * max(1.0, abs(w))
