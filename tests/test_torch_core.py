"""symmer_torch.kernels.torch_core against symmer_tpu.kernels.jx_core.

The same seeded numpy inputs go through each plain-torch function (on the
CPU device) and its JAX counterpart.  anticommutes and clifford_scan must
match exactly (bit for bit); the cleanup family must give equal term sets
with coefficients within 1e-12 relative (the sums run in another order).
"""
import jax
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


# -- the split cleanup: K4 (pair_products), K3 (merge_groups) -----------------
#
# The references below are the composition the cleanup had before K3 and K4
# split it (the product planes built, the signature sorted, torch's
# segment_reduce, a second argsort into first-occurrence order): the split
# functions must give the same bits.

def reference_cleanup(x, z, cr, ci, zero_threshold, keyed=False):
    T = x.shape[0]
    if T == 0:
        return (x, z, cr, ci) + ((x.new_empty((0,)),) if keyed else ())
    ka, kb = torch_core.row_signature(x.contiguous(), z.contiguous())
    perm = torch.argsort(kb, stable=True)
    perm = perm[torch.argsort(ka[perm], stable=True)]
    kas, kbs = ka[perm], kb[perm]
    new = torch.ones(T, dtype=torch.bool)
    new[1:] = (kas[1:] != kas[:-1]) | (kbs[1:] != kbs[:-1])
    starts = new.nonzero().squeeze(1)
    lengths = torch.diff(starts, append=starts.new_full((1,), T))
    c = torch.stack([cr[perm], ci[perm]], dim=1)
    sums = torch.segment_reduce(c, "sum", lengths=lengths, axis=0)
    rep = perm[starts]
    first = torch.argsort(rep)
    rep, sums = rep[first], sums[first]
    if zero_threshold is not None:
        keep = (torch.hypot(sums[:, 0], sums[:, 1]) > zero_threshold).nonzero().squeeze(1)
        rep, sums = rep[keep], sums[keep]
    out = x[rep], z[rep], sums[:, 0].contiguous(), sums[:, 1].contiguous()
    return out + (ka[rep],) if keyed else out


def reference_products(x1, z1, cr1, ci1, x2, z2, cr2, ci2):
    M1, W = x1.shape
    M2 = x2.shape[0]
    xo = (x1[:, None, :] ^ x2[None, :, :]).reshape(M1 * M2, W)
    zo = (z1[:, None, :] ^ z2[None, :, :]).reshape(M1 * M2, W)
    y_in = (torch_core.y_count(x1, z1)[:, None] + torch_core.y_count(x2, z2)[None, :]).reshape(-1)
    y_out = torch_core.y_count(xo, zo)
    sign = 1 - 2 * (
        torch_core.popcount(x1[:, None, :] & z2[None, :, :]).sum(-1) & 1
    ).reshape(-1).to(cr1.dtype)
    pr = (cr1[:, None] * cr2[None, :] - ci1[:, None] * ci2[None, :]).reshape(-1)
    pi = (cr1[:, None] * ci2[None, :] + ci1[:, None] * cr2[None, :]).reshape(-1)
    pr, pi = torch_core.apply_i_pow(3 * y_in + y_out, pr * sign, pi * sign)
    return xo, zo, pr, pi


def same_bits(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        bits = lambda t: t.view(torch.int64) if t.is_floating_point() else t
        assert torch.equal(bits(g), bits(w))


def product_operands(rng, M1, M2, W):
    x1, z1 = (torch.from_numpy(rng.integers(-2**63, 2**63 - 1, (M1, W), endpoint=True))
              for _ in range(2))
    x2, z2 = (torch.from_numpy(rng.integers(-2**63, 2**63 - 1, (M2, W), endpoint=True))
              for _ in range(2))
    if M1 > 2:
        x1[2], z1[2] = x1[0], z1[0]  # a repeated row: products that fall together
    c = [torch.from_numpy(rng.normal(size=m)) for m in (M1, M1, M2, M2)]
    if M1:
        c[0][0], c[1][0] = 0.0, -0.0
    return x1, z1, c[0], c[1], x2, z2, c[2], c[3]


@pytest.mark.parametrize("M1,M2,W", [(9, 7, 1), (9, 7, 3), (20, 13, 16), (1, 40, 3),
                                     (40, 1, 16), (0, 5, 2), (5, 0, 2), (1, 1, 1)])
def test_pair_products_equal_the_product_planes(M1, M2, W):
    """pair_products' keys are row_signature of the product planes and its
    coefficients the product chain's, bit for bit; empty operands give
    empty outputs."""
    ops = product_operands(np.random.default_rng(M1 + 10 * M2 + W), M1, M2, W)
    ka, kb, pr, pi = torch_core.pair_products(*ops)
    xo, zo, wr, wi = reference_products(*ops)
    same_bits((ka, kb), torch_core.row_signature(xo, zo))
    same_bits((pr, pi), (wr, wi))
    assert ka.shape == (M1 * M2,)


@pytest.mark.parametrize("M1,M2,W", [(9, 7, 1), (20, 13, 16), (1, 40, 3), (40, 1, 3),
                                     (0, 5, 2), (5, 0, 2)])
@pytest.mark.parametrize("th", [1e-12, None])
def test_mul_pairs_cleanup_equals_the_parent_composition(M1, M2, W, th):
    """mul_pairs_cleanup (K4, then K3 rebuilding the survivors' rows from
    their pairs) gives the planes-then-cleanup composition's bits."""
    ops = product_operands(np.random.default_rng(M1 * M2 + W), M1, M2, W)
    same_bits(torch_core.mul_pairs_cleanup(*ops, th),
              reference_cleanup(*reference_products(*ops), th))


@pytest.mark.parametrize("T,W,uniq,long_group,th", [
    (1, 1, 1, 0, 1e-12), (1, 3, 1, 0, None), (800, 2, 100, 600, 1e-12),
    (800, 2, 100, 600, None), (3000, 16, 2500, 0, 1e-12), (2000, 1, 30, 0, None)])
def test_cleanup_equals_the_parent_composition(T, W, uniq, long_group, th):
    """cleanup_sorted and cleanup_keyed (K2, _lexsort, K3) give the parent
    composition's bits: a group of 600 rows, groups that cancel to zero,
    exact zeros kept under zero_threshold=None, T = 1, the keyed key."""
    rng = np.random.default_rng(T + uniq)
    base = rng.integers(-2**62, 2**62, (uniq, 2, W))
    idx = rng.integers(0, uniq, T)
    idx[:long_group] = 0
    x, z = torch.from_numpy(base[idx, 0]), torch.from_numpy(base[idx, 1])
    c = rng.normal(size=(2, T))
    c[:, rng.random(T) < 0.1] = 0.0
    if T > 1:  # one group of two rows, a row of its own, that cancels exactly
        row = torch.from_numpy(rng.integers(-2**62, 2**62, (2, W)))
        x[-2:], z[-2:] = row[0], row[1]
        c[:, -1] = -c[:, -2]
    cr, ci = torch.from_numpy(c[0]), torch.from_numpy(c[1])
    same_bits(torch_core.cleanup_sorted(x, z, cr, ci, th), reference_cleanup(x, z, cr, ci, th))
    keyed = torch_core.cleanup_keyed(x, z, cr, ci, th)
    same_bits(keyed, reference_cleanup(x, z, cr, ci, th, keyed=True))
    assert torch.equal(keyed[4], torch_core.row_signature(keyed[0], keyed[1])[0])


# -- the rotation's and the projection's rows: K6 (rotation_rows), K7
# (project_rows), K3 with live flags -------------------------------------------
#
# The references below are the compositions rotate_nonclifford_cleanup and
# clifford_project_cleanup had before K6 and K7 (the anticommuting rows
# gathered and multiplied, the filtered rows gathered, then a cleanup of the
# concatenated or masked planes): the new ones must give the same bits.

def reference_rotate(x, z, cr, ci, xr, zr, cos_t, sin_t, th):
    ac = torch_core.anticommutes_single(x, z, xr, zr)
    first_r = torch.where(ac, cr * cos_t, cr)
    first_i = torch.where(ac, ci * cos_t, ci)
    ia = ac.nonzero().squeeze(1)
    xm, zm, mr, mi = torch_core.mul_single(x[ia], z[ia], cr[ia], ci[ia], xr, zr)
    return reference_cleanup(torch.cat([x, xm]), torch.cat([z, zm]),
                             torch.cat([first_r, mi * sin_t]), torch.cat([first_i, -mr * sin_t]),
                             th)


def reference_project(x, z, cr, ci, rx, rz, rm, sx, sz, neg_x, neg_z, col_keep, th):
    if rx.shape[0]:
        x, z, cr, ci = torch_core.clifford_scan(x, z, cr, ci, rx, rz, rm)
    ik = (~torch_core.anticommutes(x, z, sx, sz).any(dim=1)).nonzero().squeeze(1)
    x, z, cr, ci = x[ik], z[ik], cr[ik], ci[ik]
    flip = (1 - 2 * ((torch_core.parity_and(x, neg_x[None, :])
                      + torch_core.parity_and(z, neg_z[None, :])) & 1)).to(cr.dtype)
    return reference_cleanup(x & col_keep[None, :], z & col_keep[None, :], cr * flip, ci * flip,
                             th)


def words(rng, shape):
    return torch.from_numpy(rng.integers(-2**63, 2**63 - 1, shape, endpoint=True))


def rotation_case(rng, T, W, kind):
    """(x, z, cr, ci, xr, zr) of T random terms of W words: "mixed" (about
    half anticommute with Q, a few repeated rows, a term whose P Q row is
    another input term, exact zeros and -0.0), "none" (Q the identity: no
    term anticommutes) or "all" (every term anticommutes)."""
    x, z = words(rng, (T, W)), words(rng, (T, W))
    xr, zr = words(rng, (W,)), words(rng, (W,))
    c = torch.from_numpy(rng.normal(size=(2, T)))
    if kind == "none":
        xr, zr = torch.zeros_like(xr), torch.zeros_like(zr)
    if T > 3:
        x[3], z[3] = x[1], z[1]  # a repeated term
        c[:, 2] = torch.tensor([0.0, -0.0])
    if T > 5 and kind == "mixed":  # term 5 is term 4 times Q (and so the reverse)
        x[5], z[5] = x[4] ^ xr, z[4] ^ zr
    if kind == "all":  # flip a bit of x where zr has one and xr none
        bit = int(torch.nonzero(((zr & ~xr) != 0))[0])
        word = zr[bit] & ~xr[bit]
        lowest = word & -word
        ac = torch_core.anticommutes_single(x, z, xr, zr)
        x[~ac, bit] ^= lowest
    return x, z, c[0].contiguous(), c[1].contiguous(), xr, zr


@pytest.mark.parametrize("T,W", [(1, 1), (40, 1), (37, 3), (60, 16), (0, 2)])
@pytest.mark.parametrize("kind", ["mixed", "none", "all"])
def test_rotation_rows_equal_the_rotated_planes(T, W, kind):
    """rotation_rows' keys are row_signature of the rows and their P Q twins,
    its first half's coefficients the parent's cos-scaled ones, its live
    second half the parent's mul_single chain on the gathered rows, bit for
    bit; live is [every term; the anticommuting ones]."""
    x, z, cr, ci, xr, zr = rotation_case(np.random.default_rng(T + 7 * W), T, W, kind)
    cos_t, sin_t = np.cos(0.37), np.sin(0.37)
    ka, kb, pr, pi, live = torch_core.rotation_rows(x, z, cr, ci, xr, zr, cos_t, sin_t)
    same_bits((ka, kb), torch_core.row_signature(torch.cat([x, x ^ xr]), torch.cat([z, z ^ zr])))
    ac = torch_core.anticommutes_single(x, z, xr, zr)
    same_bits((live,), (torch.cat([torch.ones_like(ac), ac]),))
    same_bits((pr[:T], pi[:T]), (torch.where(ac, cr * cos_t, cr), torch.where(ac, ci * cos_t, ci)))
    _, _, mr, mi = torch_core.mul_single(x[ac], z[ac], cr[ac], ci[ac], xr, zr)
    same_bits((pr[T:][ac], pi[T:][ac]), (mi * sin_t, -mr * sin_t))
    assert {"none": 0, "all": T}.get(kind, int(ac.sum())) == int(ac.sum())


@pytest.mark.parametrize("T,W", [(1, 1), (1, 16), (40, 1), (37, 3), (60, 16), (0, 2)])
@pytest.mark.parametrize("kind", ["mixed", "none", "all"])
@pytest.mark.parametrize("th", [1e-12, None])
def test_rotate_nonclifford_cleanup_equals_the_parent_composition(T, W, kind, th):
    """rotate_nonclifford_cleanup (K6, _lexsort, K3 with live flags and the
    rotation's row source) gives the parent composition's bits: no term or
    every term anticommuting, T = 1, a P Q row equal to an input row (a
    group across both halves), repeated rows, exact zeros and -0.0 (kept
    under zero_threshold=None)."""
    x, z, cr, ci, xr, zr = rotation_case(np.random.default_rng(T + 7 * W), T, W, kind)
    args = (x, z, cr, ci, xr, zr, np.cos(0.37), np.sin(0.37), th)
    same_bits(torch_core.rotate_nonclifford_cleanup(*args), reference_rotate(*args))


def projection_case(rng, T, W, D, S, kind):
    """The arguments of clifford_project_cleanup for T random terms of W
    words, D Clifford rotations and S single-qubit stabilizers (Z, X and Y in
    turn, on distinct qubits, the first two of eigenvalue -1).  The
    rotations leave the stabilized qubits alone, so a term's commutation
    with each stabilizer survives the scan: "mixed" has a live row and a
    dead one that differ only at a stabilized qubit (equal once masked), a
    group of three dead copies of one row, a repeated live row with
    coefficient (0.0, -0.0) (a flip makes -0.0 of 0.0); "dead" has every row
    anticommuting with the first stabilizer (a Z)."""
    x, z = words(rng, (T, W)), words(rng, (T, W))
    c = torch.from_numpy(rng.normal(size=(2, T)))
    rx, rz = words(rng, (D, W)) & words(rng, (D, W)), words(rng, (D, W)) & words(rng, (D, W))
    rm = torch.from_numpy(rng.integers(-3, 4, D))
    sx, sz = torch.zeros((S, W), dtype=torch.int64), torch.zeros((S, W), dtype=torch.int64)
    neg_x, neg_z = torch.zeros(W, dtype=torch.int64), torch.zeros(W, dtype=torch.int64)
    col_keep = torch.full((W,), -1, dtype=torch.int64)
    for s, q in enumerate(rng.choice(64 * W, S, replace=False)):
        w, bit = int(q) // 64, (1 << (int(q) % 64)) - (1 << 64 if q % 64 == 63 else 0)
        if s % 3 != 1:
            sz[s, w] = bit
        if s % 3 != 0:
            sx[s, w] = bit
        col_keep[w] &= ~bit
        if s < 2:
            neg_x[w] |= sx[s, w]
            neg_z[w] |= sz[s, w]
    rx &= col_keep
    rz &= col_keep
    if kind == "dead" and S:
        x |= sz[0]
    if kind == "mixed" and T > 8 and S:
        x[0:5] &= col_keep  # live: no stabilized bit set
        z[0:5] &= col_keep
        x[1], z[1] = x[0], z[0]
        c[:, 0] = torch.tensor([0.0, -0.0])
        x[4], z[4] = x[3] | sz[0], z[3]  # dead, and equal to row 3 once masked
        x[5] |= sz[0]
        x[6:9], z[6:9] = x[5], z[5]  # a group of dead rows only
    return (x, z, c[0].contiguous(), c[1].contiguous(), rx, rz, rm, sx, sz, neg_x, neg_z,
            col_keep)


@pytest.mark.parametrize("T,W,D,S", [(1, 1, 0, 1), (1, 3, 2, 3), (50, 1, 0, 3), (45, 3, 4, 4),
                                     (60, 16, 4, 4), (40, 2, 0, 0), (0, 2, 3, 2)])
@pytest.mark.parametrize("kind", ["mixed", "dead"])
def test_project_rows_equal_the_masked_planes(T, W, D, S, kind):
    """project_rows' keys are row_signature of the masked rows, its live
    flags the stabilizer filter and its live coefficients the parent's flip
    chain on the filtered rows, bit for bit."""
    args = projection_case(np.random.default_rng(T + 5 * W + S), T, W, D, S, kind)
    x, z, cr, ci, rx, rz, rm, sx, sz, neg_x, neg_z, col_keep = args
    if D:
        x, z, cr, ci = torch_core.clifford_scan(x, z, cr, ci, rx, rz, rm)
    ac = torch_core.anticommutes(x, z, sx, sz)
    ka, kb, pr, pi, live = torch_core.project_rows(x, z, cr, ci, ac, neg_x, neg_z, col_keep)
    same_bits((ka, kb), torch_core.row_signature(x & col_keep, z & col_keep))
    same_bits((live,), (~ac.any(dim=1),))
    flip = (1 - 2 * ((torch_core.parity_and(x[live], neg_x[None, :])
                      + torch_core.parity_and(z[live], neg_z[None, :])) & 1)).to(cr.dtype)
    same_bits((pr[live], pi[live]), (cr[live] * flip, ci[live] * flip))
    if kind == "dead" and S:
        assert not live.any()


@pytest.mark.parametrize("T,W,D,S", [(1, 1, 0, 1), (1, 3, 2, 3), (50, 1, 0, 3), (45, 3, 4, 4),
                                     (60, 16, 4, 4), (40, 2, 0, 0), (0, 2, 3, 2)])
@pytest.mark.parametrize("kind", ["mixed", "dead"])
@pytest.mark.parametrize("th", [1e-12, None])
def test_clifford_project_cleanup_equals_the_parent_composition(T, W, D, S, kind, th):
    """clifford_project_cleanup (K5, K1, K7, _lexsort, K3 with live flags and
    the masked row source) gives the parent composition's bits: dead rows
    whose masked row equals a live one, groups of dead rows only, every row
    dead, no stabilizer, no rotation, T = 1, exact zeros and -0.0."""
    args = projection_case(np.random.default_rng(T + 5 * W + S), T, W, D, S, kind)
    same_bits(torch_core.clifford_project_cleanup(*args, th), reference_project(*args, th))


# -- K17's sort by ka alone, and the repair where two signatures share ka ----

def forge_signatures(monkeypatch, kind, seen):
    """cuda.row_signature, which every composite's plain route reaches, with
    its first key forged so that signatures share it: "all", ka's top four
    bits only (16 values among all the rows); "one", the ka of row 5's
    signature set to row 0's.  `seen` gets, per call, whether some forged ka now holds two kb (a
    split run for the sort by ka alone)."""
    real = cuda.row_signature

    def forged(x, z):
        ka, kb = real(x, z)
        if kind == "all":
            ka = (ka >> 60) << 60
        elif ka.shape[0] > 5:  # every row of row 5's signature
            ka = torch.where((ka == ka[5]) & (kb == kb[5]), ka[0], ka)
        pairs = torch.unique(torch.stack([ka, kb]), dim=1)
        seen.append(torch.unique(pairs[0]).numel() < pairs.shape[1])
        return ka, kb

    monkeypatch.setattr(cuda, "row_signature", forged)


def composite_case(which, th):
    """(composite, its arguments, the parent composition's output)."""
    rng = np.random.default_rng(len(which))
    if which == "cleanup":
        base = rng.integers(-2**62, 2**62, (100, 2, 2))
        idx = rng.integers(0, 100, 800)
        idx[:300] = 0
        x, z = torch.from_numpy(base[idx, 0]), torch.from_numpy(base[idx, 1])
        c = torch.from_numpy(rng.normal(size=(2, 800)))
        args = (x, z, c[0].contiguous(), c[1].contiguous(), th)
        return torch_core.cleanup_sorted, args, reference_cleanup(*args)
    if which == "product":
        ops = product_operands(rng, 20, 13, 3)
        return (torch_core.mul_pairs_cleanup, (*ops, th),
                reference_cleanup(*reference_products(*ops), th))
    if which == "rotation":
        args = (*rotation_case(rng, 60, 3, "mixed"), np.cos(0.37), np.sin(0.37), th)
        return torch_core.rotate_nonclifford_cleanup, args, reference_rotate(*args)
    args = (*projection_case(rng, 45, 3, 4, 4, "mixed"), th)
    return torch_core.clifford_project_cleanup, args, reference_project(*args)


@pytest.mark.parametrize("which", ["cleanup", "product", "rotation", "projection"])
@pytest.mark.parametrize("kind", ["all", "one"])
@pytest.mark.parametrize("th", [1e-12, None])
def test_composites_repair_a_forged_collision(monkeypatch, which, kind, th):
    """Each composite on the large route (cuda.SMALL_ROWS set to 0) with
    signatures that share their first key (forged): K3's check finds the
    split run of the sort by ka alone, the repair sorts by (ka, kb)
    (lexsort_keys) and merges again, and the output is the parent's
    _lexsort composition's bit for bit; cuda.sort_repairs counts the repair
    exactly where a forged ka holds two signatures."""
    fn, args, want = composite_case(which, th)
    monkeypatch.setattr(cuda, "SMALL_ROWS", 0)
    seen = []
    forge_signatures(monkeypatch, kind, seen)
    before = cuda.sort_repairs
    same_bits(fn(*args), want)
    assert len(seen) == 1 and cuda.sort_repairs - before == int(seen[0])
    assert seen[0] or kind == "one"


@pytest.mark.parametrize("which", ["cleanup", "product", "rotation", "projection"])
@pytest.mark.parametrize("kind", ["all", "one"])
@pytest.mark.parametrize("th", [1e-12, None])
def test_composites_one_block_route_with_a_forged_collision(monkeypatch, which, kind, th):
    """The twin of test_composites_repair_a_forged_collision on K3's
    one-block route (every composite here is under cuda.SMALL_ROWS; the
    fused route, whose kernel signs the slots itself and so takes no forged
    key, off: cuda.FUSED_WORDS set to -1): with forged first keys the
    output is still the parent's _lexsort composition's bit for bit,
    through one merge_small call, with no sort by ka, no split check and no
    repair."""
    fn, args, want = composite_case(which, th)
    monkeypatch.setattr(cuda, "FUSED_WORDS", -1)
    seen, small = [], []
    forge_signatures(monkeypatch, kind, seen)
    real = cuda.merge_small
    monkeypatch.setattr(cuda, "merge_small", lambda *a: small.append(a) or real(*a))
    monkeypatch.setattr(cuda, "sort_keys", lambda k: pytest.fail("sorted by ka"))
    monkeypatch.setattr(cuda, "merge_groups", lambda *a: pytest.fail("the large route"))
    before = cuda.sort_repairs
    same_bits(fn(*args), want)
    assert len(seen) == 1 and len(small) == 1 and cuda.sort_repairs == before
    assert seen[0] or kind == "one"


@pytest.mark.parametrize("T", [1, 2, 4095, 4096, 4097])
def test_merge_sorted_routes_by_size(monkeypatch, T):
    """_merge_sorted sends T <= cuda.SMALL_ROWS slots to merge_small (one
    call, no sort_keys, no merge_groups) and 4,097 to K17 and K3's two
    passes; both routes give the parent composition's bits."""
    rng = np.random.default_rng(T)
    x = torch.from_numpy(rng.integers(-2**62, 2**62, (T, 2)) % 37)
    ka, kb = torch_core.row_signature(x, x)
    c = torch.from_numpy(rng.normal(size=(2, T)))
    want = torch_core.merge_groups(torch_core._lexsort(ka, kb), ka[torch_core._lexsort(ka, kb)],
                                   ka, kb, c[0], c[1], 1e-12, (x, x), None, False)
    seen = {"merge_small": 0, "sort_keys": 0, "merge_groups": 0}
    for name in seen:
        real = getattr(cuda, name)

        def counted(*a, name=name, real=real):
            seen[name] += 1
            return real(*a)

        monkeypatch.setattr(cuda, name, counted)
    same_bits(torch_core._merge_sorted(ka, kb, c[0], c[1], 1e-12, (x, x)), want)
    small = T <= cuda.SMALL_ROWS
    assert seen == {"merge_small": int(small), "sort_keys": int(not small),
                    "merge_groups": int(not small)}
    assert cuda.SMALL_ROWS == 4096


def test_cleanup_sorts_once_without_a_collision(monkeypatch):
    """Without a collision a cleanup on the large route (cuda.SMALL_ROWS set
    to 0) sorts once, by ka (sort_keys), and never by (ka, kb)."""
    monkeypatch.setattr(cuda, "SMALL_ROWS", 0)
    calls = []
    real = cuda.sort_keys
    monkeypatch.setattr(cuda, "sort_keys", lambda k: calls.append(k) or real(k))
    monkeypatch.setattr(torch_core, "lexsort_keys", lambda *a: pytest.fail("repaired"))
    _, args, want = composite_case("cleanup", 1e-12)
    same_bits(torch_core.cleanup_sorted(*args), want)
    assert len(calls) == 1


def test_cleanup_one_block_route_sorts_in_the_kernel(monkeypatch):
    """The twin of test_cleanup_sorts_once_without_a_collision on K3's
    one-block route after K2 (the fused route off: cuda.FUSED_WORDS set to
    -1): the cleanup makes one merge_small call, which sorts by itself, and
    never calls sort_keys or the repair's lexsort_keys."""
    monkeypatch.setattr(cuda, "FUSED_WORDS", -1)
    small = []
    real = cuda.merge_small
    monkeypatch.setattr(cuda, "merge_small", lambda *a: small.append(a) or real(*a))
    monkeypatch.setattr(cuda, "sort_keys", lambda k: pytest.fail("sorted by ka"))
    monkeypatch.setattr(torch_core, "lexsort_keys", lambda *a: pytest.fail("repaired"))
    _, args, want = composite_case("cleanup", 1e-12)
    same_bits(torch_core.cleanup_sorted(*args), want)
    assert len(small) == 1


# -- the fused route: a small cleanup or product signed inside K3's one block
#
# cuda.cleanup_small and cuda.product_small sign their slots inside
# csrc/merge_small.cu; their plain versions are the compositions the route
# replaced (row_signature or pair_products, then merge_small), so they must
# give the parent composition's bits and symmer_tpu's terms.

def fused_case(kind, dims, rng):
    """(host arguments, torch arguments) of a fused-route case: a cleanup
    of T rows of W words drawn from T / 3 (kind "cleanup"), one group of all
    T rows ("one_group"), or a product of M1 x M2 pairs of W words
    ("product"; "cancel": operand 1's second half its first half with the
    coefficients negated, so half the groups of pairs sum to exactly 0)."""
    if kind in ("cleanup", "one_group"):
        T, W = dims
        base = rng.integers(0, 2**63, (max(1, T // 3), 2, W), dtype=np.uint64)
        rows = base[rng.integers(0, base.shape[0], T) if kind == "cleanup" else np.zeros(T, int)]
        x, z = np.ascontiguousarray(rows[:, 0]), np.ascontiguousarray(rows[:, 1])
        c = coeffs(rng, T)
        c[rng.random(T) < 0.1] = 0.0
        return (x, z, c), (tt(x), tt(z), tt(c.real), tt(c.imag))
    M1, M2, W = dims
    x1, z1 = (rng.integers(0, 2**63, (M1, W), dtype=np.uint64) for _ in range(2))
    x2, z2 = (rng.integers(0, 2**63, (M2, W), dtype=np.uint64) for _ in range(2))
    c1, c2 = coeffs(rng, M1), coeffs(rng, M2)
    if kind == "cancel":
        h = M1 // 2
        x1[h:2 * h], z1[h:2 * h], c1[h:2 * h] = x1[:h], z1[:h], -c1[:h]
    ops = (x1, z1, c1, x2, z2, c2)
    return ops, (tt(x1), tt(z1), tt(c1.real), tt(c1.imag), tt(x2), tt(z2), tt(c2.real),
                 tt(c2.imag))


# symmer_tpu's functions compiled whole (jax.jit: ~1 s a shape, where their
# op-by-op eager dispatch takes ~5-9 s)
_jx_cleanup = jax.jit(jx_core.cleanup_sorted)
_jx_mul_pairs_cleanup = jax.jit(jx_core.mul_pairs_cleanup)
FUSED_CASES = [("product", (1, 1, 1), None), ("product", (67, 1, 1), 0.0),
               ("product", (67, 1, 2), 0.5), ("product", (0, 3, 1), None),
               ("cancel", (12, 12, 16), 0.5), ("cancel", (40, 3, 2), 0.0),
               ("cleanup", (2229, 1), None), ("cleanup", (300, 2), 0.0),
               ("cleanup", (256, 16), 0.5), ("one_group", (200, 2), None)]


@pytest.mark.parametrize("kind,dims,th", FUSED_CASES)
def test_fused_route_equals_the_parent_composition_and_jax(kind, dims, th):
    """cleanup_small and product_small (the plain versions of the fused
    route, and the cuda wrappers on CPU tensors) bit for bit the parent's
    composition (the signatures or the product planes, the stable sorts,
    segment_reduce, first-occurrence order) with its ka, and
    cleanup_sorted / cleanup_keyed / mul_pairs_cleanup through the route;
    term sets equal to symmer_tpu's jx_core.cleanup_sorted or
    mul_pairs_cleanup and coefficients within 1e-12 relative: 1 x 1 and 67
    x 1 products, an empty operand, pairs that cancel, a 2,229 x 1-word
    cleanup, one group, W = 1, 2 and 16, zero_threshold None, 0.0 and 0.5."""
    rng = np.random.default_rng(sum(dims) + len(kind))
    host, args = fused_case(kind, dims, rng)
    if kind in ("cleanup", "one_group"):
        assert cuda.small_fused(*args[0].shape)
        want = reference_cleanup(*args, th, keyed=True)
        same_bits(torch_core.cleanup_small(*args, th), want)
        same_bits(cuda.cleanup_small(*args, th), want)
        same_bits(torch_core.cleanup_keyed(*args, th), want)
        same_bits(torch_core.cleanup_sorted(*args, th), want[:4])
        x, z, c = host
        jax_terms = from_jax(*_jx_cleanup(jj(x), jj(z), jnp.asarray(c.real), jnp.asarray(c.imag),
                                          x.shape[0], None if th is None else jnp.asarray(th)))
    else:
        assert cuda.small_fused(dims[0] * dims[1], dims[2])
        want = reference_cleanup(*reference_products(*args), th, keyed=True)
        same_bits(torch_core.product_small(*args, th), want)
        same_bits(cuda.product_small(*args, th), want)
        same_bits(torch_core.mul_pairs_cleanup(*args, th), want[:4])
        x1, z1, c1, x2, z2, c2 = host
        jax_terms = from_jax(*_jx_mul_pairs_cleanup(
            jj(x1), jj(z1), jnp.asarray(c1.real), jnp.asarray(c1.imag), jj(x2), jj(z2),
            jnp.asarray(c2.real), jnp.asarray(c2.imag), None if th is None else jnp.asarray(th)))
    assert_same_terms(from_torch(*want[:4]), jax_terms)
    assert torch.equal(want[4], torch_core.row_signature(want[0], want[1])[0])
    if kind == "one_group":
        assert want[0].shape[0] == 1
    if kind == "cancel":
        assert want[0].shape[0] < dims[0] * dims[1] // 2 + dims[1]


def test_fused_route_rule_at_its_edges():
    """cuda.small_fused, a pure size rule: at most cuda.SMALL_ROWS slots and
    cuda.FUSED_WORDS slot-words (merge_small.cu's kMaxSlots and
    kFusedWords), on both sides of each edge; the CS-VQE flows' products
    and tapered N2's cleanup within it."""
    rows, words = cuda.SMALL_ROWS, cuda.FUSED_WORDS
    assert rows == 4096 and words >= 2229
    for T, W, fused in ((rows, 0, True), (rows + 1, 0, False), (1, words, True),
                        (1, words + 1, False), (rows, words // rows, True),
                        (rows, words // rows + 1, False), (0, 5, True), (67, 1, True),
                        (2229, 1, True)):
        assert cuda.small_fused(T, W) == fused, (T, W)


@pytest.mark.parametrize("which", ["cleanup", "product"])
@pytest.mark.parametrize("fused", [True, False])
def test_composites_route_by_the_fused_rule(monkeypatch, which, fused):
    """A cleanup or product within cuda.small_fused makes one call of its
    fused wrapper (cleanup_small, product_small) and none of row_signature,
    pair_products or merge_small; with the rule refusing it (cuda.FUSED_WORDS
    set to -1) K2 or K4 and merge_small run, as before the route; both the
    parent composition's bits."""
    fn, args, want = composite_case(which, 1e-12)
    if not fused:
        monkeypatch.setattr(cuda, "FUSED_WORDS", -1)
    key = "row_signature" if which == "cleanup" else "pair_products"
    # (the plain pair_products takes its keys from cuda.row_signature)
    seen = dict.fromkeys(("cleanup_small", "product_small", key, "merge_small"), 0)
    for name in seen:
        real = getattr(cuda, name)

        def counted(*a, name=name, real=real):
            seen[name] += 1
            return real(*a)

        monkeypatch.setattr(cuda, name, counted)
    same_bits(fn(*args), want)
    want_calls = dict.fromkeys(seen, 0)
    want_calls.update({f"{which}_small": 1} if fused else {key: 1, "merge_small": 1})
    assert seen == want_calls
