"""The hand-written CUDA kernels against their plain torch versions.

These tests need a CUDA card and skip without one.  tests/conftest.py
configures JAX, which the machine with the card need not have, so run them
from the repository root with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

anticommutes must equal its plain version exactly and clifford_scan bit for
bit, at ragged shapes, word edges, both anticommutes regimes (tall-skinny,
binary tensor-core product) and both clifford_scan variants (rows in
registers up to 16 words, streamed beyond).  expval agrees with its plain
version within 1e-12 relative (another summation order) on both routes
(probes per X group and row, per row pair), with the state table staged in
shared memory and read from L2, and with rows that share their low hash
bits; brute_force_minimise gives the same index and the energy within
1e-12 relative (a near-tie: any index whose energy reaches the minimum)
with n_free below, at and above the split width, small and empty
segments.  Both give bit-identical results on a second launch.
group_matvec (recomputing the diagonals from the terms) agrees with its
plain version (the table built, then read) within 1e-14 of the sum of
|ph_t| |V| over a row's terms (another order of the same sums) at every
column width (one launch for 1, 2, 4, 8; column chunks beyond), with one
group, a one-term group, a group whose X pattern is 0, fewer rows than a
block's tile and odd group counts, and is bit-identical on a second launch;
lanczos_step and lanczos_replay equal their plain versions bit for bit
(the pairwise sums over one and many chunks, a breakdown with beta = 0),
and the scalar driver on the card launches only those kernels and the
matvec; build_group_diagonals equals its plain
version and the host's dense.group_diagonals bit for bit on both sides of
the split between the shared-memory pass and the strided passes (n = 11,
12, 13, 15, and 21: three passes).  The evolution slice: vqe_rotate and
pauli_overlaps equal their plain versions bit for bit (one row pair, one
chunk, many chunks; N = 1, a batch, an empty batch) and on a second launch;
gf2_rref equals its plain version and the host's gf2core.rref_inplace bit
for bit (one row, all-zero and full-rank stacks, words past one lane per
word, zero runs longer than a window); the VQE engine on the card equals
the CPU device within 1e-12 and launches only its three kernels; a forked
child cannot use the parent's CUDA context, and process 'mp' refuses to
fork one.
"""
import numpy as np
import pytest
import torch

from symmer_torch.kernels import cuda, dense, pack, torch_core, torch_lanczos, torch_noncon
from symmer_torch.kernels import torch_state

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def planes(rng, rows, n_qubits, dev, density=0.5):
    p = pack.pack_bits(rng.random((rows, n_qubits)) < density, n_qubits)
    return torch.tensor(p.view(np.int64), device=dev)


@pytest.mark.parametrize("n_qubits", [1, 63, 64, 65, 130, 1000, 1100])
@pytest.mark.parametrize("m1,m2", [(1, 1), (300, 70), (257, 8), (129, 9), (5000, 3)])
def test_anticommutes_equals_plain(dev, n_qubits, m1, m2):
    rng = np.random.default_rng(m1 * 7 + m2 + n_qubits)
    x1, z1 = planes(rng, m1, n_qubits, dev), planes(rng, m1, n_qubits, dev)
    x2, z2 = planes(rng, m2, n_qubits, dev), planes(rng, m2, n_qubits, dev)
    before = cuda.launches["anticommutes"]
    got = cuda.anticommutes(x1, z1, x2, z2)
    torch.cuda.synchronize()
    assert cuda.launches["anticommutes"] == before + 1
    assert got.dtype == torch.bool and got.shape == (m1, m2)
    assert torch.equal(got, torch_core.anticommutes(x1, z1, x2, z2))


@pytest.mark.parametrize("n_qubits", [1, 64, 130, 500, 1000, 1100, 2000])
@pytest.mark.parametrize("depth", [1, 33, 70])
def test_clifford_scan_bitwise(dev, n_qubits, depth):
    rng = np.random.default_rng(n_qubits + depth)
    T = 1000
    x, z = planes(rng, T, n_qubits, dev), planes(rng, T, n_qubits, dev)
    c = rng.normal(size=(2, T))
    c[:, :4] = [[0.0, -0.0, 0.0, -0.0], [-0.0, 0.0, 1.0, -1.0]]
    cr, ci = torch.tensor(c[0], device=dev), torch.tensor(c[1], device=dev)
    rx, rz = planes(rng, depth, n_qubits, dev, 0.1), planes(rng, depth, n_qubits, dev, 0.1)
    rm = torch.tensor(rng.integers(-6, 7, depth), device=dev)
    got = cuda.clifford_scan(x, z, cr, ci, rx, rz, rm)
    want = torch_core.clifford_scan(x, z, cr, ci, rx, rz, rm)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2].view(torch.int64), want[2].view(torch.int64))
    assert torch.equal(got[3].view(torch.int64), want[3].view(torch.int64))


# the regime edges of csrc/anticommutes.cu: M2 <= 16 and W <= 64 words (with
# aligned op1 planes) run the tall-skinny kernel, anything else the binary
# tensor-core product (4-word k-steps, 128 x 128 tiles); W = 18 is not a
# multiple of a k-step.  Tall tiles: odd W ends the last tile on an odd word
# (1001 x 3 words: 41 rows; 1025 x 1 word: a last tile of one word), and
# 200,000 x 16 words gives each persistent block several rounds of the ring.
@pytest.mark.parametrize("m1,m2,n_qubits", [
    (1000, 15, 1000), (1000, 16, 1000), (1000, 17, 1000), (4095, 4097, 1000),
    (129, 257, 1100), (2000, 3, 64), (50, 40, 64), (777, 16, 192 * 64),
    (300, 16, 192 * 64 + 1), (33, 5, 1100), (3000, 1, 130),
    (777, 16, 64 * 64), (300, 16, 64 * 64 + 1), (4099, 1, 63 * 64), (3001, 9, 33 * 64 - 5),
    (1001, 4, 130), (1025, 3, 64), (200_000, 4, 1000),
])
def test_anticommutes_regime_edges(dev, m1, m2, n_qubits):
    rng = np.random.default_rng(m1 + 3 * m2 + n_qubits)
    x1, z1 = planes(rng, m1, n_qubits, dev), planes(rng, m1, n_qubits, dev)
    x2, z2 = planes(rng, m2, n_qubits, dev), planes(rng, m2, n_qubits, dev)
    got = cuda.anticommutes(x1, z1, x2, z2)
    torch.cuda.synchronize()
    assert torch.equal(got, torch_core.anticommutes(x1, z1, x2, z2))


@pytest.mark.parametrize("n_qubits", [64, 1000, 1100])
@pytest.mark.parametrize("m2", [4, 17])
def test_anticommutes_all_ones_and_single_bits(dev, n_qubits, m2):
    """Rows of all ones (the largest popcounts) and of single bits."""
    rng = np.random.default_rng(n_qubits + m2)
    m1 = 200
    bits = rng.random((2, m1, n_qubits)) < 0.5
    bits[:, :50] = True
    q = rng.integers(0, n_qubits, 100)
    bits[:, 50:150] = False
    bits[0, np.arange(50, 150), q] = True
    bits[1, np.arange(50, 100), q[:50]] = True
    x1, z1 = (torch.tensor(pack.pack_bits(b, n_qubits).view(np.int64), device=dev) for b in bits)
    x2, z2 = x1[:m2].clone(), z1[40:40 + m2].clone()
    got = cuda.anticommutes(x1, z1, x2, z2)
    torch.cuda.synchronize()
    assert torch.equal(got, torch_core.anticommutes(x1, z1, x2, z2))


def test_anticommutes_unaligned_planes(dev):
    """op1 planes 8 bytes off a 16-byte boundary, which the tall kernel's bulk
    copies cannot take, go to the tensor-core product (8-byte copies)."""
    rng = np.random.default_rng(2)
    m1, W = 1001, 16
    x2, z2 = planes(rng, 4, 1000, dev), planes(rng, 4, 1000, dev)
    flat = planes(rng, 2 * m1 * W + 1, 64, dev).view(-1)
    x1 = flat[1 : 1 + m1 * W].view(m1, W)
    z1 = flat[1 + m1 * W : 1 + 2 * m1 * W].view(m1, W)
    assert x1.data_ptr() % 16 == 8 and x1.is_contiguous()
    got = cuda.anticommutes(x1, z1, x2, z2)
    torch.cuda.synchronize()
    assert torch.equal(got, torch_core.anticommutes(x1, z1, x2, z2))


# the edges of csrc/clifford_scan.cu's tiles: 128 terms per block (T = 300 is
# ragged), rows of 1 / 15 / 16 words in registers and 17 streamed, rotations
# staged 16 at a time
@pytest.mark.parametrize("n_qubits", [64, 960, 1024, 1088])
@pytest.mark.parametrize("depth", [1, 4, 31, 32, 33, 70])
def test_clifford_scan_tile_edges(dev, n_qubits, depth):
    rng = np.random.default_rng(10 * n_qubits + depth)
    T = 300
    x, z = planes(rng, T, n_qubits, dev), planes(rng, T, n_qubits, dev)
    c = rng.normal(size=(2, T))
    c[:, :6] = [[0.0, -0.0, 0.0, -0.0, 2.0, -0.0], [-0.0, 0.0, 1.0, -1.0, -0.0, -0.0]]
    cr, ci = torch.tensor(c[0], device=dev), torch.tensor(c[1], device=dev)
    rx, rz = planes(rng, depth, n_qubits, dev, 0.1), planes(rng, depth, n_qubits, dev, 0.1)
    m = rng.integers(-7, 8, depth)
    m[0] = -1  # negative multiples and m = 0 (a no-op) mid-run
    if depth > 2:
        m[depth // 2], m[-1] = 0, -3
    got = cuda.clifford_scan(x, z, cr, ci, rx, rz, torch.tensor(m, device=dev))
    want = torch_core.clifford_scan(x, z, cr, ci, rx, rz, torch.tensor(m, device=dev))
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2].view(torch.int64), want[2].view(torch.int64))
    assert torch.equal(got[3].view(torch.int64), want[3].view(torch.int64))


def test_empty_inputs_launch_nothing(dev):
    rng = np.random.default_rng(0)
    x = planes(rng, 5, 70, dev)
    e = x[:0]
    cuda.reset_launches()
    assert cuda.anticommutes(x, x, e, e).shape == (5, 0)
    r = torch.zeros(5, dtype=torch.float64, device=dev)
    out = cuda.clifford_scan(x, x, r, r, e, e, torch.zeros(0, dtype=torch.int64, device=dev))
    assert torch.equal(out[0], x)
    assert all(n == 0 for n in cuda.launches.values())


def test_wrappers_reject_bad_operands(dev):
    rng = np.random.default_rng(1)
    x = planes(rng, 6, 130, dev)
    with pytest.raises(TypeError, match="dtype"):
        cuda.anticommutes(x.to(torch.int32), x, x, x)
    with pytest.raises(ValueError, match="contiguous"):
        cuda.anticommutes(x.t().contiguous().t(), x, x, x)
    with pytest.raises(ValueError, match="disagree"):
        cuda.anticommutes(x, x, x[:, :1].contiguous(), x[:, :1].contiguous())
    with pytest.raises(ValueError, match="expected"):
        cuda.anticommutes(x, x.cpu(), x, x)


def state(rng, rows, n_qubits, dev):
    """A deduplicated random state (rows, re, im) on dev."""
    s = planes(rng, rows, n_qubits, dev)
    a = torch.tensor(rng.normal(size=(2, rows)), device=dev)
    return torch_state.cleanup_state(s, a[0].contiguous(), a[1].contiguous())


# route "groups" where U B <= B (B + 1) / 2, "pairs" otherwise (B = 1, few
# rows against many X parts); the groups route stages its table, hashes and
# amplitudes in shared memory up to 160 KB (B * 20 + 8 * capacity bytes,
# capacity >= 4 max(B, T)): 1,024 rows against 200 terms are staged, 4,099
# and 30,000 rows are not
@pytest.mark.parametrize("T,B,n_qubits", [
    (1, 1, 1), (3, 1, 64), (1, 5, 20), (777, 100, 20), (50, 777, 1000), (200, 1024, 1000),
    (37, 30_000, 20), (2239, 4099, 64), (5, 3, 1100),
])
def test_expval_equals_plain(dev, T, B, n_qubits):
    rng = np.random.default_rng(T + B + n_qubits)
    x, z = planes(rng, T, n_qubits, dev, 0.3), planes(rng, T, n_qubits, dev, 0.3)
    x[: max(1, T // 3)] = 0  # I/Z-only terms: every target matches
    c = torch.tensor(rng.normal(size=(2, T)), device=dev)
    s, ar, ai = state(rng, B, n_qubits, dev)
    if B > 1:  # half the rows one term's X from the other half
        h = s.shape[0] // 2
        s[h:2 * h] = s[:h] ^ x[T - 1]
        s, ar, ai = torch_state.cleanup_state(s, ar, ai)
    before = cuda.launches["expval"]
    got = cuda.expval(x, z, c[0].contiguous(), c[1].contiguous(), s, ar, ai)
    again = cuda.expval(x, z, c[0].contiguous(), c[1].contiguous(), s, ar, ai)
    want = torch_state.expval(x, z, c[0].contiguous(), c[1].contiguous(), s, ar, ai)
    torch.cuda.synchronize()
    assert cuda.launches["expval"] == before + 2
    assert torch.equal(torch.stack(got), torch.stack(again))  # deterministic
    g = complex(float(got[0]), float(got[1]))
    w = complex(float(want[0]), float(want[1]))
    assert abs(g - w) <= 1e-12 * max(abs(w), 1e-300), (g, w)
    assert w != 0


def assert_expval_close(dev, x, z, c, s, ar, ai):
    got = cuda.expval(x, z, c[0].contiguous(), c[1].contiguous(), s, ar, ai)
    want = torch_state.expval(x, z, c[0].contiguous(), c[1].contiguous(), s, ar, ai)
    torch.cuda.synchronize()
    g = complex(float(got[0]), float(got[1]))
    w = complex(float(want[0]), float(want[1]))
    assert w != 0 and abs(g - w) <= 1e-12 * abs(w), (g, w)


@pytest.mark.parametrize("route,T,B", [("groups", 6, 64), ("pairs", 400, 24), ("pairs", 50, 1)])
def test_expval_rows_sharing_low_hash_bits(dev, route, T, B):
    """State rows whose hashes agree in their low 8 bits all start at one
    slot of the groups route's table (128 slots for 64 rows): long probe
    chains; on the pairs route every probe (the XOR of two such rows) has
    its low 8 bits clear."""
    rng = np.random.default_rng(B + T)
    n = 20
    pool = planes(rng, 1 << 16, n, dev)
    h = torch_state.linear_hash(pool, torch_state.hash_columns(1)) & 0xFF
    common = torch.bincount(h.long(), minlength=256).argmax()
    s = pool[h == common][:B].contiguous()
    assert s.shape[0] == B
    x = planes(rng, T, n, dev, 0.3)
    x[:2] = 0
    x[2:2 + min(B - 1, T - 2)] = s[1:1 + min(B - 1, T - 2)] ^ s[0]  # X parts that link rows
    z = planes(rng, T, n, dev, 0.3)
    c = torch.tensor(rng.normal(size=(2, T)), device=dev)
    a = torch.tensor(rng.normal(size=(2, B)), device=dev)
    s, ar, ai = torch_state.cleanup_state(s, a[0].contiguous(), a[1].contiguous())
    U = torch.unique(x, dim=0).shape[0]
    assert torch_state.expval_route(U, s.shape[0]) == route
    assert_expval_close(dev, x, z, c, s, ar, ai)


@pytest.mark.parametrize("T,B,n_qubits", [(3000, 2, 1000), (20, 9000, 30), (2000, 60, 130)])
def test_expval_both_routes_at_size(dev, T, B, n_qubits):
    """Many X parts against few rows (pairs), few against many (groups, not
    staged), and a state spanned by X parts so that many row pairs match."""
    rng = np.random.default_rng(T * B)
    x = planes(rng, T, n_qubits, dev, 0.3)
    x[: T // 10] = 0
    z = planes(rng, T, n_qubits, dev, 0.3)
    c = torch.tensor(rng.normal(size=(2, T)), device=dev)
    s = planes(rng, 1, n_qubits, dev).repeat(B, 1)
    for j in range(min(12, T - T // 10)):
        s[(torch.arange(B, device=dev) >> (j % 13)) & 1 == 1] ^= x[T // 10 + j]
    a = torch.tensor(rng.normal(size=(2, B)), device=dev)
    s, ar, ai = torch_state.cleanup_state(s, a[0].contiguous(), a[1].contiguous())
    assert_expval_close(dev, x, z, c, s, ar, ai)


def search(rng, M, n_free, n_cliques, dev):
    F = rng.integers(0, 2, (M, n_free))
    clique = rng.integers(-1, n_cliques, M) if n_cliques else np.full(M, -1)
    mCi = np.array([(clique == i) for i in range(n_cliques)], float).reshape(-1, M)
    return torch_noncon.kernel_inputs(
        F, rng.integers(0, 2, M), rng.normal(size=M), (clique < 0).astype(float), mCi, dev
    )


# the split width n_lo = min(n_free, 11): n_lo = n_free up to 11 (1, 5, 8,
# 9-11), 11 above; segments of at most n_lo / 4 terms are summed directly
# (7 terms in 3 segments); n_cliques = 0: every term in S0; the terms'
# counting sort over more than one 32-term pass of its warp (300 and more)
@pytest.mark.parametrize("M,n_free,n_cliques", [
    (1, 1, 0), (7, 1, 2), (300, 10, 3), (1025, 12, 0), (2048, 16, 3), (5000, 9, 2),
    (9000, 11, 4), (100, 20, 1), (40, 5, 2), (7, 8, 2), (3000, 19, 3), (4096, 22, 3),
    (600, 17, 6),
])
def test_brute_force_equals_plain(dev, M, n_free, n_cliques):
    rng = np.random.default_rng(M + n_free)
    g, b, off, nc = search(rng, M, n_free, n_cliques, dev)
    before = cuda.launches["brute_force_minimise"]
    e, k = cuda.brute_force_minimise(g, b, off, n_free, nc)
    e_again, k_again = cuda.brute_force_minimise(g, b, off, n_free, nc)
    e2, k2 = torch_noncon.brute_force_plain(g, b, off, n_free, nc)
    torch.cuda.synchronize()
    assert cuda.launches["brute_force_minimise"] == before + 2
    assert torch.equal(e.view(torch.int64), e_again.view(torch.int64))  # deterministic
    assert int(k) == int(k_again)
    e, k, e2, k2 = float(e), int(k), float(e2), int(k2)
    tol = 1e-12 * max(1.0, abs(e2))
    assert abs(e - e2) <= tol
    if k != k2:  # only a near-tie may pick another index
        assert abs(energy_at(g, b, off, n_free, k) - e2) <= tol


def energy_at(g, b, off, n_free, k):
    """E of one assignment index, from the definition (float64 torch)."""
    kk = ((~k) & ((1 << n_free) - 1)) | (1 << 31)
    signed = (1 - 2 * torch_core.parity64(g & kk)).to(torch.float64) * b
    bounds = off.tolist()
    sums = [float(signed[bounds[i]:bounds[i + 1]].sum()) for i in range(len(bounds) - 1)]
    return sums[0] - float(np.sqrt(sum(v * v for v in sums[1:])))


def test_brute_force_31_free_generators(dev):
    """n_free = 31 (2^31 assignments), terms with one generator each: the
    minimum sets every term negative, at the index whose bit is set exactly
    where the term's fixed parity is 1 (a unique minimum, known in closed
    form)."""
    rng = np.random.default_rng(31)
    M = 31
    F = np.eye(M, dtype=np.int64)  # term m: generator m (bit 30 - m)
    fixed = rng.integers(0, 2, M)
    base = rng.uniform(0.5, 1.5, M)
    g, b, off, nc = torch_noncon.kernel_inputs(F, fixed, base, np.ones(M), np.zeros((0, M)), dev)
    e, k = cuda.brute_force_minimise(g, b, off, 31, nc)
    torch.cuda.synchronize()
    want_k = int(sum(int(f) << (30 - m) for m, f in enumerate(fixed)))
    assert int(k) == want_k
    assert abs(float(e) + base.sum()) <= 1e-12 * base.sum()


@pytest.mark.parametrize("n_free", [6, 13, 21])
def test_brute_force_empty_segment_and_all_equal_energies(dev, n_free):
    """A clique with no terms sums to 0; with no term carrying a free
    generator every assignment has the same energy, and index 0 wins."""
    rng = np.random.default_rng(n_free)
    M = 50
    clique = rng.integers(-1, 3, M)
    clique[clique == 1] = 2  # clique 1 is empty
    mCi = np.array([(clique == i) for i in range(3)], float)
    args = (rng.integers(0, 2, M), rng.normal(size=M), (clique < 0).astype(float), mCi)
    g, b, off, nc = torch_noncon.kernel_inputs(rng.integers(0, 2, (M, n_free)), *args, dev)
    assert int(off[2]) == int(off[3])
    e, k = cuda.brute_force_minimise(g, b, off, n_free, nc)
    e2, _ = torch_noncon.brute_force_plain(g, b, off, n_free, nc)
    assert abs(float(e) - float(e2)) <= 1e-12 * max(1.0, abs(float(e2)))
    g, b, off, nc = torch_noncon.kernel_inputs(np.zeros((M, n_free)), *args, dev)
    e, k = cuda.brute_force_minimise(g, b, off, n_free, nc)
    e2, _ = torch_noncon.brute_force_plain(g, b, off, n_free, nc)
    torch.cuda.synchronize()
    assert int(k) == 0
    assert abs(float(e) - float(e2)) <= 1e-12 * max(1.0, abs(float(e2)))


def test_state_kernels_reject_bad_operands(dev):
    rng = np.random.default_rng(3)
    x = planes(rng, 4, 70, dev)
    r = torch.zeros(4, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="disagree"):
        cuda.expval(x, x, r, r, x[:, :1].contiguous(), r, r)
    with pytest.raises(TypeError, match="dtype"):
        cuda.expval(x, x, r.float(), r, x, r, r)
    g = torch.zeros(4, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="partition"):
        cuda.brute_force_minimise(g, r, torch.tensor([0, 3], device=dev), 3, 0)
    with pytest.raises(ValueError, match="not in"):
        cuda.brute_force_minimise(g, r, torch.tensor([0, 4], device=dev), 32, 0)


def test_empty_state_launches_nothing(dev):
    rng = np.random.default_rng(4)
    x = planes(rng, 5, 70, dev)
    r = torch.ones(5, dtype=torch.float64, device=dev)
    e = x[:0]
    cuda.reset_launches()
    out = cuda.expval(x, x, r, r, e, r[:0], r[:0])
    assert float(out[0]) == 0 and float(out[1]) == 0
    assert cuda.launches["expval"] == 0


def grouped_terms(rng, n, G, T, one_term_group=False):
    """(ux, off, z, ph) of G distinct X patterns, one of them 0, with T >= G
    terms in all, at least one a group (group 1 exactly one if
    one_term_group), distinct Z patterns within a group, on the host."""
    dim = 1 << n
    ux = rng.choice(dim, G, replace=False)
    if 0 not in ux:
        ux[0] = 0
    counts = np.ones(G, np.int64)
    counts += np.bincount(rng.integers(0, G, T - G), minlength=G)
    if one_term_group and G > 1:
        counts[0] += counts[1] - 1
        counts[1] = 1
    counts = np.minimum(counts, dim)
    z = np.concatenate([rng.choice(dim, c, replace=False) for c in counts])
    ph = rng.normal(size=z.size) + 1j * rng.normal(size=z.size)
    off = np.concatenate([[0], np.cumsum(counts)])
    return ux, off, z, ph


def on_card(dev, ux, off, z, ph):
    return (torch.tensor(ux, device=dev), torch.tensor(off, dtype=torch.int32, device=dev),
            torch.tensor(z, dtype=torch.int32, device=dev), torch.tensor(ph, device=dev))


def matvec_chunks(b):
    """The column widths group_matvec launches for a block of b columns."""
    out = []
    while b:
        out.append(next(w for w in cuda.MATVEC_WIDTHS if w <= b))
        b -= out[-1]
    return out


@pytest.mark.parametrize("n,G,T,b,one", [
    (1, 1, 1, 1, False), (2, 1, 3, 2, False), (3, 5, 9, 2, True), (4, 7, 20, 4, False),
    (6, 1, 30, 8, False), (9, 33, 100, 3, True), (10, 64, 300, 16, False),
    (15, 101, 700, 1, True), (15, 378, 2229, 4, False), (12, 9, 2500, 8, True),
    (17, 40, 300, 1, False), (17, 12, 80, 2, True),
])
def test_group_matvec_equals_plain(dev, n, G, T, b, one):
    """The recomputing kernel against the plain version (the table built,
    then read) within 1e-14 of the sum of |ph_t| |V[c, r ^ ux_g]| over a
    row's terms, at every column width, one group, a one-term group, 1 to
    17 qubits; a second launch is bit-identical."""
    rng = np.random.default_rng(n * 100 + G + b)
    terms = on_card(dev, *grouped_terms(rng, n, G, T, one_term_group=one))
    V = rng.normal(size=(b, 1 << n)) + 1j * rng.normal(size=(b, 1 << n))
    Vd = torch.tensor(V, device=dev)
    before = cuda.launches["group_matvec"]
    got = cuda.group_matvec(*terms, Vd)
    again = cuda.group_matvec(*terms, Vd)
    torch.cuda.synchronize()
    # per column chunk of a width in MATVEC_WIDTHS, each call: one launch,
    # and one that adds the slices' partial sums where the groups are sliced
    per_call = sum(1 + (cuda._matvec_slices(1 << n, w) > 1) for w in matvec_chunks(b))
    assert cuda.launches["group_matvec"] == before + 2 * per_call
    assert torch.equal(torch.view_as_real(got), torch.view_as_real(again))
    want = torch_lanczos.terms_matvec(*terms, Vd)
    ux, off, z, ph = terms
    rows = torch.arange(1 << n, device=dev)
    scale = torch.zeros_like(want.real)
    for g in range(G):
        for k in range(int(off[g]), int(off[g + 1])):
            scale += ph[k].abs() * Vd[:, rows ^ ux[g]].abs()
    assert bool(((got - want).abs() <= 1e-14 * scale).all())
    out = torch.full_like(Vd, float("nan"))
    assert cuda.group_matvec(*terms, Vd, out=out) is out
    assert torch.equal(torch.view_as_real(out), torch.view_as_real(got))


def test_group_matvec_rejects_bad_operands(dev):
    rng = np.random.default_rng(3)
    ux, off, z, ph = on_card(dev, *grouped_terms(rng, 3, 2, 5))
    V = torch.zeros((1, 8), dtype=torch.complex128, device=dev)
    with pytest.raises(ValueError, match="disagree"):
        cuda.group_matvec(ux, off[:-1].contiguous(), z, ph, V)
    with pytest.raises(TypeError, match="dtype"):
        cuda.group_matvec(ux, off, z.long(), ph, V)
    with pytest.raises(ValueError, match="power of two"):
        cuda.group_matvec(ux, off, z, ph, V[:, :6].contiguous())


def step_operands(rng, n, dev, k=4):
    dim = 1 << n
    vec = lambda: torch.tensor(rng.normal(size=dim) + 1j * rng.normal(size=dim), device=dev)
    hv, v_prev, v_cur = vec(), vec(), vec()
    alphas = torch.zeros(k, dtype=torch.float64, device=dev)
    betas = torch.tensor(rng.random(k) + 0.5, device=dev)
    return hv, v_prev, v_cur, alphas, betas


def bits(t):
    return torch.view_as_real(t).view(torch.int64) if t.is_complex() else t.view(torch.int64)


@pytest.mark.parametrize("n", [0, 1, 5, 8, 9, 10, 14, 15, 17, 20, 22])
@pytest.mark.parametrize("j", [0, 2])
def test_lanczos_step_bitwise(dev, n, j):
    """Pass 1's step kernel bit for bit its plain version on the same
    inputs (the pairwise sums across one chunk, many chunks and more
    chunks than the card holds blocks), and again on a second launch."""
    rng = np.random.default_rng(n + 10 * j)
    ops = step_operands(rng, n, dev)
    outs = []
    for run in (cuda.lanczos_step, cuda.lanczos_step, torch_lanczos.lanczos_step):
        args = tuple(t.clone() for t in ops)
        before = cuda.launches["lanczos_step"]
        run(*args, j)
        torch.cuda.synchronize()
        assert cuda.launches["lanczos_step"] == before + (run is cuda.lanczos_step)
        outs.append(args)
    for got in outs[1:]:
        for a, b in zip(outs[0], got):
            assert torch.equal(bits(a), bits(b))
    hv, v_next = outs[0][0], outs[0][1]
    assert abs(float(torch.linalg.vector_norm(v_next)) - 1.0) < 1e-12
    assert abs(float(outs[0][4][j]) / float(torch.linalg.vector_norm(hv)) - 1) < 1e-14


@pytest.mark.parametrize("n,m", [(0, 1), (6, 2), (12, 1), (15, 4), (18, 3)])
def test_lanczos_replay_bitwise(dev, n, m):
    """Pass 2's kernel bit for bit its plain version, counted under its own
    key, and it rebuilds the v_{j+1} of pass 1's step from the stored
    scalars; hv is only read."""
    rng = np.random.default_rng(100 + n)
    ops = step_operands(rng, n, dev)
    S = torch.tensor(rng.normal(size=(4, m)), device=dev)
    y0 = torch.tensor(rng.normal(size=(m, 1 << n)) + 0j, device=dev)
    first = tuple(t.clone() for t in ops)
    cuda.lanczos_step(*first, 1)
    outs = []
    for run in (cuda.lanczos_replay, torch_lanczos.lanczos_replay):
        args = tuple(t.clone() for t in ops[:3]) + (first[3], first[4])
        y = y0.clone()
        before = cuda.launches["lanczos_replay"]
        run(*args, 1, S, y)
        torch.cuda.synchronize()
        assert cuda.launches["lanczos_replay"] == before + (run is cuda.lanczos_replay)
        outs.append((*args[:3], y))
    for a, b in zip(*outs):
        assert torch.equal(bits(a), bits(b))
    assert torch.equal(bits(outs[0][1]), bits(first[1]))  # v_{j+1} as pass 1 made it
    assert torch.equal(bits(outs[0][0]), bits(ops[0]))
    want = y0 + S[1][:, None] * ops[2][None]
    assert float((outs[0][3] - want).abs().max()) <= 1e-15 * float(want.abs().max())


def test_lanczos_step_breakdown(dev):
    """hv in the span of v_cur and v_prev: w = 0 exactly, beta = 0 and
    v_next = 0 (no division by zero), on the card as in the plain version."""
    rng = np.random.default_rng(5)
    hv, v_prev, v_cur, alphas, betas = step_operands(rng, 6, dev)
    v_cur = torch.zeros_like(v_cur)
    v_cur[3] = 1.0
    hv = 0.5 * v_cur + float(betas[0]) * v_prev
    outs = []
    for run in (cuda.lanczos_step, torch_lanczos.lanczos_step):
        args = (hv.clone(), v_prev.clone(), v_cur.clone(), alphas.clone(), betas.clone())
        run(*args, 1)
        outs.append(args)
    for a, b in zip(*outs):
        assert torch.equal(bits(a), bits(b))
    assert float(outs[0][4][1]) == 0.0 and abs(float(outs[0][3][1]) - 0.5) < 1e-15
    assert not bool(outs[0][1].abs().any())


def test_lanczos_drivers_on_the_card(dev):
    """The scalar driver on the card: the recomputing matvec and the step
    kernels only (no table build), pass 2 replaying pass 1, and the same
    energy as the CPU device within 1e-10."""
    from symmer_torch import config
    from symmer_torch.kernels import lanczos

    rng = np.random.default_rng(8)
    n = 9
    x = pack.pack_bits(rng.random((40, n)) < 0.3, n)
    z = pack.pack_bits(rng.random((40, n)) < 0.3, n)
    c = rng.normal(size=40)
    old = config.device
    try:
        config.device = "cuda"
        cuda.reset_launches()
        e_card, v_card = lanczos.lanczos_ground_state(x, z, c, n, k=60)
        counts = dict(cuda.launches)
        config.device = "cpu"
        e_cpu, v_cpu = lanczos.lanczos_ground_state(x, z, c, n, k=60)
    finally:
        config.device = old
    assert counts["build_group_diagonals"] == 0
    per_matvec = 1 + (cuda._matvec_slices(1 << n, 1) > 1)
    assert counts["group_matvec"] == 2 * 60 * per_matvec
    assert counts["lanczos_step"] == counts["lanczos_replay"] == 60
    assert abs(e_card[0] - e_cpu[0]) < 1e-10
    assert abs(abs(np.vdot(v_card[:, 0], v_cpu[:, 0])) - 1) < 1e-8


@pytest.mark.parametrize("n,G,T", [(0, 1, 1), (3, 2, 5), (11, 3, 40), (12, 3, 40),
                                   (13, 4, 60), (15, 5, 80), (21, 1, 30)])
def test_build_group_diagonals_bitwise(dev, n, G, T):
    rng = np.random.default_rng(n + T)
    flat = rng.choice(G << n, min(T, G << n), replace=False)
    gidx, z_int = flat >> n, flat & ((1 << n) - 1)
    ph = rng.normal(size=flat.size) + 1j * rng.normal(size=flat.size)
    ph[:1] = -0.0 - 0.0j
    args = (torch.tensor(gidx, device=dev), torch.tensor(z_int, device=dev),
            torch.tensor(ph, device=dev))
    before = cuda.launches["build_group_diagonals"]
    got = cuda.build_group_diagonals(*args, G, n)
    torch.cuda.synchronize()
    assert cuda.launches["build_group_diagonals"] == before + len(torch_lanczos.fwht_passes(n))
    want = torch_lanczos.build_group_diagonals(*args, G, n)
    assert torch.equal(torch.view_as_real(got).view(torch.int64),
                       torch.view_as_real(want).view(torch.int64))
    vals = np.zeros((G, 1 << n), complex)
    np.add.at(vals, (gidx, z_int), ph)
    host = dense.fwht_rows(vals)
    assert np.array_equal(got.cpu().numpy().view(np.int64), host.view(np.int64))


def card_state(rng, n, dev):
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return torch.tensor(v / np.linalg.norm(v), device=dev)


@pytest.mark.parametrize("n", [1, 2, 8, 9, 10, 17])
def test_vqe_rotate_bitwise(dev, n):
    from symmer_torch.kernels import torch_vqe

    rng = np.random.default_rng(n)
    psi = card_state(rng, n, dev)
    dim = 1 << n
    for x, z, ph in ((0, 0, 1.0), (dim - 1, dim - 1, -1j), (int(rng.integers(dim)),
                                                          int(rng.integers(dim)), -1.0)):
        t = float(rng.normal())
        args = (x, z, float(np.real(ph)), float(np.imag(ph)), np.cos(t), np.sin(t))
        before = cuda.launches["vqe_rotate"]
        got = cuda.vqe_rotate(psi, *args)
        again = cuda.vqe_rotate(psi, *args, out=torch.empty_like(psi))
        torch.cuda.synchronize()
        assert cuda.launches["vqe_rotate"] == before + 2
        want = torch_vqe.rotate(psi, *args)
        assert torch.equal(bits(got), bits(want)) and torch.equal(bits(got), bits(again))
    with pytest.raises(ValueError):
        cuda.vqe_rotate(psi, dim, 0, 1.0, 0.0, 1.0, 0.0)
    with pytest.raises(ValueError):
        cuda.vqe_rotate(psi, 0, 0, 1.0, 0.0, 1.0, 0.0, out=psi)


@pytest.mark.parametrize("n,N", [(1, 1), (2, 3), (9, 1), (10, 5), (15, 704), (17, 2)])
def test_pauli_overlaps_bitwise(dev, n, N):
    from symmer_torch.kernels import torch_vqe

    rng = np.random.default_rng(n * 1000 + N)
    a, b = card_state(rng, n, dev), card_state(rng, n, dev)
    xs = torch.tensor(rng.integers(0, 1 << n, size=N), device=dev)
    zs = torch.tensor(rng.integers(0, 1 << n, size=N), device=dev)
    phs = np.array([1, -1j, -1, 1j])[rng.integers(0, 4, size=N)]
    ph = torch.tensor(np.stack([phs.real, phs.imag], axis=1), device=dev)
    groups = cuda.overlap_groups(xs, 1 << n, dev)
    before = cuda.launches["pauli_overlaps"]
    got = cuda.pauli_overlaps(a, b, xs, zs, ph, groups)
    again = cuda.pauli_overlaps(a, b, xs, zs, ph, groups, out=torch.empty_like(got))
    torch.cuda.synchronize()
    assert cuda.launches["pauli_overlaps"] == before + 4  # two launches a call
    want = torch_vqe.pauli_overlaps(a, b, xs, zs, ph)
    assert torch.equal(bits(got), bits(want)) and torch.equal(bits(got), bits(again))
    empty = cuda.overlap_groups(xs[:0], 1 << n, dev)
    assert cuda.pauli_overlaps(a, b, xs[:0], zs[:0], ph[:0], empty).shape == (0,)


def random_generators(rng, n, P, kind):
    """(x, z, ph) of P generators on n qubits: "random" x's drawn from a
    few patterns in stretches of one x (as UCCSD's are), "diagonal" x = 0
    only, "split" two patterns interleaved so that a run boundary falls
    inside the generators sharing one x."""
    dim = 1 << n
    pool = rng.integers(0, dim, size=max(2, P // 6))
    if kind == "diagonal":
        x = np.zeros(P, np.int64)
    elif kind == "split":
        x = np.where(np.arange(P) % 3 == 1, pool[0], pool[1])
    else:
        x = np.repeat(pool, rng.integers(1, 12, size=pool.size))[:P]
        x = np.concatenate([x, rng.integers(0, dim, size=P - x.size)])
        x[rng.random(P) < 0.1] = 0
    z = rng.integers(0, dim, size=P)
    y = np.array([bin(int(a) & int(b)).count("1") for a, b in zip(x, z)])
    ph = (-1j) ** (y % 4) * rng.choice([1.0, -1.0], size=P)
    return x.astype(np.int64), z.astype(np.int64), ph


VQE_RUN_CASES = [(1, 3, 10, "random"), (2, 5, 10, "random"), (3, 9, 1, "random"),
                 (5, 40, 3, "random"), (8, 60, 8, "random"), (10, 80, 10, "random"),
                 (12, 200, 10, "random"), (12, 50, 12, "random"), (14, 100, 9, "diagonal"),
                 (9, 600, 10, "diagonal"),
                 (11, 30, 2, "split"), (17, 300, 10, "random"), (22, 24, None, "random")]


@pytest.mark.parametrize("n,P,tile_bits,kind", VQE_RUN_CASES)
def test_vqe_runs_bitwise(dev, n, P, tile_bits, kind):
    """The forward over coset tiles equals its plain version and P
    sequential rotations bit for bit, in one launch, in and out of place,
    and on a second launch: n <= d_max down to n = 1, x = 0
    only (one run cut at MAX_RUN generators), a run boundary inside the
    generators sharing one x, d = d_max."""
    from symmer_torch.kernels import torch_vqe

    rng = np.random.default_rng(n * 100 + P + (tile_bits or 0))
    x, z, ph = random_generators(rng, n, P, kind)
    plan = torch_vqe.plan_runs(x, z, ph, n, tile_bits=tile_bits)
    dplan = plan.on(dev)
    t = rng.normal(size=P)
    cs = torch.tensor(np.stack([np.cos(t), np.sin(t)], 1), device=dev)
    psi = card_state(rng, n, dev)
    before = cuda.launches["vqe_rotate"]
    got = cuda.vqe_runs(psi, dplan, cs)
    again = psi.clone()
    cuda.vqe_runs(again, dplan, cs, out=again)
    torch.cuda.synchronize()
    assert cuda.launches["vqe_rotate"] == before + 2
    want = torch_vqe.rotate_runs(psi, plan, cs)
    seq = psi
    for k in range(P):
        seq = torch_vqe.rotate(seq, int(x[k]), int(z[k]), ph[k].real, ph[k].imag, np.cos(t[k]),
                               np.sin(t[k]))
    assert torch.equal(bits(got), bits(want)) and torch.equal(bits(got), bits(again))
    assert torch.equal(bits(got), bits(seq))


@pytest.mark.parametrize("n,P,tile_bits,kind", VQE_RUN_CASES)
def test_vqe_adjoint_bitwise(dev, n, P, tile_bits, kind):
    """The adjoint sweep equals its plain version bit for bit (the
    per-coset partials and their tree), in two launches (the sweep, the
    totals), and on a second launch."""
    from symmer_torch.kernels import torch_vqe

    rng = np.random.default_rng(n * 100 + P + (tile_bits or 0) + 7)
    x, z, ph = random_generators(rng, n, P, kind)
    plan = torch_vqe.plan_runs(x, z, ph, n, tile_bits=tile_bits)
    dplan = plan.on(dev)
    t = rng.normal(size=P)
    cs = torch.tensor(np.stack([np.cos(t), np.sin(t)], 1), device=dev)
    psi, lam = card_state(rng, n, dev), card_state(rng, n, dev)
    want = torch_vqe.adjoint_sweep(psi, lam, plan, cs)
    before = cuda.launches["vqe_adjoint"]
    got = cuda.vqe_adjoint(psi.clone(), lam.clone(), dplan, cs)
    again = cuda.vqe_adjoint(psi.clone(), lam.clone(), dplan, cs)
    torch.cuda.synchronize()
    assert cuda.launches["vqe_adjoint"] == before + 4
    assert torch.equal(bits(got), bits(want)) and torch.equal(bits(got), bits(again))


@pytest.mark.parametrize("n,N", [(4, 70_000), (12, 3000)])
def test_pauli_overlaps_grouped_bitwise(dev, n, N):
    """More Paulis than a grid dimension holds, and a few X groups with
    many Paulis each (batches of warp sums), bit for bit the plain version,
    with the groups from device and from host X parts."""
    from symmer_torch.kernels import torch_vqe

    rng = np.random.default_rng(n + N)
    a, b = card_state(rng, n, dev), card_state(rng, n, dev)
    px = rng.integers(0, 1 << n, size=7)[rng.integers(0, 7, size=N)]
    xs = torch.tensor(px, device=dev)
    zs = torch.tensor(rng.integers(0, 1 << n, size=N), device=dev)
    phs = np.array([1, -1j, -1, 1j])[rng.integers(0, 4, size=N)]
    ph = torch.tensor(np.stack([phs.real, phs.imag], axis=1), device=dev)
    got = cuda.pauli_overlaps(a, b, xs, zs, ph, cuda.overlap_groups(px, 1 << n, dev))
    again = cuda.pauli_overlaps(a, b, xs, zs, ph, cuda.overlap_groups(xs, 1 << n, dev))
    torch.cuda.synchronize()
    want = torch_vqe.pauli_overlaps(a, b, xs, zs, ph)
    assert torch.equal(bits(got), bits(want)) and torch.equal(bits(got), bits(again))


def rref_stack(rng, R, W, kind):
    M = rng.integers(0, 1 << 63, size=(R, W), dtype=np.int64)
    if kind == "zero":
        M[:] = 0
    elif kind == "deficient":  # 30 independent rows, the rest their sums
        B = M[:30].copy()
        M = np.zeros_like(M)
        for j in range(30):
            M[rng.random(R) < 0.5] ^= B[j]
    elif kind == "tail":  # a long run of zero rows after the pivots
        M[R // 4:] = 0
    return M


@pytest.mark.parametrize("R,W,kind", [(1, 1, "random"), (2048, 1, "random"),
                                      (2048, 32, "deficient"), (5000, 3, "tail"),
                                      (700, 2, "zero"), (96, 2, "random"), (300, 70, "random"),
                                      (20000, 32, "deficient")])
def test_gf2_rref_bitwise(dev, R, W, kind):
    from symmer_torch.kernels import torch_gf2
    from symmer_torch.native import gf2core

    rng = np.random.default_rng(R + W)
    M = rref_stack(rng, R, W, kind)
    got = cuda.gf2_rref(torch.tensor(M, device=dev))
    again = cuda.gf2_rref(torch.tensor(M, device=dev))
    torch.cuda.synchronize()
    want = torch_gf2.rref(torch.tensor(M))
    host = M.view(np.uint64).copy()
    gf2core.rref_inplace(host)
    assert torch.equal(got.cpu(), want) and torch.equal(got, again)
    assert np.array_equal(got.cpu().numpy().view(np.uint64), host)


def test_vqe_engine_on_the_card(dev):
    """The engine on the card against the same engine on the CPU device
    (the plain versions): energy and gradient within 1e-12; the counted
    forward and backward launch only the runs' forward, the sweep, the
    overlaps and the matvec, one call each per piece; the pool gradient
    likewise."""
    from symmer_torch import PauliwordOp, QuantumState, config
    from symmer_torch.evolution import device_vqe

    rng = np.random.default_rng(3)
    n = 10
    H = PauliwordOp.random(n, 60, density=0.4).cleanup()
    H.coeff_vec = H.coeff_vec.real.astype(complex)
    gens = PauliwordOp.random(n, 12, density=0.3).cleanup()
    keep = np.any(gens.symp_matrix, axis=1)
    gens = PauliwordOp.from_planes(gens.x_pack[keep], gens.z_pack[keep],
                                   np.ones(int(keep.sum())), n)
    ref = QuantumState.random(n, 3).normalize
    pool = PauliwordOp.random(n, 20, density=0.4)
    pool.coeff_vec[:] = 1
    x = rng.normal(size=gens.n_terms)
    old = config.device
    try:
        config.device = "cuda"
        cuda.reset_launches()
        eng = device_vqe.DeviceVQEEngine(H, gens, ref)
        e_card, g_card = eng.loss(x), eng.gradient(x)
        p_card = eng.pool_gradient(pool, x)
        counts, calls = dict(cuda.launches), dict(cuda.calls)
        config.device = "cpu"
        eng = device_vqe.DeviceVQEEngine(H, gens, ref)
        e_cpu, g_cpu, p_cpu = eng.loss(x), eng.gradient(x), eng.pool_gradient(pool, x)
    finally:
        config.device = old
    assert abs(e_card - e_cpu) <= 1e-12
    assert np.abs(g_card - g_cpu).max() <= 1e-12 and np.abs(p_card - p_cpu).max() <= 1e-12
    # a forward each for the loss, the gradient and the pool gradient; one
    # sweep and its totals; two launches per overlap call (the loss's and
    # the gradient's energies, the pool)
    assert counts["vqe_rotate"] == 3 and calls["vqe_rotate"] == 3
    assert counts["vqe_adjoint"] == 2 and calls["vqe_adjoint"] == 1
    assert counts["pauli_overlaps"] == 2 * 3 and calls["pauli_overlaps"] == 3
    assert counts["group_matvec"] > 0
    assert {k for k, v in counts.items() if v} == {"vqe_rotate", "vqe_adjoint", "pauli_overlaps",
                                                   "group_matvec"}



def test_vqe_second_backward_raises(dev):
    """The sweep overwrites the vectors saved for backward on the card, so
    a second backward through the same graph raises instead of returning
    a gradient from the un-rotated vectors."""
    from symmer_torch import PauliwordOp, QuantumState, config
    from symmer_torch.evolution import device_vqe

    n = 6
    H = PauliwordOp.random(n, 20, density=0.4).cleanup()
    H.coeff_vec = H.coeff_vec.real.astype(complex)
    gens = PauliwordOp.from_list(["XYIIII", "IIXXYI", "YIIIIX"], [1.0, 1.0, 1.0])
    ref = QuantumState.random(n, 2).normalize
    old = config.device
    try:
        config.device = "cuda"
        eng = device_vqe.DeviceVQEEngine(H, gens, ref)
        x = torch.tensor([0.3, -0.2, 0.1], dtype=torch.float64, requires_grad=True)
        e = device_vqe._Energy.apply(x, eng)
        e.backward(retain_graph=True)
        with pytest.raises(RuntimeError, match="modified by an inplace operation"):
            e.backward()
    finally:
        config.device = old

def _touch_cuda(queue):
    try:
        torch.zeros(1, device="cuda")
        queue.put("ok")
    except Exception as exc:  # the child reports what CUDA said
        queue.put(repr(exc))


def test_forked_child_cannot_use_the_parents_cuda_context(dev):
    import multiprocessing as mp

    from symmer_torch import config, process

    torch.zeros(1, device=dev)  # the parent holds a CUDA context
    ctx = mp.get_context("fork")
    queue = ctx.Queue(1)
    child = ctx.Process(target=_touch_cuda, args=(queue,))
    child.start()
    msg = queue.get(timeout=120)
    child.join(timeout=60)
    assert "re-initialize CUDA in forked subprocess" in msg
    old = (process.method, config.backend, config.device)
    try:
        process.method, config.backend, config.device = "mp", "auto", "cuda"
        with pytest.raises(RuntimeError, match="forked child"):
            process.parallelize(lambda i, s: i)(range(3), None)
    finally:
        process.method, config.backend, config.device = old
