"""The hand-written CUDA kernels against their plain torch versions.

These tests need a CUDA card and skip without one.  tests/conftest.py
configures JAX, which the machine with the card need not have, so run them
from the repository root with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

row_signature (K2) equals its plain version bit for bit and on a second
launch (1 to 33 words a row, 1 to 1,000 rows, all-zero and all-one words,
the flagship's 200,000 x 16 words, planes off a 16-byte boundary, rows of
no words) and refuses other dtypes, non-contiguous planes and mixed
devices; a device cleanup launches it.  pair_products (K4) equals its plain
version bit for bit on the CPU and on the card (tiles narrower and wider
than 32 operand-2 rows, words past a chunk, rows of no words) and on a
second launch; merge_groups (K3) equals its plain version on the CPU bit
for bit and on a second launch, and the card's within 1e-12 (torch's CUDA
segment_reduce may add in another order), with a group longer than a
block, groups that cancel, exact zeros kept, the pair row source and
empty inputs; a device cleanup and product synchronise with the host once,
and a product allocates no product planes.  rotation_rows (K6) and
project_rows (K7) equal their plain versions bit for bit on the CPU and the
card and on a second launch (one to 80 words a row, planes off a 16-byte
boundary, no term or every term anticommuting, no stabilizer and more
stabilizers than lanes), launch nothing for no rows and refuse other
dtypes, shapes and devices; K3 with their live flags (a dead head, dead
rows at the hand-off sizes, groups and inputs of dead rows only) and
their rotation and masked row sources is held as above; the composites
launch K6 or K7 once, K3 twice and no K2, and synchronise with the host
once.  The fused route (cleanup_small, product_small: K3's one-block route
signing its slots) equals its plain version, the two launches it replaces
and a second launch bit for bit, one launch a call, and the composites
within cuda.small_fused launch it alone, with one host synchronisation.
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
lanczos_step equals its plain version bit for bit on both routes (one
thread-block cluster: every cut of the rows into blocks and slots up to the
cluster's most rows, which it refuses beyond; one cooperative launch: one
and many chunks), with v_next aliased to v_prev and distinct, and on a
breakdown with beta = 0; lanczos_replay and lanczos_ritz (pass 2 from the
kept basis, k_eff < k, several Ritz vectors) equal theirs bit for bit; the
scalar driver on the card launches only the matvec, the step and
lanczos_ritz (the replay where the basis rule refuses), both routes bit for
bit alike; build_group_diagonals equals its plain
version and the host's dense.group_diagonals bit for bit on both sides of
the split between the shared-memory pass and the strided passes (n = 11,
12, 13, 15, and 21: three passes).  The evolution slice: vqe_rotate and
pauli_overlaps equal their plain versions bit for bit (one row pair, one
chunk, many chunks; N = 1, a batch, an empty batch) and on a second launch;
gf2_rref equals its plain version and the host's gf2core.rref_inplace bit
for bit (one row, all-zero and full-rank stacks, words past one lane per
word, zero runs longer than a window; the blocked route's panel edges:
ranks 63 / 64 / 65, dependent chunks, rows that turn zero in a panel,
pivots beyond the walk's window, the panel in shared memory and in global
memory; the wide transposed stacks of a 1,100-qubit symmetry search, 2,200
x 108 and 2,200 x 3,160 words); the VQE engine on the card equals
the CPU device within 1e-12 and launches only its three kernels; a forked
child cannot use the parent's CUDA context, and process 'mp' refuses to
fork one.  The mesh slice: route_rows (K16) equals its plain version bit for
bit and on a second launch, in one launch a call (one row, chunk and tile
edges, 300,000 rows, all kept, all sent, 200-word rows; an empty input
launches nothing; calls of many sizes in a row reuse the look-back's status
words);
brute_force_minimise over ranges of the assignments equals its plain
version over each range, and the ranges' minimum is the full launch's bit
for bit; four shards of one card give the one-device route's operators
(cleanup, product, rotation, taper projection) and launch route_rows.  The
eigensolver and VQE mesh branches: group_matvec with a row range equals
the launch over every row bit for bit (the mesh's row blocks at 2^15 and
2^17 rows for 2 and 4 shards, ranges narrower than a tile, b = 1 and 4);
on four shards of one card the ground state, the deflated and the block
solves are bit for bit the one-device route's, with N row-range launches
a matvec, and the VQE engine's energy and gradient agree with one device
within 1e-12 and 1e-10.
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


# -- K2 (row_signature) --------------------------------------------------------

def same_signature(x, z):
    """The kernel's keys bit for bit the plain version's, on a second launch
    too; one launch a call."""
    before = cuda.launches["row_signature"]
    got, again = cuda.row_signature(x, z), cuda.row_signature(x, z)
    want = torch_core.row_signature(x.cpu(), z.cpu())
    torch.cuda.synchronize()
    assert cuda.launches["row_signature"] == before + 2
    for g, a, w in zip(got, again, want):
        assert g.device == x.device and g.dtype == torch.int64 and g.is_contiguous()
        assert torch.equal(g.cpu(), w) and torch.equal(g, a)


@pytest.mark.parametrize("W", [1, 2, 3, 16, 17, 33])
@pytest.mark.parametrize("T", [1, 31, 33, 1000])
def test_row_signature_equals_plain(dev, W, T):
    rng = np.random.default_rng(10 * W + T)
    x = torch.tensor(rng.integers(-2**63, 2**63 - 1, (T, W), endpoint=True), device=dev)
    z = torch.tensor(rng.integers(-2**63, 2**63 - 1, (T, W), endpoint=True), device=dev)
    same_signature(x, z)


@pytest.mark.parametrize("W", [1, 16, 17])
def test_row_signature_all_zero_and_all_one_words(dev, W):
    for fill in (0, -1):
        x = torch.full((33, W), fill, dtype=torch.int64, device=dev)
        z = torch.full((33, W), -1 - fill, dtype=torch.int64, device=dev)
        z[:3] = fill
        same_signature(x, z)


def test_row_signature_at_size_and_unaligned_planes(dev):
    """The flagship's 200,000 x 16 words; planes 8 bytes past a 16-byte
    boundary (even W read a word a unit); zero words a row."""
    rng = np.random.default_rng(2)
    same_signature(planes(rng, 200_000, 1000, dev), planes(rng, 200_000, 1000, dev))
    for W in (2, 16):
        bufs = [torch.empty(500 * W + 1, dtype=torch.int64, device=dev) for _ in range(2)]
        x, z = (b[1:].view(500, W) for b in bufs)
        x.copy_(planes(rng, 500, 64 * W, dev))
        z.copy_(planes(rng, 500, 64 * W, dev))
        same_signature(x, z)
    e = torch.empty((7, 0), dtype=torch.int64, device=dev)
    same_signature(e, e)


def test_row_signature_empty_and_refusals(dev):
    e = torch.empty((0, 4), dtype=torch.int64, device=dev)
    before = cuda.launches["row_signature"]
    ka, kb = cuda.row_signature(e, e)
    assert ka.shape == kb.shape == (0,) and ka.device == e.device
    assert cuda.launches["row_signature"] == before  # nothing launched
    x = planes(np.random.default_rng(4), 6, 130, dev)
    with pytest.raises(TypeError, match="dtype"):
        cuda.row_signature(x.to(torch.int32), x)
    with pytest.raises(ValueError, match="contiguous"):
        cuda.row_signature(x.t().contiguous().t(), x)
    with pytest.raises(ValueError, match="disagree"):
        cuda.row_signature(x, x[:, :1].contiguous())
    with pytest.raises(ValueError, match="expected"):
        cuda.row_signature(x, x.cpu())


def test_cleanup_on_the_card_launches_the_signature(dev, monkeypatch):
    """A device cleanup (and the state cleanup) outside the fused route
    (here off: cuda.FUSED_WORDS set to -1) launches K2 once and equals the
    CPU device's cleanup bit for bit."""
    monkeypatch.setattr(cuda, "FUSED_WORDS", -1)
    rng = np.random.default_rng(6)
    base = planes(rng, 300, 200, "cpu")
    x = base[torch.from_numpy(rng.integers(0, 300, 2000))]
    z = base.flip(0)[torch.from_numpy(rng.integers(0, 300, 2000))]
    c = torch.from_numpy(rng.normal(size=(2, 2000)))
    before = cuda.launches["row_signature"]
    got = torch_core.cleanup_sorted(x.to(dev), z.to(dev), c[0].to(dev), c[1].to(dev), 1e-15)
    torch_state.cleanup_state(x.to(dev), c[0].to(dev), c[1].to(dev))
    torch.cuda.synchronize()
    assert cuda.launches["row_signature"] == before + 2
    want = torch_core.cleanup_sorted(x, z, c[0], c[1], 1e-15)
    for g, w in zip(got, want):
        g = g.cpu()
        assert torch.equal(g.view(torch.int64) if g.is_floating_point() else g,
                           w.view(torch.int64) if w.is_floating_point() else w)


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


@pytest.mark.parametrize("n", [15, 17])
@pytest.mark.parametrize("N", [2, 4])
@pytest.mark.parametrize("b", [1, 4])
def test_group_matvec_row_range_bitwise(dev, n, N, b):
    """K13 with rows= (a mesh's row blocks, and ranges narrower than a
    tile or cut inside one): each range bit for bit the launch over every
    row, one launch (and one slice sum where the groups are sliced) a
    column chunk; out= takes a (b, r1 - r0) buffer."""
    rng = np.random.default_rng(n * 10 + N + b)
    terms = on_card(dev, *grouped_terms(rng, n, 120, 900, one_term_group=True))
    Vd = torch.tensor(rng.normal(size=(b, 1 << n)) + 1j * rng.normal(size=(b, 1 << n)),
                      device=dev)
    whole = cuda.group_matvec(*terms, Vd)
    step = (1 << n) // N
    per_call = sum(1 + (cuda._matvec_slices(1 << n, w) > 1) for w in matvec_chunks(b))
    for r0, r1 in [(s * step, (s + 1) * step) for s in range(N)] + [(5, 37), (1000, 1001)]:
        before = cuda.launches["group_matvec"]
        got = cuda.group_matvec(*terms, Vd, rows=(r0, r1))
        torch.cuda.synchronize()
        assert cuda.launches["group_matvec"] == before + per_call
        assert got.shape == (b, r1 - r0)
        assert torch.equal(torch.view_as_real(got), torch.view_as_real(whole[:, r0:r1]))
    out = torch.full((b, step), float("nan"), dtype=torch.complex128, device=dev)
    assert cuda.group_matvec(*terms, Vd, out=out, rows=(step, 2 * step)) is out
    assert torch.equal(torch.view_as_real(out), torch.view_as_real(whole[:, step:2 * step]))
    with pytest.raises(ValueError, match="not a range"):
        cuda.group_matvec(*terms, Vd, rows=(4, 4))
    with pytest.raises(ValueError, match="disagree"):
        cuda.group_matvec(*terms, Vd, out=out, rows=(0, 2 * step))


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


def same_step(ops, j, route=None, blocks=0):
    """The step kernel (twice) and its plain version on copies of ops, with
    v_next aliased to v_prev and as a buffer of its own: all bit for bit
    alike but hv, the step's scratch; returns the first launch's (v_cur,
    v_next, alphas, betas)."""
    outs = []
    for alias in (True, False):
        for run in (cuda.lanczos_step, cuda.lanczos_step, torch_lanczos.lanczos_step):
            hv, v_prev, v_cur, alphas, betas = (t.clone() for t in ops)
            v_next = v_prev if alias else torch.full_like(v_prev, float("nan"))
            before = cuda.launches["lanczos_step"]
            if run is cuda.lanczos_step:
                run(hv, v_prev, v_cur, v_next, alphas, betas, j, route=route, blocks=blocks)
            else:
                run(hv, v_prev, v_cur, v_next, alphas, betas, j)
            torch.cuda.synchronize()
            assert cuda.launches["lanczos_step"] == before + (run is cuda.lanczos_step)
            if not alias:
                assert torch.equal(bits(v_prev), bits(ops[1]))  # v_prev only read
            outs.append((v_cur, v_next, alphas, betas))
    for got in outs[1:]:
        for a, b in zip(outs[0], got):
            assert torch.equal(bits(a), bits(b))
    return outs[0]


@pytest.mark.parametrize("n", [0, 1, 5, 8, 9, 10, 14, 15, 17, 20, 22])
@pytest.mark.parametrize("j", [0, 2])
def test_lanczos_step_bitwise(dev, n, j):
    """Pass 1's step kernel on its route (lanczos_step_route) bit for bit
    its plain version on the same inputs (the pairwise sums within one
    block, across a cluster's blocks, over many chunks and more chunks than
    the card holds blocks), and again on a second launch, with v_next
    aliased to v_prev and distinct."""
    rng = np.random.default_rng(n + 10 * j)
    ops = step_operands(rng, n, dev)
    v_cur, v_next, alphas, betas = same_step(ops, j)
    assert abs(float(torch.linalg.vector_norm(v_next)) - 1.0) < 1e-12
    # beta = ||w|| (torch's own sum), w = hv - beta_{j-1} v_prev - alpha v_cur
    # formed as the plain version forms it
    h, p, c = (torch.view_as_real(t) for t in ops[:3])
    w = (h - p * (ops[4][j - 1] if j else 0.0)) - c * alphas[j]
    assert abs(float(betas[j]) / float(torch.linalg.vector_norm(w)) - 1) < 1e-14


@pytest.mark.parametrize("n", [3, 8, 11, 12, 13, 14, 15, 16, 17, 18])
@pytest.mark.parametrize("route", ["cluster", "grid"])
def test_lanczos_step_routes_bitwise(dev, n, route):
    """Both routes forced at the edges of the cluster's cut (one block of
    fewer than 256 rows, clusters of 8 and 16 blocks of 256 rows, 1 .. 8
    slots a thread, and each smaller cluster that holds the rows) bit for
    bit the plain version, aliased and not; the cluster route refuses more
    rows than step_cluster() admits, and the rule takes it exactly up to
    there."""
    rng = np.random.default_rng(200 + n)
    ops = step_operands(rng, n, dev)
    blocks, rows = cuda.step_cluster()
    assert blocks in (8, 16) and rows == blocks * 256 * 8
    assert cuda.lanczos_step_route(1 << n) == ("cluster" if 1 << n <= rows else "grid")
    if route == "cluster" and 1 << n > rows:
        with pytest.raises(RuntimeError, match="launch failed"):
            cuda.lanczos_step(*ops[:3], ops[1].clone(), *ops[3:], 1, route=route)
        return
    want = same_step(ops, 1, route=route)
    if route == "cluster":
        for b in (1, 2, 4, 8):
            if b < blocks and 1 << n <= b * 256 * 8:
                got = same_step(ops, 1, route=route, blocks=b)
                assert all(torch.equal(bits(x), bits(y)) for x, y in zip(got, want))


@pytest.mark.parametrize("n,k,k_eff,m", [(0, 3, 3, 1), (6, 20, 17, 2), (10, 40, 40, 3),
                                         (15, 50, 33, 1), (15, 24, 24, 9), (17, 20, 19, 5),
                                         (12, 300, 271, 4)])
def test_lanczos_ritz_bitwise(dev, n, k, k_eff, m):
    """Pass 2 from a kept basis bit for bit its plain version (and a second
    launch): one launch, k_eff < k rows of the basis and of S read, m Ritz
    vectors (1, 2, 3 in a group of 4, 9 in two groups of 8), S across
    several shared-memory tiles of 256 rows."""
    rng = np.random.default_rng(300 + n)
    basis = torch.tensor(rng.normal(size=(k + 1, 1 << n)) + 1j * rng.normal(size=(k + 1, 1 << n)),
                         device=dev)
    S = torch.tensor(rng.normal(size=(k_eff, m)), device=dev)
    S[0, 0] = -0.0
    before = cuda.launches["lanczos_ritz"]
    got = cuda.lanczos_ritz(basis, S, k_eff)
    again = cuda.lanczos_ritz(basis, S, k_eff)
    torch.cuda.synchronize()
    assert cuda.launches["lanczos_ritz"] == before + 2
    want = torch_lanczos.ritz_from_basis(basis, S, k_eff)
    assert got.shape == (m, 1 << n)
    assert torch.equal(bits(got), bits(want)) and torch.equal(bits(got), bits(again))


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
    cuda.lanczos_step(*first[:3], first[1], *first[3:], 1)
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
        run(*args[:3], args[1], *args[3:], 1)
        outs.append(args[1:])  # all but hv, the step's scratch
    for a, b in zip(*outs):
        assert torch.equal(bits(a), bits(b))
    assert float(outs[0][3][1]) == 0.0 and abs(float(outs[0][2][1]) - 0.5) < 1e-15
    assert not bool(outs[0][0].abs().any())


def test_lanczos_drivers_on_the_card(dev, monkeypatch):
    """The scalar driver on the card: the recomputing matvec and the step
    only in pass 1 (no table build), pass 2 one lanczos_ritz launch over the
    kept basis, and the same energy as the CPU device within 1e-10; with
    the basis rule refusing, pass 2 replays pass 1 (a matvec and a replay a
    step) and gives bit for bit the same energy and vector."""
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
        monkeypatch.setattr(lanczos, "keeps_basis", lambda *a: False)
        cuda.reset_launches()
        e_replay, v_replay = lanczos.lanczos_ground_state(x, z, c, n, k=60)
        replayed = dict(cuda.launches)
        monkeypatch.undo()
        config.device = "cpu"
        e_cpu, v_cpu = lanczos.lanczos_ground_state(x, z, c, n, k=60)
    finally:
        config.device = old
    assert counts["build_group_diagonals"] == 0
    per_matvec = 1 + (cuda._matvec_slices(1 << n, 1) > 1)
    assert counts["group_matvec"] == 60 * per_matvec
    assert counts["lanczos_step"] == 60 and counts["lanczos_ritz"] == 1
    assert counts["lanczos_replay"] == 0
    assert replayed["group_matvec"] == 2 * 60 * per_matvec
    assert replayed["lanczos_step"] == replayed["lanczos_replay"] == 60
    assert replayed["lanczos_ritz"] == 0
    assert np.array_equal(e_card.view(np.int64), e_replay.view(np.int64))
    assert np.array_equal(np.ascontiguousarray(v_card).view(np.int64),
                          np.ascontiguousarray(v_replay).view(np.int64))
    assert abs(e_card[0] - e_cpu[0]) < 1e-10
    assert abs(abs(np.vdot(v_card[:, 0], v_cpu[:, 0])) - 1) < 1e-8


def test_lanczos_drivers_on_a_mesh_of_one_card(dev):
    """Mesh([cuda] * 4): the ground state, the deflated and the block solves
    bit for bit the one-device route, the matvec N row-range launches (and
    their slice sums) a step."""
    from symmer_torch import config
    from symmer_torch.kernels import lanczos
    from symmer_torch.parallel.mesh import Mesh

    rng = np.random.default_rng(9)
    n, T = 12, 80
    x = pack.pack_bits(rng.random((T, n)) < 0.3, n)
    z = pack.pack_bits(rng.random((T, n)) < 0.3, n)
    c = rng.normal(size=T)
    mesh = Mesh([dev] * 4)
    solves = {"ground": lambda m: lanczos.lanczos_ground_state(x, z, c, n, k=60, mesh=m),
              "deflate": lambda m: lanczos.lanczos_lowest_eigsh(x, z, c, n, 2, k=60, mesh=m),
              "block": lambda m: lanczos.lanczos_block_eigsh(x, z, c, n, 3, k=24, mesh=m)}
    old = config.device
    try:
        config.device = dev
        for name, solve in solves.items():
            e1, v1 = solve(None)
            cuda.reset_launches()
            eN, vN = solve(mesh)
            torch.cuda.synchronize()
            assert np.array_equal(e1.view(np.int64), eN.view(np.int64)), name
            assert np.array_equal(np.ascontiguousarray(v1).view(np.int64),
                                  np.ascontiguousarray(vN).view(np.int64)), name
            if name == "ground":
                per_matvec = 4 * (1 + (cuda._matvec_slices(1 << n, 1) > 1))
                assert cuda.launches["lanczos_step"] == 60 and cuda.launches["lanczos_ritz"] == 1
                assert cuda.launches["lanczos_replay"] == 0
                assert cuda.launches["group_matvec"] == 60 * per_matvec
    finally:
        config.device = old


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


def rref_panel_stack(rng, R, W, kind):
    """Stacks that put pivots at the blocked kernel's panel edges (64
    pivots a pass, chunks of 64 live rows, 512 a panel): rankN, random sums
    of N independent rows; firstN, N independent rows then their sums (a
    chunk of dependent rows only); edges, 60 independent rows, 10 sums of
    two of them (zero inside the panel), 70 more, 400 zero rows, 64 sums
    and 30 independent rows."""
    def indep(n, gap=1):  # n rows of distinct lowest set bits, shuffled: rank n
        B = rng.integers(0, 1 << 64, size=(n, W), dtype=np.uint64)
        for j in range(n):
            b = j * gap
            B[j, : b // 64] = 0
            B[j, b // 64] &= ~np.uint64((1 << (b % 64)) - 1)
            B[j, b // 64] |= np.uint64(1 << (b % 64))
        return B[rng.permutation(n)].view(np.int64)

    def sums(B, n):
        out = np.zeros((n, W), np.int64)
        for j in range(B.shape[0]):
            out[rng.random(n) < 0.5] ^= B[j]
        return out

    if kind.startswith("rank"):
        return sums(indep(int(kind[4:])), R)
    if kind.startswith("spread"):  # lowest bits spread over the words
        n = int(kind[6:])
        return sums(indep(n, 64 * W // n), R)
    if kind.startswith("first"):
        B = indep(int(kind[5:]))
        return np.vstack([B, sums(B, R - B.shape[0])])
    A, C = indep(60), indep(70)
    pairs = A[rng.integers(0, 60, 10)] ^ A[rng.integers(0, 60, 10)]
    return np.vstack([A, pairs, C, np.zeros((400, W), np.int64),
                      sums(np.vstack([A, C]), 64), indep(30)])


def transposed_stack(rng, terms, n_bits):
    """[A; I] transposed, as gf2.kernel_basis_packed builds it: n_bits rows of
    ceil((terms + n_bits) / 64) words, A random terms x n_bits bits."""
    from symmer_torch.kernels import gf2
    from symmer_torch.native import gf2core

    A = rng.integers(0, 1 << 63, size=(terms, -(-n_bits // 64)), dtype=np.int64).view(np.uint64)
    A &= pack.qubit_mask(n_bits)[None, :]
    St = gf2core.transpose_bits(np.vstack([A, gf2.packed_identity(n_bits)]), n_bits)
    return St.view(np.int64)


def assert_rref_equal(dev, M):
    from symmer_torch.kernels import torch_gf2
    from symmer_torch.native import gf2core

    stats = {}
    got = cuda.gf2_rref(torch.tensor(M, device=dev), stats=stats)
    again = cuda.gf2_rref(torch.tensor(M, device=dev))
    torch.cuda.synchronize()
    want = torch_gf2.rref(torch.tensor(M, device=dev))
    host = M.view(np.uint64).copy()
    gf2core.rref_inplace(host)
    assert torch.equal(got, want) and torch.equal(got, again)
    assert np.array_equal(got.cpu().numpy().view(np.uint64), host)
    return int(host.any(axis=1).sum()), int(stats["passes"])


@pytest.mark.parametrize("R,W,kind", [(300, 2, "rank63"), (300, 2, "rank64"),
                                      (300, 2, "rank65"), (215, 1, "first64"),
                                      (2100, 32, "first63"), (2100, 32, "first65"),
                                      (624, 32, "edges"), (624, 70, "edges"),
                                      (300, 192, "rank65"), (300, 193, "rank65"),
                                      (624, 200, "edges"), (2100, 32, "spread130")])
def test_gf2_rref_blocked_panel_edges(dev, R, W, kind):
    """The blocked route at ranks 63 / 64 / 65, chunks of dependent rows,
    rows that turn zero inside a panel, zero runs, pivots beyond the walk's
    window; the panel in shared memory up to 192 words a row and in global
    memory beyond; up to 64 pivots a pass."""
    M = rref_panel_stack(np.random.default_rng(R + W), R, W, kind)
    rank, passes = assert_rref_equal(dev, M)
    assert -(-rank // 64) <= passes <= -(-rank // 64) + -(-R // 512) + 1


@pytest.mark.parametrize("terms,n_bits,W", [(4712, 2200, 108), (200_000, 2200, 3160)])
def test_gf2_rref_wide_transposed_stacks(dev, terms, n_bits, W):
    """The transposed stacks of a 1,100-qubit, 200,000-term symmetry search:
    after the sketch (108 words, the panel in shared memory) and without it
    (3,160 words, the panel in global memory)."""
    M = transposed_stack(np.random.default_rng(W), terms, n_bits)
    assert M.shape == (n_bits, W)
    rank, passes = assert_rref_equal(dev, M)
    assert -(-rank // 64) <= passes <= -(-rank // 64) + -(-n_bits // 512) + 1


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



def test_vqe_engine_on_a_mesh_of_one_card(dev):
    """Mesh([cuda] * 4): the observable's terms in four slices, the energy
    within 1e-12 and the gradient within 1e-10 of the one-device engine;
    one K13 launch (and slice sum) a shard for each H psi, the forward and
    the sweep once."""
    import symmer_torch
    from symmer_torch import PauliwordOp, QuantumState, config
    from symmer_torch.evolution import device_vqe
    from symmer_torch.parallel.mesh import Mesh

    rng = np.random.default_rng(4)
    n = 12
    H = PauliwordOp.random(n, 200, density=0.4).cleanup()
    H.coeff_vec = H.coeff_vec.real.astype(complex)
    gens = PauliwordOp.random(n, 16, density=0.3).cleanup()
    keep = np.any(gens.symp_matrix, axis=1)
    gens = PauliwordOp.from_planes(gens.x_pack[keep], gens.z_pack[keep],
                                   np.ones(int(keep.sum())), n)
    ref = QuantumState.random(n, 3).normalize
    x = rng.normal(size=gens.n_terms)
    old = config.device
    try:
        config.device = dev
        one = device_vqe.DeviceVQEEngine(H, gens, ref)
        e1, g1 = one.loss(x), one.gradient(x)
        with symmer_torch.use_mesh(mesh=Mesh([dev] * 4)):
            eng = device_vqe.DeviceVQEEngine(H, gens, ref)
        cuda.reset_launches()
        eN, gN = eng.loss(x), eng.gradient(x)
        counts = dict(cuda.launches)
    finally:
        config.device = old
    assert eng.mesh is not None and len(eng._H) == 4
    assert abs(eN - e1) <= 1e-12 and np.abs(gN - g1).max() <= 1e-10
    per_hpsi = 4 * (1 + (cuda._matvec_slices(1 << n, 1) > 1))
    assert counts["group_matvec"] == 2 * per_hpsi
    assert counts["vqe_rotate"] == 2 and counts["vqe_adjoint"] == 2


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


# -- the mesh slice: K16 (route_rows), K12's assignment ranges, a mesh of
# shards of one card ------------------------------------------------------

def route_buffers(rows, W, dev):
    return [(torch.full((rows, W), -7, dtype=torch.int64, device=dev),
             torch.full((rows, W), -7, dtype=torch.int64, device=dev),
             torch.full((rows,), -7.0, dtype=torch.float64, device=dev),
             torch.full((rows,), -7.0, dtype=torch.float64, device=dev)) for _ in range(2)]


# one row, one 256-row chunk and its edge, several chunks a block, many
# blocks (the tile grows past 256 rows), all kept, all sent, wide rows
@pytest.mark.parametrize("n,W,mode", [
    (1, 1, "mixed"), (255, 2, "mixed"), (257, 16, "mixed"), (5000, 16, "mixed"),
    (50_000, 16, "mixed"), (300_000, 3, "mixed"), (4096, 16, "keep"), (4096, 16, "send"),
    (700, 200, "mixed")])
def test_route_rows_equals_plain(dev, n, W, mode):
    rng = np.random.default_rng(n + W)
    x = torch.tensor(rng.integers(-2**62, 2**62, (n, W)), device=dev)
    z = torch.tensor(rng.integers(-2**62, 2**62, (n, W)), device=dev)
    cr = torch.tensor(rng.normal(size=n), device=dev)
    ci = torch.tensor(rng.normal(size=n), device=dev)
    key = torch.tensor(rng.integers(-2**62, 2**62, n), device=dev)
    k, bit = 2, 1
    if mode != "mixed":
        key = (key & ~(1 << k)) | ((bit if mode == "keep" else 1 - bit) << k)
    before = cuda.launches["route_rows"]
    got = route_buffers(n + 3, W, dev)
    counts = cuda.route_rows(x, z, cr, ci, key, k, bit, *got)
    again = route_buffers(n + 3, W, dev)
    counts2 = cuda.route_rows(x, z, cr, ci, key, k, bit, *again)
    want = [tuple(t.cpu() for t in side) for side in route_buffers(n + 3, W, "cpu")]
    want_counts = torch_core.route_rows(x.cpu(), z.cpu(), cr.cpu(), ci.cpu(), key.cpu(), k, bit,
                                        *want)
    torch.cuda.synchronize()
    assert cuda.launches["route_rows"] == before + 2  # one launch a call
    assert counts.tolist() == counts2.tolist() == want_counts.tolist()
    for side_got, side_again, side_want in zip(got, again, want):
        for a, b, c in zip(side_got, side_again, side_want):
            assert torch.equal(a.cpu().view(torch.int64) if a.dtype == torch.float64 else a.cpu(),
                               c.view(torch.int64) if c.dtype == torch.float64 else c)
            assert torch.equal(a, b)


def test_route_rows_many_calls_share_the_look_back_scratch(dev):
    """Calls in a row on one stream reuse the status words under a new epoch
    each (no reset between them), growing the scratch where a call needs
    more tiles; every call equals the plain version."""
    rng = np.random.default_rng(5)
    cuda._look_back_scratch.clear()
    for n in [3000, 200_000, 17, 3000, 1_000_000, 256, 257] * 4:
        x = torch.tensor(rng.integers(-2**62, 2**62, (n, 2)), device=dev)
        cr = torch.tensor(rng.normal(size=n), device=dev)
        key = torch.tensor(rng.integers(-2**62, 2**62, n), device=dev)
        got = route_buffers(n, 2, dev)
        counts = cuda.route_rows(x, x, cr, cr, key, 7, 0, *got)
        want = [tuple(t.cpu() for t in side) for side in route_buffers(n, 2, "cpu")]
        want_counts = torch_core.route_rows(x.cpu(), x.cpu(), cr.cpu(), cr.cpu(), key.cpu(), 7, 0,
                                            *want)
        assert counts.tolist() == want_counts.tolist()
        for side_got, side_want in zip(got, want):
            for a, c in zip(side_got, side_want):
                assert torch.equal(a.cpu().view(torch.int64) if a.dtype == torch.float64
                                   else a.cpu(),
                                   c.view(torch.int64) if c.dtype == torch.float64 else c)


def test_route_rows_empty_and_refusals(dev):
    e = torch.empty((0, 4), dtype=torch.int64, device=dev)
    r = torch.empty(0, dtype=torch.float64, device=dev)
    before = cuda.launches["route_rows"]
    bufs = route_buffers(4, 4, dev)
    assert cuda.route_rows(e, e, r, r, e[:, 0], 0, 0, *bufs).tolist() == [0, 0]
    assert cuda.launches["route_rows"] == before  # nothing launched
    x = torch.zeros((8, 4), dtype=torch.int64, device=dev)
    c = torch.zeros(8, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="overlaps"):
        cuda.route_rows(x, x, c, c, x[:, 0].contiguous(), 0, 0, (x, x.clone(), c.clone(),
                                                                  c.clone()), bufs[1])
    with pytest.raises(ValueError, match="fewer"):
        cuda.route_rows(x, x, c, c, x[:, 0].contiguous(), 0, 0, *route_buffers(7, 4, dev))


@pytest.mark.parametrize("M,n_free,n_cliques,parts", [
    (300, 14, 2, 4), (2048, 16, 3, 4), (100, 20, 1, 8), (40, 9, 2, 3), (64, 3, 1, 8)])
def test_brute_force_ranges_equal_plain_and_the_full_search(dev, M, n_free, n_cliques, parts):
    """K12 over ranges of the assignments (a mesh's split, aligned and not
    to the kernel's 2^n_lo blocks): each range's result equals the plain
    version's over it (within 1e-12; the index unless a near-tie), and the
    minimum of the ranges' minima is the full launch's, bit for bit."""
    rng = np.random.default_rng(M + n_free)
    g, b, off, nc = search(rng, M, n_free, n_cliques, dev)
    e_full, k_full = cuda.brute_force_minimise(g, b, off, n_free, nc)
    S = 1 << n_free
    best = []
    for s in range(parts):
        lo, hi = s * S // parts, (s + 1) * S // parts
        if lo == hi:
            continue
        e, k = cuda.brute_force_minimise(g, b, off, n_free, nc, start=lo, stop=hi)
        e2, k2 = torch_noncon.brute_force_plain(g, b, off, n_free, nc, start=lo, stop=hi)
        e, k, e2, k2 = float(e), int(k), float(e2), int(k2)
        assert lo <= k < hi and lo <= k2 < hi
        assert abs(e - e2) <= 1e-12 * max(1.0, abs(e2))
        if k != k2:
            assert abs(energy_at(g, b, off, n_free, k) - e2) <= 1e-12 * max(1.0, abs(e2))
        best.append((e, k))
    e, k = min(best)
    assert k == int(k_full) and np.float64(e).view(np.int64) == np.float64(
        float(e_full)).view(np.int64)
    with pytest.raises(ValueError, match="range"):
        cuda.brute_force_minimise(g, b, off, n_free, nc, start=3, stop=3)


def test_mesh_of_one_card_equals_one_device(dev):
    """Four shards of one card: the cleanup, the product, a rotation and the
    taper projection through the public API equal the one-device route
    (term sets, 1e-12 relative), with route_rows, anticommutes and
    clifford_scan launched on the mesh's path."""
    import symmer_torch
    from symmer_torch import PauliwordOp, QubitTapering, config
    from symmer_torch.parallel.mesh import Mesh
    from symmer_torch.profiling import kernel_stats

    old = (config.backend, config.device, config.mesh_threshold)
    config.backend, config.device, config.mesh_threshold = "device", dev, 64
    try:
        rng = np.random.default_rng(0)
        nq, T = 300, 4000
        xb = rng.integers(0, 2, (T, nq)).astype(bool)
        for k in range(2):
            par = xb[:, k * 150:(k + 1) * 150].sum(axis=1) & 1
            xb[par == 1, k * 150] ^= True
        H = PauliwordOp(np.hstack([xb, rng.integers(0, 2, (T, nq)).astype(bool)]),
                        rng.normal(size=T) + 1j * rng.normal(size=T))
        idx = rng.integers(0, T, 3 * T)
        D = PauliwordOp.from_planes(H.x_pack[idx], H.z_pack[idx], rng.normal(size=3 * T), nq)
        rot = PauliwordOp.from_planes(H.x_pack[:1], H.z_pack[:1], [1.0], nq)
        flows = {"cleanup": lambda: D.cleanup(), "multiply": lambda: H[:40] * H[:300],
                 "perform_rotations": lambda: H.perform_rotations([(rot, 0.3)]),
                 "clifford_rotate_project": lambda: QubitTapering(H).taper_it(
                     ref_state=np.zeros(nq, dtype=int))}
        for kind, flow in flows.items():
            single = flow()
            cuda.reset_launches()
            kernel_stats.reset()
            with symmer_torch.use_mesh(mesh=Mesh([dev] * 4)):
                sharded = flow()
            torch.cuda.synchronize()
            assert kernel_stats.mesh_calls[kind] == 1, kind
            assert cuda.launches["route_rows"] > 0, kind
            d1, d2 = single.to_dictionary, sharded.to_dictionary
            assert set(d1) == set(d2), kind
            assert all(abs(d1[t] - d2[t]) <= 1e-12 * max(abs(d1[t]), abs(d2[t])) for t in d1)
        assert cuda.launches["anticommutes"] > 0 and cuda.launches["clifford_scan"] > 0
    finally:
        config.backend, config.device, config.mesh_threshold = old


# -- K4 (pair_products) and K3 (merge_groups) ----------------------------------

def bits(t):
    return t.view(torch.int64) if t.is_floating_point() else t


def product_operands(rng, M1, M2, W, dev):
    x1, z1 = (torch.tensor(rng.integers(-2**63, 2**63 - 1, (M1, W), endpoint=True), device=dev)
              for _ in range(2))
    x2, z2 = (torch.tensor(rng.integers(-2**63, 2**63 - 1, (M2, W), endpoint=True), device=dev)
              for _ in range(2))
    c = [torch.tensor(rng.normal(size=m), device=dev) for m in (M1, M1, M2, M2)]
    if M1 > 2:
        x1[2], z1[2] = x1[0], z1[0]  # a repeated row: products that fall together
        c[0][0], c[1][0] = 0.0, -0.0
    return x1, z1, c[0], c[1], x2, z2, c[2], c[3]


@pytest.mark.parametrize("M1,M2,W", [(1, 1, 1), (9, 7, 3), (500, 500, 16), (1, 3000, 2),
                                     (3000, 1, 1), (33, 1025, 17), (70, 40, 40), (2, 5, 0)])
def test_pair_products_bitwise(dev, M1, M2, W):
    """K4 bit for bit its plain version on the CPU and on the card, and on a
    second launch; one launch a call.  Tiles narrower than 32 operand-2 rows,
    wider (one operand-1 row), words past a chunk, rows of no words."""
    ops = product_operands(np.random.default_rng(M1 + M2 + W), M1, M2, W, dev)
    before = cuda.launches["pair_products"]
    got, again = cuda.pair_products(*ops), cuda.pair_products(*ops)
    on_card = torch_core.pair_products(*ops)
    want = torch_core.pair_products(*(t.cpu() for t in ops))
    torch.cuda.synchronize()
    assert cuda.launches["pair_products"] == before + 2
    for g, a, c, w in zip(got, again, on_card, want):
        assert g.shape == (M1 * M2,) and g.is_contiguous()
        assert torch.equal(bits(g).cpu(), bits(w)) and torch.equal(bits(g), bits(a))
        assert torch.equal(bits(g), bits(c))


def test_pair_products_empty_and_refusals(dev):
    x1, z1, cr1, ci1, x2, z2, cr2, ci2 = product_operands(np.random.default_rng(1), 4, 3, 2, dev)
    before = cuda.launches["pair_products"]
    out = cuda.pair_products(x1[:0], z1[:0], cr1[:0], ci1[:0], x2, z2, cr2, ci2)
    assert all(t.shape == (0,) for t in out)
    assert cuda.launches["pair_products"] == before  # nothing launched
    with pytest.raises(TypeError, match="dtype"):
        cuda.pair_products(x1.to(torch.int32), z1, cr1, ci1, x2, z2, cr2, ci2)
    with pytest.raises(ValueError, match="disagree"):
        cuda.pair_products(x1, z1, cr1, ci1, x2[:, :1].contiguous(), z2[:, :1].contiguous(),
                           cr2, ci2)
    with pytest.raises(ValueError, match="expected"):
        cuda.pair_products(x1, z1, cr1, ci1, x2.cpu(), z2, cr2, ci2)


def merge_inputs(rng, T, W, uniq, long_group, dev):
    base = rng.integers(-2**62, 2**62, (uniq, 2, W))
    idx = rng.integers(0, uniq, T)
    idx[:long_group] = 0
    c = rng.normal(size=(2, T))
    c[:, rng.random(T) < 0.1] = 0.0
    if T > 4:  # one group of two rows, a row of its own, that cancels exactly
        base = np.concatenate([base, rng.integers(-2**62, 2**62, (1, 2, W))])
        idx[-2:] = uniq
        c[:, -1] = -c[:, -2]
    x, z = (torch.tensor(base[idx, k], device=dev) for k in (0, 1))
    return x, z, torch.tensor(c[0], device=dev), torch.tensor(c[1], device=dev)


def on_cpu(t):
    return t.cpu() if torch.is_tensor(t) else t


def parent_merge_cpu(ka, kb, cr, ci, th, rows, live=None):
    """The parent's merge on the CPU: the plain version after _lexsort's sort
    by (ka, kb)."""
    ka, kb = ka.cpu(), kb.cpu()
    perm = torch_core._lexsort(ka, kb)
    return torch_core.merge_groups(perm, ka[perm], ka, kb, cr.cpu(), ci.cpu(), th,
                                   tuple(t.cpu() for t in rows), on_cpu(live), False)


def same_merge(dev, ka, kb, cr, ci, th, rows, live=None):
    """K3 on K17's sorted keys: bit for bit its plain version on the CPU
    (after the CPU's sort), the parent's output (the plain version after
    _lexsort) and a second launch, within 1e-12 relative of the card's plain
    version (torch's CUDA segment_reduce may add in another order); two
    launches a call (one where nothing survives); the same bits after the
    repair's sort by (ka, kb) (lexsort_keys: K17 twice, equal to _lexsort)
    with the check off."""
    perm, kas = cuda.sort_keys(ka)
    before = cuda.launches["merge_groups"]
    got = cuda.merge_groups(perm, kas, ka, kb, cr, ci, th, rows, live)
    again = cuda.merge_groups(perm, kas, ka, kb, cr, ci, th, rows, live)
    lex, lex_kas = torch_core.lexsort_keys(ka, kb)
    by_both = cuda.merge_groups(lex, lex_kas, ka, kb, cr, ci, th, rows, live, False)
    card = torch_core.merge_groups(perm, kas, ka, kb, cr, ci, th, rows, live)
    cpu_perm, cpu_kas = torch_core.sort_keys(ka.cpu())
    want = torch_core.merge_groups(cpu_perm, cpu_kas, ka.cpu(), kb.cpu(), cr.cpu(), ci.cpu(), th,
                                   tuple(t.cpu() for t in rows), on_cpu(live))
    parent = parent_merge_cpu(ka, kb, cr, ci, th, rows, live)
    torch.cuda.synchronize()
    assert torch.equal(lex.long().cpu(), torch_core._lexsort(ka.cpu(), kb.cpu()))
    n = want[0].shape[0]
    assert cuda.launches["merge_groups"] == before + (6 if n else 3)
    for g, a, l, w, p in zip(got, again, by_both, want, parent):
        assert g.device == perm.device and g.is_contiguous()
        assert torch.equal(bits(g).cpu(), bits(w)) and torch.equal(bits(g), bits(a))
        assert torch.equal(bits(l), bits(g)) and torch.equal(bits(w), bits(p))
    for k in (0, 1, 4):
        assert torch.equal(got[k], card[k])
    for k in (2, 3):
        assert torch.all((got[k] - card[k]).abs() <= 1e-12 * card[k].abs().clamp_min(1e-300))
    return got


@pytest.mark.parametrize("T,W,uniq,long_group,th", [
    (1, 1, 1, 0, 1e-12), (2000, 16, 300, 0, 1e-12), (2000, 16, 300, 0, None),
    (5000, 2, 50, 1500, 1e-12), (200_000, 16, 150_000, 0, 1e-12), (70_000, 1, 60_000, 0, None),
    (3000, 40, 200, 0, 0.5), (600, 0, 1, 0, None)])
def test_merge_groups_bitwise(dev, T, W, uniq, long_group, th):
    """Groups longer than a block (1,500 rows of one term), groups that
    cancel exactly, exact zeros kept under zero_threshold=None, the
    flagship's 200,000 x 16 words, one row, rows of no words."""
    x, z, cr, ci = merge_inputs(np.random.default_rng(T + W), T, W, uniq, long_group, dev)
    ka, kb = cuda.row_signature(x, z)
    same_merge(dev, ka, kb, cr, ci, th, (x, z))


@pytest.mark.parametrize("L,T", [(31, 600), (32, 600), (33, 600), (288, 900), (289, 900),
                                 (320, 320), (100_000, 200_000)])
def test_merge_groups_long_group_edges(dev, L, T):
    """One group of exactly L rows scattered over T (its head's thread sums
    32 rows, its warp the rest, 256 sorted positions a load): a group that
    ends at the thread's share, one row past it, at a warp load's edge and
    one past it, at the input's end, and 100,000 rows; every other row is
    its own group."""
    rng = np.random.default_rng(L)
    rows = rng.integers(-2**62, 2**62, (T, 2, 16))
    pick = rng.permutation(T)[:L]
    rows[pick] = rows[pick[0]]
    x, z = (torch.tensor(rows[:, k], device=dev) for k in (0, 1))
    c = rng.normal(size=(2, T))
    cr, ci = torch.tensor(c[0], device=dev), torch.tensor(c[1], device=dev)
    ka, kb = cuda.row_signature(x, z)
    got = same_merge(dev, ka, kb, cr, ci, 1e-12, (x, z))
    assert got[0].shape[0] == T - L + 1


@pytest.mark.parametrize("M1,M2,W,th", [(500, 500, 16, 1e-12), (30, 20, 3, None),
                                        (1, 900, 1, 1e-12), (200, 1, 17, None)])
def test_merge_groups_pair_rows(dev, monkeypatch, M1, M2, W, th):
    """The survivors' rows rebuilt from their pairs, bit for bit the plain
    version on the CPU; mul_pairs_cleanup on the large route (cuda.SMALL_ROWS
    set to 0) makes one K4 launch and K3's two."""
    monkeypatch.setattr(cuda, "SMALL_ROWS", 0)
    ops = product_operands(np.random.default_rng(M1 * M2), M1, M2, W, dev)
    ka, kb, pr, pi = cuda.pair_products(*ops)
    same_merge(dev, ka, kb, pr, pi, th,
               (ops[0], ops[1], ops[4], ops[5]))
    cuda.reset_launches()
    got = torch_core.mul_pairs_cleanup(*ops, th)
    want = torch_core.mul_pairs_cleanup(*(t.cpu() for t in ops), th)
    torch.cuda.synchronize()
    assert cuda.launches["pair_products"] == 1 and cuda.launches["merge_groups"] == 2
    assert cuda.launches["row_signature"] == 0 and cuda.sort_repairs == 0
    assert cuda.launches["sort_keys"] == sort_launches(M1 * M2)
    for g, w in zip(got, want):
        assert torch.equal(bits(g).cpu(), bits(w))


def test_merge_groups_all_cancelled_and_empty(dev):
    """Every group cancels: pass A only, empty outputs; no rows: no launch."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.integers(-2**62, 2**62, (50, 3)), device=dev)
    c = torch.tensor(rng.normal(size=50), device=dev)
    X, C = torch.cat([x, x]), torch.cat([c, -c])
    ka, kb = cuda.row_signature(X, X)
    got = same_merge(dev, ka, kb, C, C, 1e-12, (X, X))
    assert got[0].shape == (0, 3) and got[4].shape == (0,)
    e = X[:0]
    before = dict(cuda.launches)
    perm, kas = cuda.sort_keys(e[:, 0])
    assert perm.shape == (0,) and perm.dtype == torch.int32 and kas.shape == (0,)
    out = cuda.merge_groups(perm, kas, e[:, 0], e[:, 0], C[:0], C[:0], None, (e, e))
    assert out[0].shape == (0, 3) and out[2].shape == (0,)
    assert cuda.launches == before


def test_merge_groups_refusals(dev):
    x = torch.zeros((8, 2), dtype=torch.int64, device=dev)
    k = torch.zeros(8, dtype=torch.int64, device=dev)
    p = torch.zeros(8, dtype=torch.int32, device=dev)
    c = torch.zeros(8, dtype=torch.float64, device=dev)
    with pytest.raises(TypeError, match="dtype"):
        cuda.merge_groups(p, k, k, k, c.float(), c, None, (x, x))
    with pytest.raises(TypeError, match="dtype"):  # perm is K17's int32
        cuda.merge_groups(k, k, k, k, c, c, None, (x, x))
    with pytest.raises(ValueError, match="disagree"):
        cuda.merge_groups(p, k, k, k, c, c, None, (x[:7], x[:7]))
    with pytest.raises(ValueError, match="disagree"):
        cuda.merge_groups(p, k[:7], k, k, c, c, None, (x, x))
    with pytest.raises(ValueError, match="disagree"):
        cuda.merge_groups(p, k, k, k, c, c, None, (x[:4], x[:4], x[:3], x[:3]))
    with pytest.raises(ValueError, match="expected"):
        cuda.merge_groups(p, k, k.cpu(), k, c, c, None, (x, x))


# -- K17 (sort_keys): the cleanup's sort, and the repair of a split run -------

def sort_launches(T):
    """K17's launches for T keys: none for one, one up to 4,096, else three
    (the histograms, the partition on the split digit, the buckets)."""
    return 0 if T <= 1 else 1 if T <= 4096 else 3


def sort_keys_case(rng, T, kind, dev):
    """T int64 keys on dev: "random" (full range, a third repeating
    others), "hash" (full range), "equal" (one key), "extremes" (INT64_MIN,
    INT64_MAX, -1, 0 and 1 only), "negative" (all below 0, few distinct),
    "small" (below 2^24: the top five digits constant); hash keys skewed,
    with u = key ^ 2^63: "big_bucket" (a third of them with top byte 0x42,
    a bucket past a block's shared memory above ~12,000 keys), "group500"
    (one key 500 times), "cap" / "cap_past" (exactly 64 / 65 keys with top
    bytes 0x42, 0x17: a sub-range at the comparison's cap and one past it)."""
    if kind == "equal":
        keys = np.full(T, -5, np.int64)
    elif kind == "extremes":
        keys = rng.choice(np.array([-2**63, 2**63 - 1, -1, 0, 1], np.int64), T)
    elif kind == "negative":
        keys = -rng.integers(1, 50, T)
    elif kind == "small":
        keys = rng.integers(0, 2**24, T)
    else:
        keys = rng.integers(-2**63, 2**63 - 1, T, endpoint=True)
        u = keys.view(np.uint64) ^ np.uint64(1 << 63)
        if kind == "random":
            again = rng.random(T) < 0.3
            keys[again] = keys[rng.integers(0, T, int(again.sum()))]
        elif kind == "big_bucket":
            pick = rng.random(T) < 1 / 3
            u[pick] = (u[pick] & np.uint64(2**56 - 1)) | np.uint64(0x42 << 56)
        elif kind == "group500":
            u[rng.permutation(T)[:min(500, T // 2)]] = u[0]
        elif kind in ("cap", "cap_past"):
            u[(u >> np.uint64(48)) == np.uint64(0x4217)] += np.uint64(1 << 48)
            pick = rng.permutation(T)[:64 + (kind == "cap_past")]
            u[pick] = (u[pick] & np.uint64(2**48 - 1)) | np.uint64(0x4217 << 48)
        if kind != "random":
            keys = (u ^ np.uint64(1 << 63)).view(np.int64)
    return torch.tensor(keys, device=dev)


def same_sort(keys):
    """K17 bit for bit its plain version on the card and on the CPU
    (torch.argsort(stable=True) and the gather), and on a second launch;
    its launches a call."""
    before = cuda.launches["sort_keys"]
    perm, out = cuda.sort_keys(keys)
    again = cuda.sort_keys(keys)
    card = torch_core.sort_keys(keys)
    want = torch_core.sort_keys(keys.cpu())
    torch.cuda.synchronize()
    T = keys.shape[0]
    assert cuda.launches["sort_keys"] == before + 2 * sort_launches(T)
    assert perm.dtype == torch.int32 and perm.shape == (T,) and out.shape == (T,)
    for g, a, c, w in zip((perm, out), again, card, want):
        assert torch.equal(g.cpu(), w) and torch.equal(g, a) and torch.equal(g, c)
    return perm, out


SORT_KINDS = ["random", "equal", "extremes", "negative", "hash", "small", "big_bucket",
              "group500", "cap", "cap_past"]


@pytest.mark.parametrize("T", [1, 2, 31, 4095, 4096, 4097, 6144, 6145, 50_000, 200_000,
                               250_000, 1_162_560])
@pytest.mark.parametrize("kind", SORT_KINDS)
def test_sort_keys_bitwise(dev, T, kind):
    """K17 bit for bit torch.argsort(stable=True) (perm and sorted keys) at
    one key, the one-block route's edge (4,096) and one past it, a
    partition tile's edge (6,144 = 3 x 2,048) and one past it, a shard's
    50,000, the flagship's 200,000, the square's 250,000 pairs and the
    chain's 1,162,560 slots (its buckets on chip at 6,144 keys a block);
    random keys, all keys equal, the int64 extremes (the sign flip of the
    top digit), negative keys in long runs, hash keys, small integers (the
    split digit below the top), and the skewed kinds (a bucket through
    global memory, a long group of equal keys, a sub-range at the
    comparison's cap and one past it)."""
    same_sort(sort_keys_case(np.random.default_rng(T), T, kind, dev))


@pytest.mark.parametrize("T,kind", [(2**23, "hash"), (2**21, "big_bucket"),
                                    (3_000_000, "extremes")])
def test_sort_keys_large_and_skewed(dev, T, kind):
    """K17 bit for bit at 2^23 hash keys (buckets of ~32,768 keys, through
    global memory), 2^21 keys a third of them in one bucket and 3,000,000
    extremes (one bucket of 0 and 1, three of equal keys)."""
    same_sort(sort_keys_case(np.random.default_rng(T), T, kind, dev))


@pytest.mark.parametrize("T", [4096, 200_000, 1_162_560])
@pytest.mark.parametrize("kind", ["hash", "big_bucket"])
def test_sort_keys_no_host_sync(dev, T, kind):
    """K17 makes no host synchronisation on either route (one block, and
    the partition and buckets): torch's sync debug mode raises on one torch
    makes, and a CUDA graph's capture fails on any, the library's own
    included; the graph's replay sorts as a call does."""
    keys = sort_keys_case(np.random.default_rng(T), T, kind, dev)
    want = torch_core.sort_keys(keys.cpu())
    cuda.sort_keys(keys)  # the library's build and the allocator's first blocks
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        perm, out = cuda.sort_keys(keys)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(perm.cpu(), want[0]) and torch.equal(out.cpu(), want[1])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        perm, out = cuda.sort_keys(keys)
    perm.zero_()
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(perm.cpu(), want[0]) and torch.equal(out.cpu(), want[1])


@pytest.mark.parametrize("T", [16_385, 50_000, 131_073, 600_000])
def test_sort_keys_repeated_over_seeds(dev, T):
    """K17 bit for bit torch.sort(stable=True) over 24 seeds of hash and
    random keys, each sorted four times back to back, from nine partition
    tiles (16,385 keys) to 600,000 keys: each call draws its tiles'
    tickets, and waits in its look-back, in another order."""
    for seed in range(24):
        rng = np.random.default_rng([T, seed])
        keys = sort_keys_case(rng, T, "hash" if seed % 2 else "random", dev)
        want = torch.sort(keys, stable=True)
        outs = [cuda.sort_keys(keys) for _ in range(4)]
        for perm, out in outs:
            assert torch.equal(perm.long(), want.indices), f"perm differs, seed {seed}"
            assert torch.equal(out, want.values), f"keys differ, seed {seed}"


def test_sort_keys_empty_and_refusals(dev):
    k = torch.arange(10, device=dev)
    before = dict(cuda.launches)
    perm, out = cuda.sort_keys(k[:0])
    assert perm.shape == (0,) and perm.dtype == torch.int32 and out.shape == (0,)
    perm, out = cuda.sort_keys(k[3:4])
    assert perm.tolist() == [0] and out.tolist() == [3]
    assert cuda.launches == before
    with pytest.raises(TypeError, match="dtype"):
        cuda.sort_keys(k.int())
    with pytest.raises(ValueError, match="not contiguous"):
        cuda.sort_keys(k[::2])


def forge_first_key(monkeypatch, name):
    """cuda.<name> (K2, K4, K6 or K7) with its first output, ka, cut to its
    top four bits: many signatures share ka (a forged 64-bit collision)."""
    real = getattr(cuda, name)

    def forged(*args):
        out = real(*args)
        return ((out[0] >> 60) << 60,) + tuple(out[1:])

    monkeypatch.setattr(cuda, name, forged)


def composite_cases(dev, T=20_000, M1=120, M2=90):
    """(name, its key wrapper, the composite, its arguments, the parent's
    composition on the CPU: its key kernel's plain version, _lexsort, the
    plain merge, its slots) of each of the four composites: by default at a
    size past one block (T rows, a rotation's 2 T slots, M1 x M2 pairs)."""
    rng = np.random.default_rng(17)
    x, z, cr, ci = merge_inputs(rng, T, 16, 3 * T // 4, 300, dev)
    ops = product_operands(rng, M1, M2, 3, dev)
    rot = rotation_operands(rng, T, 16, dev)
    proj = (x, z, cr, ci, *(words_on(rng, (2, 16), dev) for _ in range(2)),
            torch.tensor([1, 3], device=dev), *stabilizers(rng, 16, 4, dev),
            *(words_on(rng, (16,), dev) for _ in range(3)))

    def parent_cleanup(th):
        ka, kb = torch_core.row_signature(x.cpu(), z.cpu())
        return parent_merge_cpu(ka, kb, cr, ci, th, (x, z))[:4]

    def parent_product(th):
        cpu = [t.cpu() for t in ops]
        ka, kb, pr, pi = torch_core.pair_products(*cpu)
        return parent_merge_cpu(ka, kb, pr, pi, th, (cpu[0], cpu[1], cpu[4], cpu[5]))[:4]

    def parent_rotation(th):
        cpu = [on_cpu(t) for t in rot]
        ka, kb, pr, pi, live = torch_core.rotation_rows(*cpu)
        return parent_merge_cpu(ka, kb, pr, pi, th, tuple(cpu[0:2] + cpu[4:6]), live)[:4]

    def parent_projection(th):
        cpu = [t.cpu() for t in proj]
        px, pz, pcr, pci = torch_core.clifford_scan(*cpu[:7])
        ac = torch_core.anticommutes(px, pz, cpu[7], cpu[8])
        ka, kb, pr, pi, live = torch_core.project_rows(px, pz, pcr, pci, ac, *cpu[9:12])
        return parent_merge_cpu(ka, kb, pr, pi, th, (px, pz, cpu[11]), live)[:4]

    return [("cleanup", "row_signature", torch_core.cleanup_sorted, (x, z, cr, ci),
             parent_cleanup, T),
            ("product", "pair_products", torch_core.mul_pairs_cleanup, ops, parent_product,
             M1 * M2),
            ("rotation", "rotation_rows", torch_core.rotate_nonclifford_cleanup, rot,
             parent_rotation, 2 * T),
            ("projection", "project_rows", torch_core.clifford_project_cleanup, proj,
             parent_projection, T)]


@pytest.mark.parametrize("which", ["cleanup", "product", "rotation", "projection"])
@pytest.mark.parametrize("forge", [False, True])
def test_composites_equal_the_parent_composition(dev, monkeypatch, which, forge):
    """Each composite on the card, on the large route (cuda.SMALL_ROWS set to
    0; these sizes are past it anyway), bit for bit a copy of the parent's
    composition (its key kernel, _lexsort, the merge) on the CPU; one K17
    call (launches: sort_launches) and no torch.argsort, torch.sort or
    _lexsort on the card.  With ka forged to collide, K3 reports the split
    run and the repair (K17 twice more, K3 again without the check) gives
    the same bits, counted once in cuda.sort_repairs."""
    name, key_fn, fn, args, parent, T = next(c for c in composite_cases(dev) if c[0] == which)
    monkeypatch.setattr(cuda, "SMALL_ROWS", 0)
    th = 1e-12
    want = parent(th)
    for mod, attr in ((torch, "argsort"), (torch, "sort"), (torch_core, "_lexsort")):
        real = getattr(mod, attr)

        def refuse(*a, real=real, **k):
            assert not any(torch.is_tensor(t) and t.is_cuda for t in a), "a torch sort on the card"
            return real(*a, **k)

        monkeypatch.setattr(mod, attr, refuse)
    if forge:
        forge_first_key(monkeypatch, key_fn)
    cuda.reset_launches()
    got = fn(*args, th)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(bits(g).cpu(), bits(w))
    assert cuda.sort_repairs == int(forge)
    assert cuda.launches["sort_keys"] == (3 if forge else 1) * sort_launches(T)
    assert cuda.launches["merge_groups"] == (3 if forge else 2)


# -- K6 (rotation_rows), K7 (project_rows) and K3 with live flags -------------

def words_on(rng, shape, dev, offset=False):
    """Random int64 words of `shape` on dev; offset: a contiguous view 8
    bytes past a 16-byte boundary."""
    n = int(np.prod(shape))
    flat = torch.tensor(rng.integers(-2**63, 2**63 - 1, n + 1, endpoint=True), device=dev)
    return (flat[1:] if offset else flat[:n]).view(shape)


def rotation_operands(rng, T, W, dev, kind="mixed", offset=False):
    """(x, z, cr, ci, xr, zr, cos_t, sin_t): "mixed" (about half anticommute,
    a term equal to another's P Q row, exact zeros and -0.0), "none" (Q the
    identity) or "all" (every term anticommutes)."""
    x, z = words_on(rng, (T, W), dev, offset), words_on(rng, (T, W), dev, offset)
    xr, zr = words_on(rng, (W,), dev), words_on(rng, (W,), dev)
    c = torch.tensor(rng.normal(size=(2, T)), device=dev)
    if kind == "none":
        xr.zero_()
        zr.zero_()
    if T > 5:
        x[5], z[5] = x[4] ^ xr, z[4] ^ zr
        c[:, 2] = torch.tensor([0.0, -0.0])
    if kind == "all":
        w = int(torch.nonzero((zr & ~xr) != 0)[0])
        word = zr[w] & ~xr[w]
        ac = torch_core.anticommutes_single(x, z, xr, zr)
        x[~ac, w] ^= word & -word
    return x, z, c[0].contiguous(), c[1].contiguous(), xr, zr, 0.6, 0.8


@pytest.mark.parametrize("T,W,kind,offset", [
    (1, 1, "mixed", False), (33, 3, "mixed", False), (1000, 16, "mixed", False),
    (1000, 16, "mixed", True), (100_000, 16, "mixed", False), (100_000, 16, "none", False),
    (100_000, 16, "all", False), (2000, 1, "mixed", False), (500, 17, "all", False),
    (300, 80, "mixed", False), (64, 0, "none", False)])
def test_rotation_rows_bitwise(dev, T, W, kind, offset):
    """K6 bit for bit its plain version on the CPU and on the card, and on a
    second launch; one launch a call.  One row, 16-byte units and single
    words, planes off a 16-byte boundary, more units than a warp's lanes
    (80 words), rows of no words; no term, every term and about half the
    terms anticommuting."""
    ops = rotation_operands(np.random.default_rng(T + W), T, W, dev, kind, offset)
    before = cuda.launches["rotation_rows"]
    got, again = cuda.rotation_rows(*ops), cuda.rotation_rows(*ops)
    on_card = torch_core.rotation_rows(*ops)
    want = torch_core.rotation_rows(*(t.cpu() if torch.is_tensor(t) else t for t in ops))
    torch.cuda.synchronize()
    assert cuda.launches["rotation_rows"] == before + 2
    for g, a, c, w in zip(got, again, on_card, want):
        assert g.shape == (2 * T,) and g.is_contiguous()
        assert torch.equal(bits(g).cpu(), bits(w)) and torch.equal(bits(g), bits(a))
        assert torch.equal(bits(g), bits(c))
    n_ac = int(got[4][T:].sum())
    assert n_ac == {"none": 0, "all": T}.get(kind, n_ac)


def stabilizers(rng, W, S, dev):
    """S single-qubit stabilizers (X and Z in turn) on random qubits."""
    sx = torch.zeros((S, W), dtype=torch.int64, device=dev)
    sz = torch.zeros_like(sx)
    for s in range(S):
        q = int(rng.integers(0, 64 * W))
        (sz if s % 2 else sx)[s, q // 64] = (1 << (q % 64)) - (1 << 64 if q % 64 == 63 else 0)
    return sx, sz


def project_operands(rng, T, W, S, dev, offset=False):
    """(x, z, cr, ci, ac, neg_x, neg_z, col_keep): random rows and masks, ac
    K1's output against S stabilizers (bool[T, S]), coefficient (0.0, -0.0)
    first."""
    x, z = words_on(rng, (T, W), dev, offset), words_on(rng, (T, W), dev, offset)
    c = torch.tensor(rng.normal(size=(2, T)), device=dev)
    c[:, :1] = 0.0
    c[1, :1] = -0.0
    ac = cuda.anticommutes(x, z, *stabilizers(rng, W, S, dev))
    masks = [words_on(rng, (W,), dev) for _ in range(3)]
    return (x, z, c[0].contiguous(), c[1].contiguous(), ac, *masks)


@pytest.mark.parametrize("T,W,S,offset", [(1, 1, 1, False), (33, 3, 4, False),
                                          (200_000, 16, 4, False), (1000, 16, 4, True),
                                          (2000, 1, 2, False), (500, 17, 40, False),
                                          (300, 80, 3, False), (400, 2, 0, False),
                                          (64, 0, 0, False)])
def test_project_rows_bitwise(dev, T, W, S, offset):
    """K7 bit for bit its plain version on the CPU and on the card, and on a
    second launch; one launch a call.  The flagship's 200,000 x 16 words and
    4 stabilizers, planes off a 16-byte boundary, no stabilizer, more
    stabilizers than a row's lanes, more units than a warp's lanes."""
    ops = project_operands(np.random.default_rng(T + W + S), T, W, S, dev, offset)
    before = cuda.launches["project_rows"]
    got, again = cuda.project_rows(*ops), cuda.project_rows(*ops)
    on_card = torch_core.project_rows(*ops)
    want = torch_core.project_rows(*(t.cpu() for t in ops))
    torch.cuda.synchronize()
    assert cuda.launches["project_rows"] == before + 2
    for g, a, c, w in zip(got, again, on_card, want):
        assert g.shape == (T,) and g.is_contiguous()
        assert torch.equal(bits(g).cpu(), bits(w)) and torch.equal(bits(g), bits(a))
        assert torch.equal(bits(g), bits(c))


def test_rotation_and_project_rows_empty_and_refusals(dev):
    rng = np.random.default_rng(2)
    x, z, cr, ci, xr, zr, ct, st = rotation_operands(rng, 8, 2, dev)
    ac = torch.zeros((8, 3), dtype=torch.bool, device=dev)
    before = dict(cuda.launches)
    out = cuda.rotation_rows(x[:0], z[:0], cr[:0], ci[:0], xr, zr, ct, st)
    assert all(t.shape == (0,) for t in out)
    out = cuda.project_rows(x[:0], z[:0], cr[:0], ci[:0], ac[:0], xr, zr, xr)
    assert all(t.shape == (0,) for t in out)
    assert cuda.launches == before  # nothing launched
    with pytest.raises(TypeError, match="dtype"):
        cuda.rotation_rows(x.to(torch.int32), z, cr, ci, xr, zr, ct, st)
    with pytest.raises(ValueError, match="disagree"):
        cuda.rotation_rows(x, z, cr, ci, xr[:1].contiguous(), zr[:1].contiguous(), ct, st)
    with pytest.raises(ValueError, match="expected"):
        cuda.rotation_rows(x, z, cr, ci, xr.cpu(), zr, ct, st)
    with pytest.raises(TypeError, match="dtype"):
        cuda.project_rows(x, z, cr, ci, ac.to(torch.uint8), xr, zr, xr)
    with pytest.raises(ValueError, match="disagree"):
        cuda.project_rows(x, z, cr, ci, ac[:7], xr, zr, xr)
    with pytest.raises(ValueError, match="not contiguous"):
        cuda.project_rows(x, z, cr, ci, ac[:, ::2], xr, zr, xr)
    k = torch.zeros(16, dtype=torch.int64, device=dev)
    p = torch.zeros(16, dtype=torch.int32, device=dev)
    c = torch.zeros(16, dtype=torch.float64, device=dev)
    live = torch.ones(16, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="disagree"):  # a rotation source holds 2 T rows
        cuda.merge_groups(p, k, k, k, c, c, None, (x[:7], z[:7], xr, zr), live)
    with pytest.raises(TypeError, match="dtype"):
        cuda.merge_groups(p, k, k, k, c, c, None, (x, z, xr, zr), live.to(torch.uint8))
    with pytest.raises(ValueError, match="disagree"):
        cuda.merge_groups(p[:8], k[:8], k[:8], k[:8], c[:8], c[:8], None, (x, z, xr), live)


@pytest.mark.parametrize("T,W,kind,th", [(1, 1, "mixed", 1e-12), (2000, 3, "mixed", None),
                                         (100_000, 16, "mixed", 1e-12),
                                         (100_000, 16, "none", 1e-12), (5000, 16, "all", None)])
def test_merge_groups_rotation_rows(dev, monkeypatch, T, W, kind, th):
    """K3 on K6's slots: the live flags and the rotation's row source (the
    P Q rows rebuilt from x ^ xr), bit for bit the plain version on the
    CPU; rotate_nonclifford_cleanup on the large route (cuda.SMALL_ROWS set
    to 0) launches K6 once, K3 twice and no K2."""
    monkeypatch.setattr(cuda, "SMALL_ROWS", 0)
    ops = rotation_operands(np.random.default_rng(3 * T + W), T, W, dev, kind)
    ka, kb, pr, pi, live = cuda.rotation_rows(*ops)
    same_merge(dev, ka, kb, pr, pi, th, ops[0:2] + ops[4:6], live)
    want = torch_core.rotate_nonclifford_cleanup(
        *(t.cpu() if torch.is_tensor(t) else t for t in ops), th)
    cuda.reset_launches()
    got = torch_core.rotate_nonclifford_cleanup(*ops, th)
    torch.cuda.synchronize()
    assert cuda.launches["rotation_rows"] == 1 and cuda.launches["merge_groups"] == 2
    assert cuda.launches["row_signature"] == 0 and cuda.sort_repairs == 0
    assert cuda.launches["sort_keys"] == sort_launches(2 * T)
    for g, w in zip(got, want):
        assert torch.equal(bits(g).cpu(), bits(w))


@pytest.mark.parametrize("T,W,S,th", [(1, 1, 1, 1e-12), (3000, 3, 4, None),
                                      (200_000, 16, 4, 1e-12), (2000, 2, 0, 1e-12)])
def test_merge_groups_masked_rows(dev, monkeypatch, T, W, S, th):
    """K3 on K7's slots: the live flags and the masked row source, bit for
    bit the plain version on the CPU (a tenth of the rows repeat another
    row but for masked bits: dead and live rows in one group);
    clifford_project_cleanup on the large route (cuda.SMALL_ROWS set to 0)
    launches K5, K1 (none without stabilizers) and K7 once, K3 twice (once
    where nothing survives) and no K2."""
    monkeypatch.setattr(cuda, "SMALL_ROWS", 0)
    rng = np.random.default_rng(T + S)
    x, z, cr, ci, _, neg_x, neg_z, col_keep = project_operands(rng, T, W, 0, dev)
    col_keep[0] = 0x0F0F0F0F0F0F0F0F
    n = T // 10
    x[T - n:], z[T - n:] = x[:n] ^ 0x10, z[:n]  # equal once masked
    sx, sz = stabilizers(rng, W, S, dev)
    ac = cuda.anticommutes(x, z, sx, sz)
    ka, kb, pr, pi, live = cuda.project_rows(x, z, cr, ci, ac, neg_x, neg_z, col_keep)
    same_merge(dev, ka, kb, pr, pi, th, (x, z, col_keep), live)
    rx, rz = words_on(rng, (3, W), dev), words_on(rng, (3, W), dev)
    args = (x, z, cr, ci, rx, rz, torch.tensor([1, 2, 3], device=dev), sx, sz, neg_x, neg_z,
            col_keep)
    want = torch_core.clifford_project_cleanup(*(t.cpu() for t in args), th)
    cuda.reset_launches()
    got = torch_core.clifford_project_cleanup(*args, th)
    torch.cuda.synchronize()
    assert cuda.launches["project_rows"] == 1 and cuda.launches["merge_groups"] in (1, 2)
    assert cuda.launches["clifford_scan"] == 1 and cuda.launches["row_signature"] == 0
    assert cuda.launches["anticommutes"] == (1 if S else 0)
    assert cuda.launches["sort_keys"] == sort_launches(T) and cuda.sort_repairs == 0
    for g, w in zip(got, want):
        assert torch.equal(bits(g).cpu(), bits(w))


@pytest.mark.parametrize("L,dead", [(32, "head"), (33, "first_32"), (288, "first_32"),
                                    (289, "first_288"), (289, "all"), (100_000, "head")])
def test_merge_groups_live_long_group_edges(dev, L, dead):
    """One group of L rows scattered over 2 L + 300 (its head's thread sums
    32 rows, its warp the rest) whose dead rows are its head, its first 32
    or 288 in input order, or all of it (no output), among rows of which a
    third are dead; K3 with these live flags held as without them."""
    rng = np.random.default_rng(L + len(dead))
    T = 2 * L + 300
    rows = rng.integers(-2**62, 2**62, (T, 2, 16))
    pick = np.sort(rng.permutation(T)[:L])
    rows[pick] = rows[pick[0]]
    x, z = (torch.tensor(rows[:, k], device=dev) for k in (0, 1))
    c = rng.normal(size=(2, T))
    cr, ci = torch.tensor(c[0], device=dev), torch.tensor(c[1], device=dev)
    live = rng.random(T) < 0.67
    live[pick] = True
    live[pick[:{"head": 1, "first_32": 32, "first_288": 288, "all": L}[dead]]] = False
    others = np.ones(T, bool)
    others[pick] = False
    n = int(live[others].sum()) + (dead != "all")  # every other row is its own group
    live = torch.tensor(live, device=dev)
    ka, kb = cuda.row_signature(x, z)
    got = same_merge(dev, ka, kb, cr, ci, 1e-12, (x, z), live)
    assert got[0].shape[0] == n


def test_merge_groups_dead_rows_only(dev):
    """Every row dead: pass A only, empty outputs."""
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.integers(-2**62, 2**62, (500, 3)), device=dev)
    c = torch.tensor(rng.normal(size=500), device=dev)
    ka, kb = cuda.row_signature(x, x)
    live = torch.zeros(500, dtype=torch.bool, device=dev)
    got = same_merge(dev, ka, kb, c, c, None, (x, x), live)
    assert got[0].shape == (0, 3)


def test_cleanup_reads_the_host_once(dev):
    """A device cleanup_sorted, mul_pairs_cleanup, rotate_nonclifford_cleanup
    and clifford_project_cleanup synchronise with the host once each (K3's
    survivor count); the product allocates no product planes."""
    rng = np.random.default_rng(8)
    x, z, cr, ci = merge_inputs(rng, 20_000, 16, 15_000, 0, dev)
    ops = product_operands(rng, 500, 500, 16, dev)
    torch_core.cleanup_sorted(x, z, cr, ci, 1e-12)  # warm: the library and the allocator
    torch_core.mul_pairs_cleanup(*ops, 1e-12)
    torch.cuda.synchronize()
    import warnings

    rot = rotation_operands(rng, 20_000, 16, dev)
    proj = (x, z, cr, ci, *(words_on(rng, (2, 16), dev) for _ in range(2)),
            torch.tensor([1, 3], device=dev), *stabilizers(rng, 16, 4, dev),
            *(words_on(rng, (16,), dev) for _ in range(3)))
    torch_core.rotate_nonclifford_cleanup(*rot, 1e-12)
    torch_core.clifford_project_cleanup(*proj, 1e-12)
    for fn in (lambda: torch_core.cleanup_sorted(x, z, cr, ci, 1e-12),
               lambda: torch_core.mul_pairs_cleanup(*ops, 1e-12),
               lambda: torch_core.rotate_nonclifford_cleanup(*rot, 1e-12),
               lambda: torch_core.clifford_project_cleanup(*proj, 1e-12)):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        syncs = [w for w in seen if "synchroniz" in str(w.message)]
        assert len(syncs) == 1, [str(w.message) for w in syncs]
    # 500 x 500 pairs of rows drawn from 8 rows each: at most 64 survivors, so
    # the peak is the pairs' keys, coefficients, sort and flags, far below
    # the product planes' 64 MB
    x1, z1, cr1, ci1, x2, z2, cr2, ci2 = ops
    pick = torch.from_numpy(rng.integers(0, 8, 500)).to(dev)
    ops = (x1[pick], z1[pick], cr1, ci1, x2[pick], z2[pick], cr2, ci2)
    torch_core.mul_pairs_cleanup(*ops, 1e-12)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = torch_core.mul_pairs_cleanup(*ops, 1e-12)
    torch.cuda.synchronize()
    assert out[0].shape[0] <= 64
    assert torch.cuda.max_memory_allocated() - base < 2 * 500 * 500 * 16 * 8 // 2


# -- K3's one-block route (merge_small) ----------------------------------------

def small_case(rng, shape, dev):
    """(ka, kb, cr, ci, threshold, rows, live) of a merge_small shape on dev:
    the CS-VQE flows' 1 x 1 and 67 x 1 products (pairs), a 631-row
    projection against 4 stabilizers (masked, live flags), tapered N2's
    2,229 x 1 word and 4,096 x 16 words (planes), one group of 4,096 slots,
    4,096 slots whose pairs cancel under 0.5, a 1,000-term rotation's 2,000
    slots (rotation, live flags) and 4,096 rows of no words."""
    if shape in ("product_1x1", "product_67x1"):
        ops = product_operands(rng, 1 if shape == "product_1x1" else 67, 1, 1, dev)
        return (*cuda.pair_products(*ops), 1e-12, (ops[0], ops[1], ops[4], ops[5]), None)
    if shape == "projection_631":
        ops = project_operands(rng, 631, 1, 4, dev)
        ka, kb, pr, pi, live = cuda.project_rows(*ops)
        return ka, kb, pr, pi, 1e-12, (ops[0], ops[1], ops[7]), live
    if shape == "rotation_1000":
        ops = rotation_operands(rng, 1000, 16, dev)
        ka, kb, pr, pi, live = cuda.rotation_rows(*ops)
        return ka, kb, pr, pi, 1e-12, ops[0:2] + ops[4:6], live
    if shape == "one_group_4096":
        x = words_on(rng, (1, 16), dev).expand(4096, 16).contiguous()
        c = torch.tensor(rng.normal(size=(2, 4096)), device=dev)
        return (*cuda.row_signature(x, x), c[0].contiguous(), c[1].contiguous(), 1e-12, (x, x),
                None)
    if shape == "cancelling_4096":
        x = words_on(rng, (2048, 16), dev).repeat(2, 1)
        c = torch.tensor(rng.normal(size=(2, 2048)), device=dev)
        c = torch.cat([c, -c], dim=1)
        return (*cuda.row_signature(x, x), c[0].contiguous(), c[1].contiguous(), 0.5, (x, x),
                None)
    T, W, uniq = {"cleanup_2229x1": (2229, 1, 1700), "cleanup_4096x16": (4096, 16, 3000),
                  "cleanup_4096x0": (4096, 0, 1)}[shape]
    x, z, cr, ci = merge_inputs(rng, T, W, uniq, 0, dev)
    return (*cuda.row_signature(x, z), cr, ci, None if W == 0 else 1e-12, (x, z), None)


SMALL_SHAPES = ["product_1x1", "product_67x1", "projection_631", "cleanup_2229x1",
                "cleanup_4096x16", "one_group_4096", "cancelling_4096", "rotation_1000",
                "cleanup_4096x0"]


@pytest.mark.parametrize("shape", SMALL_SHAPES)
def test_merge_small_bitwise(dev, shape):
    """merge_small bit for bit its plain version on the CPU, the parent's
    composition (_lexsort, the plain merge) and a second launch, its
    integers equal to the plain version's on the card and its sums within
    1e-12 relative (torch's CUDA segment_reduce may add in another order),
    and bit for bit the large route (K17, K3's two passes) on the card; one
    launch a call and no other kernel."""
    ka, kb, cr, ci, th, rows, live = small_case(np.random.default_rng(len(shape)), shape, dev)
    args = (ka, kb, cr, ci, th, rows, live)
    torch.cuda.synchronize()
    cuda.reset_launches()
    got, again = cuda.merge_small(*args), cuda.merge_small(*args)
    torch.cuda.synchronize()
    assert cuda.launches["merge_small"] == 2 and sum(cuda.launches.values()) == 2
    card = torch_core.merge_small(*args)
    want = torch_core.merge_small(ka.cpu(), kb.cpu(), cr.cpu(), ci.cpu(), th,
                                  tuple(t.cpu() for t in rows), on_cpu(live))
    parent = parent_merge_cpu(ka, kb, cr, ci, th, rows, live)
    perm, kas = cuda.sort_keys(ka)
    large = cuda.merge_groups(perm, kas, ka, kb, cr, ci, th, rows, live)
    if large is None:
        large = cuda.merge_groups(*torch_core.lexsort_keys(ka, kb), ka, kb, cr, ci, th, rows,
                                  live, False)
    torch.cuda.synchronize()
    for g, a, w, p, b in zip(got, again, want, parent, large):
        assert g.device == ka.device and g.is_contiguous()
        assert torch.equal(bits(g).cpu(), bits(w)) and torch.equal(bits(g), bits(a))
        assert torch.equal(bits(w), bits(p)) and torch.equal(bits(g), bits(b))
    for k in (0, 1, 4):
        assert torch.equal(got[k], card[k])
    for k in (2, 3):
        assert torch.all((got[k] - card[k]).abs() <= 1e-12 * card[k].abs().clamp_min(1e-300))
    n = got[0].shape[0]
    if shape == "one_group_4096":
        assert n == 1
    if shape == "cancelling_4096":
        assert n == 0


@pytest.mark.parametrize("which", ["cleanup", "product", "rotation", "projection"])
@pytest.mark.parametrize("forge", [False, True])
def test_merge_small_composites(dev, monkeypatch, which, forge):
    """Each composite under cuda.SMALL_ROWS slots (2,000 rows, 60 x 60 pairs,
    4,000 rotation slots), the fused route off (cuda.FUSED_WORDS set to -1),
    bit for bit a copy of the parent's composition on the CPU, through one
    merge_small launch and no K17 or K3 pass, no torch sort on the card and
    one host synchronisation; with ka forged to collide, the same bits and
    no repair."""
    import warnings

    monkeypatch.setattr(cuda, "FUSED_WORDS", -1)

    name, key_fn, fn, args, parent, T = next(
        c for c in composite_cases(dev, 2000, 60, 60) if c[0] == which)
    assert T <= cuda.SMALL_ROWS
    th = 1e-12
    want = parent(th)
    fn(*args, th)  # warm: the library and the allocator
    for mod, attr in ((torch, "argsort"), (torch, "sort"), (torch_core, "_lexsort")):
        real = getattr(mod, attr)

        def refuse(*a, real=real, **k):
            assert not any(torch.is_tensor(t) and t.is_cuda for t in a), "a torch sort on the card"
            return real(*a, **k)

        monkeypatch.setattr(mod, attr, refuse)
    if forge:
        forge_first_key(monkeypatch, key_fn)
    torch.cuda.synchronize()
    cuda.reset_launches()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            got = fn(*args, th)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(bits(g).cpu(), bits(w))
    assert cuda.sort_repairs == 0
    assert cuda.launches["merge_small"] == 1 and cuda.calls["merge_small"] == 1
    assert cuda.launches["sort_keys"] == 0 and cuda.launches["merge_groups"] == 0
    assert len([w for w in seen if "synchroniz" in str(w.message)]) == 1


@pytest.mark.parametrize("T", [4096, 4097])
def test_merge_small_route_edge(dev, monkeypatch, T):
    """A cleanup of 4,096 rows outside the fused route (cuda.FUSED_WORDS set
    to -1) takes the one-block route (one merge_small launch); 4,097 the
    large route (K17's three launches, K3's two); both bit for bit the
    parent's composition on the CPU."""
    monkeypatch.setattr(cuda, "FUSED_WORDS", -1)
    rng = np.random.default_rng(T)
    x, z, cr, ci = merge_inputs(rng, T, 16, 3000, 0, dev)
    ka, kb = torch_core.row_signature(x.cpu(), z.cpu())
    want = parent_merge_cpu(ka, kb, cr, ci, 1e-12, (x, z))[:4]
    cuda.reset_launches()
    got = torch_core.cleanup_sorted(x, z, cr, ci, 1e-12)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(bits(g).cpu(), bits(w))
    small = T <= cuda.SMALL_ROWS
    assert cuda.launches["merge_small"] == int(small)
    assert cuda.launches["sort_keys"] == (0 if small else sort_launches(T))
    assert cuda.launches["merge_groups"] == (0 if small else 2)


def test_merge_small_empty_and_refusals(dev):
    x = torch.zeros((8, 2), dtype=torch.int64, device=dev)
    k = torch.zeros(8, dtype=torch.int64, device=dev)
    c = torch.zeros(8, dtype=torch.float64, device=dev)
    before = dict(cuda.launches)
    out = cuda.merge_small(k[:0], k[:0], c[:0], c[:0], None, (x[:0], x[:0]))
    assert out[0].shape == (0, 2) and out[2].shape == (0,) and out[4].shape == (0,)
    assert cuda.launches == before
    big = torch.zeros((4097, 2), dtype=torch.int64, device=dev)
    kk, cc = big[:, 0].contiguous(), torch.zeros(4097, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="at most 4096"):
        cuda.merge_small(kk, kk, cc, cc, None, (big, big))
    with pytest.raises(TypeError, match="dtype"):
        cuda.merge_small(k, k, c.float(), c, None, (x, x))
    with pytest.raises(ValueError, match="disagree"):
        cuda.merge_small(k, k[:7], c, c, None, (x, x))
    with pytest.raises(ValueError, match="disagree"):
        cuda.merge_small(k, k, c, c, None, (x[:7], x[:7]))
    with pytest.raises(TypeError, match="dtype"):
        cuda.merge_small(k, k, c, c, None, (x, x), torch.ones(8, dtype=torch.uint8, device=dev))
    with pytest.raises(ValueError, match="expected"):
        cuda.merge_small(k, k.cpu(), c, c, None, (x, x))


# -- the fused route (cleanup_small, product_small: merge_small.cu signing) ---

def fused_case(rng, shape, dev):
    """(kind, operands) of a fused-route shape on dev: the CS-VQE flows' 1 x
    1 and 67 x 1 products, tapered N2's 2,229 x 1-word cleanup (rows
    repeating), 2-word rows, 16-word rows at the budget's edge
    (cuda.FUSED_WORDS / 16 rows) and one past it, a product of 60 x 60
    pairs, rows of 40 words (lanes take words past 32; one row signed by one
    block, 3 x 2 pairs by the cluster), 4,096 rows of one
    and of no words, one group of 300 rows, pairs that cancel."""
    edge = min(cuda.SMALL_ROWS, cuda.FUSED_WORDS // 16)
    if shape.startswith("product"):
        M1, M2, W = {"product_1x1": (1, 1, 1), "product_67x1": (67, 1, 1),
                     "product_60x60x2": (60, 60, 2), "product_3x2x40": (3, 2, 40),
                     "product_cancel": (40, 3, 16)}[shape]
        ops = product_operands(rng, M1, M2, W, dev)
        if shape == "product_cancel":  # operand 1's rows 20-39 its rows 0-19, negated
            for t, sign in zip(ops[:4], (1, 1, -1, -1)):
                t[20:] = sign * t[:20]
        return "product", ops
    T, W, uniq = {"cleanup_2229x1": (2229, 1, 1700), "cleanup_1000x2": (1000, 2, 400),
                  "cleanup_edge": (edge, 16, edge), "cleanup_past": (edge + 1, 16, edge),
                  "cleanup_1x40": (1, 40, 1), "cleanup_4096x1": (4096, 1, 3000),
                  "cleanup_4096x0": (4096, 0, 1), "cleanup_one_group": (300, 4, 1)}[shape]
    return "cleanup", merge_inputs(rng, T, W, uniq, 300 if shape.endswith("group") else 0, dev)


FUSED_SHAPES = ["product_1x1", "product_67x1", "product_60x60x2", "product_3x2x40",
                "product_cancel", "cleanup_2229x1", "cleanup_1000x2", "cleanup_edge",
                "cleanup_past", "cleanup_1x40", "cleanup_4096x1", "cleanup_4096x0",
                "cleanup_one_group"]


@pytest.mark.parametrize("shape", FUSED_SHAPES)
@pytest.mark.parametrize("th", [None, 0.5])
def test_fused_route_bitwise(dev, shape, th):
    """cleanup_small / product_small bit for bit their plain version on the
    CPU, the two launches they replace on the card (K2 or K4, then
    merge_small) and a second launch, their integers equal to the plain
    version's on the card and their sums within 1e-12 relative; one launch
    a call and no other kernel; one block signing (the 1 x 1 product, a row
    of 40 words) and the cluster (more than kSignRounds rounds of one
    block's lane groups)."""
    kind, ops = fused_case(np.random.default_rng(len(shape)), shape, dev)
    wrapper = cuda.cleanup_small if kind == "cleanup" else cuda.product_small
    plain = torch_core.cleanup_small if kind == "cleanup" else torch_core.product_small
    torch.cuda.synchronize()
    cuda.reset_launches()
    got, again = wrapper(*ops, th), wrapper(*ops, th)
    torch.cuda.synchronize()
    assert cuda.launches["sign_merge_small"] == 2 and sum(cuda.launches.values()) == 2
    assert cuda.calls["sign_merge_small"] == 2
    if kind == "cleanup":
        two = cuda.merge_small(*cuda.row_signature(ops[0], ops[1]), ops[2], ops[3], th, ops[:2])
    else:
        two = cuda.merge_small(*cuda.pair_products(*ops), th, (ops[0], ops[1], ops[4], ops[5]))
    card = plain(*ops, th)
    want = plain(*(t.cpu() for t in ops), th)
    torch.cuda.synchronize()
    for g, a, w, q in zip(got, again, want, two):
        assert g.device == ops[0].device and g.is_contiguous()
        assert torch.equal(bits(g).cpu(), bits(w)) and torch.equal(bits(g), bits(a))
        assert torch.equal(bits(g), bits(q))
    for k in (0, 1, 4):
        assert torch.equal(got[k], card[k])
    for k in (2, 3):
        assert torch.all((got[k] - card[k]).abs() <= 1e-12 * card[k].abs().clamp_min(1e-300))
    if shape == "cleanup_one_group" and th is None:  # 298 rows of one term, a cancelling pair
        assert got[0].shape[0] == 2 and torch.equal(got[0][0], ops[0][0])


@pytest.mark.parametrize("which", ["cleanup", "keyed", "product"])
def test_fused_route_composites(dev, which):
    """cleanup_sorted, cleanup_keyed and mul_pairs_cleanup within
    cuda.small_fused (2,000 rows of 2 words, 60 x 60 pairs of 2 words): one
    sign_merge_small launch, no K2, K4, K17 or K3 launch of their own, one
    host synchronisation, bit for bit the CPU device's (the plain route)."""
    import warnings

    rng = np.random.default_rng(3)
    if which == "product":
        ops = product_operands(rng, 60, 60, 2, dev)
        fn = lambda *a: torch_core.mul_pairs_cleanup(*a, 1e-12)
    else:
        ops = merge_inputs(rng, 2000, 2, 700, 0, dev)
        fn = lambda *a: (torch_core.cleanup_keyed if which == "keyed"
                         else torch_core.cleanup_sorted)(*a, 1e-12)
    T = ops[0].shape[0] * (ops[4].shape[0] if which == "product" else 1)
    assert cuda.small_fused(T, ops[0].shape[1])
    want = fn(*(t.cpu() for t in ops))
    fn(*ops)  # warm: the library and the allocator
    torch.cuda.synchronize()
    cuda.reset_launches()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            got = fn(*ops)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(bits(g).cpu(), bits(w))
    assert cuda.launches == {**dict.fromkeys(cuda.launches, 0), "sign_merge_small": 1}
    assert len([w for w in seen if "synchroniz" in str(w.message)]) == 1


def test_fused_route_empty_and_refusals(dev):
    x1, z1, cr1, ci1, x2, z2, cr2, ci2 = product_operands(np.random.default_rng(1), 4, 3, 2, dev)
    before = dict(cuda.launches)
    out = cuda.product_small(x1[:0], z1[:0], cr1[:0], ci1[:0], x2, z2, cr2, ci2, None)
    assert out[0].shape == (0, 2) and out[2].shape == (0,) and out[4].shape == (0,)
    out = cuda.cleanup_small(x1[:0], z1[:0], cr1[:0], ci1[:0], 1e-12)
    assert out[0].shape == (0, 2) and out[4].shape == (0,)
    assert cuda.launches == before
    big = torch.zeros((4097, 1), dtype=torch.int64, device=dev)
    cc = torch.zeros(4097, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="at most 4096"):
        cuda.cleanup_small(big, big, cc, cc, None)
    with pytest.raises(ValueError, match="at most 4096"):
        cuda.product_small(big, big, cc, cc, x2[:1, :1].contiguous(), z2[:1, :1].contiguous(),
                           cr2[:1], ci2[:1], None)
    with pytest.raises(TypeError, match="dtype"):
        cuda.cleanup_small(x1, z1, cr1.float(), ci1, None)
    with pytest.raises(ValueError, match="disagree"):
        cuda.cleanup_small(x1, z1[:3], cr1, ci1, None)
    with pytest.raises(ValueError, match="disagree"):
        cuda.product_small(x1, z1, cr1, ci1, x2[:, :1].contiguous(), z2[:, :1].contiguous(),
                           cr2, ci2, None)
    with pytest.raises(ValueError, match="expected"):
        cuda.product_small(x1, z1, cr1, ci1, x2.cpu(), z2, cr2, ci2, None)
