"""The arithmetic of the hand kernels (symmer_torch/csrc), rehearsed on the CPU.

The CUDA kernels run only on a card.  Each test here keeps a numpy model of
what a kernel computes, step by step as the kernel does it, and holds the
model against the reference implementations:

  - anticommutes.cu, square regime: the AND-popcount product
    ([x1|z1] . [z2|x2]^T) & 1 in 256-bit k-steps (4 words, zero-padded W),
    x half then z half into one s32 sum, as the binary tensor-core mma runs
    it;
  - anticommutes.cu, tall-skinny regime: lanes that each XOR-accumulate a
    share of a row's words, fold the accumulators into one bit per op2 row
    and XOR-reduce the bit masks across the lanes of a row (the shuffles);
    the tiles of whole rows that the persistent blocks stream through their
    ring of stages (sizes, bulk-copy alignment, the mbarrier phases);
  - clifford_scan.cu: the running y = popc(x & z) mod 4, the rotation's y
    computed once, the anticommutation test and the product's sign from two
    XOR accumulators, and the tile staging index arithmetic;
  - state_expval.cu: the walk of each thread over a flattened pair index,
    the unordered row pairs of the "pairs" route, the GF(2)-linear row
    hash, the open-addressing table (a tiny one that collides, rows that
    share their low hash bits) and both routes' sums over X-part groups;
  - noncon_brute.cu: the bitmask parity popc(kk & gmask) & 1 with the fixed
    parity in bit 31, the sign fold that makes each segment's sum a plain
    Walsh-Hadamard transform, the split transform (buckets by F's low bits,
    butterflies, direct sums for small segments), the (min, argmin) with
    ties to the smaller index, and the choice of the split width;
  - group_diag.cu: the passes of torch_lanczos.fwht_passes, each block's
    tile of points and neighbouring columns, the scatter of the sorted
    terms found by binary search, and the butterfly index of each stage,
    bit for bit against dense.fwht_rows / dense.group_diagonals;
  - lanczos_matvec.cu: the rows of a thread that share one popcount per
    term, the sign flips by z's bits, the group slices at term counts and
    their partial sums added in slice order;
  - lanczos_step.cu: the cut of each sum into chunks, warp shuffles, warp
    sums and runs of chunk sums, bit for bit the pairwise tree.

The references: np_core.anticommutes, the Pallas kernel in interpret mode
(pallas_gf2.anticommutes_tiled) and jx_core.anticommutes; torch_core and
jx_core.clifford_scan, bit for bit, signed zeros included; state_core.expval
and jx_state.expval (within 1e-12 relative); jx_noncon's float parity matmul
(exactly) and its brute-force (min, argmin); symmer_tpu's dense.fwht_rows and
group_diagonals (bit for bit) and its dense matrix (the matvec, within 1e-14
relative).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax import lax

from symmer_tpu.kernels import jx_core, jx_noncon, jx_state, np_core, pack, state_core
from symmer_tpu.kernels.pallas_gf2 import anticommutes_tiled
from symmer_torch.kernels import torch_core, torch_noncon, torch_state

K_STEP_WORDS = 4  # 256 bits: the k depth of mma.m16n8k256 .b1
# the tall-skinny kernel's constants (csrc/anticommutes.cu)
TALL_THREADS, TALL_MAX_W, TILE_WORDS, STAGES = 256, 64, 512, 2


def planes(rng, rows, n_qubits, density=0.5):
    return pack.pack_bits(rng.random((rows, n_qubits)) < density, n_qubits)


def tt(a):
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    return torch.from_numpy(a.copy())


def jj(a):
    return jnp.asarray(pack.to_u32(np.ascontiguousarray(a, np.uint64)))


def popc(a):
    return np.bitwise_count(a).astype(np.int64)


# -- anticommutes: square regime ------------------------------------------------

def and_popc_product(x1, z1, x2, z2):
    """The square regime's sum, k-step by k-step: int64[M1, M2] popcount sums.

    Each plane is zero-padded to whole 4-word k-steps; a k-step is 8 u32
    words, and s32[i, j] += popc(A_i & B_j) over them, first with
    (A, B) = (x1, z2), then (z1, x2), into the same sum."""
    W = x1.shape[1]
    Wp = -(-W // K_STEP_WORDS) * K_STEP_WORDS
    pad = lambda a: np.hstack([a, np.zeros((a.shape[0], Wp - W), np.uint64)])
    acc = np.zeros((x1.shape[0], x2.shape[0]), np.int64)
    for a_plane, b_plane in ((pad(x1), pad(z2)), (pad(z1), pad(x2))):
        a32, b32 = pack.to_u32(a_plane), pack.to_u32(b_plane)
        for k0 in range(0, 2 * Wp, 2 * K_STEP_WORDS):
            a, b = a32[:, k0:k0 + 8], b32[:, k0:k0 + 8]
            acc += popc(a[:, None, :] & b[None, :, :]).sum(-1)
    return acc


@pytest.mark.parametrize("m1,m2,n_qubits", [
    (40, 17, 1000), (33, 20, 1100), (17, 30, 64), (24, 40, 1), (20, 18, 257),
])
def test_and_popcount_product_matches_references(m1, m2, n_qubits):
    rng = np.random.default_rng(m1 * 100 + m2 + n_qubits)
    x1, z1 = planes(rng, m1, n_qubits), planes(rng, m1, n_qubits)
    x2, z2 = planes(rng, m2, n_qubits), planes(rng, m2, n_qubits)
    acc = and_popc_product(x1, z1, x2, z2)
    W = x1.shape[1]
    assert acc.max() <= 128 * W  # the s32 sum stays exact
    model = (acc & 1).astype(bool)
    assert np.array_equal(model, np_core.anticommutes(x1, z1, x2, z2))
    assert np.array_equal(model, np.asarray(anticommutes_tiled(jj(x1), jj(z1), jj(x2), jj(z2))))
    assert np.array_equal(model, np.asarray(jx_core.anticommutes(jj(x1), jj(z1), jj(x2), jj(z2))))
    assert np.array_equal(model, torch_core.anticommutes(tt(x1), tt(z1), tt(x2), tt(z2)).numpy())


def test_and_popcount_product_all_ones_reaches_its_largest_sum():
    """All-ones rows give the largest sum, 2 * n_qubits, still below 128 W."""
    n = 1100
    ones = pack.pack_bits(np.ones((3, n), bool), n)
    acc = and_popc_product(ones, ones, ones, ones)
    assert np.all(acc == 2 * n) and 2 * n <= 128 * ones.shape[1]
    assert np.array_equal((acc & 1).astype(bool), np_core.anticommutes(ones, ones, ones, ones))


# -- anticommutes: tall-skinny regime --------------------------------------------

def tall_model(x1, z1, x2, z2, vec):
    """The tall kernel: L lanes per row, lane `sub` takes chunks sub, sub+L, ...
    of vec words; per lane one XOR accumulator per op2 row, folded into a bit
    mask; the masks XOR-reduced over the row's lanes by xor-shuffles."""
    M1, W = x1.shape
    M2 = x2.shape[0]
    assert M2 <= 16 and W % vec == 0
    n_chunks = W // vec
    lanes_log2 = 0
    while (1 << lanes_log2) < n_chunks and lanes_log2 < 5:
        lanes_log2 += 1
    L = 1 << lanes_log2
    out = np.zeros((M1, M2), bool)
    for i in range(M1):
        bits = np.zeros(L, np.int64)
        for sub in range(L):
            acc = np.zeros(M2, np.uint64)
            for c in range(sub, n_chunks, L):
                for w in range(c * vec, (c + 1) * vec):
                    acc ^= (x1[i, w] & z2[:, w]) ^ (z1[i, w] & x2[:, w])
            bits[sub] = int(np.sum((popc(acc) & 1) << np.arange(M2)))
        o = L >> 1
        while o:  # __shfl_xor_sync: lane l takes lane l ^ o
            bits = bits ^ bits[np.arange(L) ^ o]
            o >>= 1
        assert np.all(bits == bits[0])  # every lane of the row holds the mask
        out[i] = (bits[0] >> np.arange(M2)) & 1
    return out


@pytest.mark.parametrize("m2", [1, 4, 15, 16])
@pytest.mark.parametrize("n_qubits,vec", [
    (1000, 2), (1000, 1), (64, 1), (2150, 2), (4200, 2), (4000, 1),
])
def test_tall_lane_reduction_matches_references(m2, n_qubits, vec):
    rng = np.random.default_rng(7 * m2 + n_qubits + vec)
    x1, z1 = planes(rng, 9, n_qubits), planes(rng, 9, n_qubits)
    x2, z2 = planes(rng, m2, n_qubits), planes(rng, m2, n_qubits)
    model = tall_model(x1, z1, x2, z2, vec)
    assert np.array_equal(model, np_core.anticommutes(x1, z1, x2, z2))
    assert np.array_equal(model, torch_core.anticommutes(tt(x1), tt(z1), tt(x2), tt(z2)).numpy())


def tall_tiling(W):
    """(lanes_log2, rows per block pass, tile rows R) as launch_tall picks them."""
    n_chunks = W // 2 if W % 2 == 0 else W
    lanes_log2 = 0
    while (1 << lanes_log2) < n_chunks and lanes_log2 < 5:
        lanes_log2 += 1
    per_pass = (TALL_THREADS // 32) * (32 >> lanes_log2)
    return lanes_log2, per_pass, TILE_WORDS // W // per_pass * per_pass


@pytest.mark.parametrize("m1", [1, 4, 31, 32, 1000, 4097])
@pytest.mark.parametrize("lanes_log2", [0, 3, 5])
@pytest.mark.parametrize("grid_warps", [1, 8, 64])
def test_tall_persistent_loop_visits_every_row_once(m1, lanes_log2, grid_warps):
    """Blocks (grid_warps of them) take tiles b, b + G, ...; the warps of a
    block take a tile's rows a pass at a time; each row of [0, M1) is written
    once.  The k-th tile of a block waits on stage k % STAGES at parity
    (k // STAGES) & 1, the phase its load completes."""
    W = 2 << lanes_log2  # n_chunks = 2^lanes_log2 16-byte chunks
    got_lg, per_pass, R = tall_tiling(W)
    assert got_lg == lanes_log2 and R % per_pass == 0
    rows_per_warp = 32 >> lanes_log2
    n_tiles = -(-m1 // R)
    seen = np.zeros(m1, np.int64)
    for b in range(grid_warps):
        mine = list(range(b, n_tiles, grid_warps))
        loads = [[] for _ in range(STAGES)]  # tiles loaded into each stage, in order
        for k, t in enumerate(mine):
            loads[k % STAGES].append(t)  # prologue (k < STAGES) or refill of stage k % STAGES
        for k, t in enumerate(mine):
            s = k % STAGES
            assert loads[s][k // STAGES] == t  # the (k // STAGES)-th phase of stage s
            for warp in range(TALL_THREADS // 32):
                for r0 in range(warp * rows_per_warp, R, (TALL_THREADS // 32) * rows_per_warp):
                    rows = t * R + r0 + np.arange(rows_per_warp)
                    seen[rows[rows < m1]] += 1
    assert np.all(seen == 1)


@pytest.mark.parametrize("W", range(1, TALL_MAX_W + 1))
def test_tall_tiles_fit_and_align(W):
    """Tiles are whole block passes and fit a stage; every tile starts 16-byte
    aligned (given aligned planes), and a tile's words split into whole
    16-byte bulk copies and at most one odd last word, on the last tile only."""
    _, per_pass, R = tall_tiling(W)
    assert R >= per_pass and R % per_pass == 0 and R * W <= TILE_WORDS
    for m1 in (1, R - 1, R, 3 * R + 1, 200_000):
        n_tiles = -(-m1 // R)
        for t in range(n_tiles):
            words = min(R, m1 - t * R) * W
            bulk = words & ~1
            assert (t * R * W * 8) % 16 == 0 and (bulk * 8) % 16 == 0
            assert words - bulk == (words & 1) and (words & 1 == 0 or t == n_tiles - 1)
    # shared memory: barriers, STAGES x 2 tiles, 2 x M2MAX op2 rows of up to 64 words
    smem = {m: 128 + 8 * (STAGES * 2 * TILE_WORDS + 2 * m * TALL_MAX_W) for m in (4, 8, 16)}
    assert smem[4] * 4 <= 227 * 1024 and smem[16] <= 227 * 1024


# -- clifford_scan ---------------------------------------------------------------

def i_pow(k, re, im):
    """(re, im) * i^k as the kernel's swaps and negations."""
    k = k & 3
    out_re = np.where(k == 0, re, np.where(k == 1, -im, np.where(k == 2, -re, im)))
    out_im = np.where(k == 0, im, np.where(k == 1, re, np.where(k == 2, -im, -re)))
    return out_re, out_im


def scan_model(x, z, cr, ci, rx, rz, rm):
    """The kernel's bookkeeping, vectorised over the terms."""
    x, z, re, im = x.copy(), z.copy(), cr.copy(), ci.copy()
    y = popc(x & z).sum(1) & 3              # running y mod 4
    y_rot = popc(rx & rz).sum(1) & 3        # once per rotation, while staging
    for k, m in enumerate(rm):
        m4 = int(m) % 4
        if m4 == 0:
            continue
        s1 = np.bitwise_xor.reduce(x & rz[k][None, :], axis=1)
        s2 = np.bitwise_xor.reduce(z & rx[k][None, :], axis=1)
        sgn = popc(s1) & 1                  # the product's sign: parity(s1)
        ac = (popc(s1 ^ s2) & 1).astype(bool)
        if m4 == 2:
            re, im = np.where(ac, -re, re), np.where(ac, -im, im)
            continue
        xo, zo = x ^ rx[k][None, :], z ^ rz[k][None, :]
        y_out = popc(xo & zo).sum(1)
        e = 3 * (y + y_rot[k]) + y_out + 2 * sgn + (3 if m4 == 1 else 1)
        nr, ni = i_pow(e, re, im)
        x = np.where(ac[:, None], xo, x)
        z = np.where(ac[:, None], zo, z)
        re, im = np.where(ac, nr, re), np.where(ac, ni, im)
        y = np.where(ac, y_out & 3, y)
    return x, z, re, im


@pytest.mark.parametrize("n_qubits", [1, 64, 130, 960, 1024])
@pytest.mark.parametrize("depth", [1, 4, 33])
def test_scan_bookkeeping_bitwise(n_qubits, depth):
    rng = np.random.default_rng(3 * n_qubits + depth)
    T = 150
    x, z = planes(rng, T, n_qubits), planes(rng, T, n_qubits)
    c = rng.normal(size=(2, T))
    c[:, :6] = [[0.0, -0.0, 0.0, -0.0, 2.0, -0.0], [-0.0, 0.0, 1.0, -1.0, -0.0, -0.0]]
    rx, rz = planes(rng, depth, n_qubits, 0.2), planes(rng, depth, n_qubits, 0.2)
    rm = rng.integers(-7, 8, depth)
    rm[0] = -1
    if depth > 2:
        rm[1], rm[2] = 0, -2
    got = scan_model(x, z, c[0], c[1], rx, rz, rm)
    want = torch_core.clifford_scan(tt(x), tt(z), tt(c[0]), tt(c[1]), tt(rx), tt(rz),
                                    torch.tensor(rm))
    jax_want = jx_core.clifford_scan(jj(x), jj(z), jnp.asarray(c[0]), jnp.asarray(c[1]),
                                     jj(rx), jj(rz), jnp.asarray(rm, jnp.int32))
    assert np.array_equal(got[0], want[0].numpy().view(np.uint64))
    assert np.array_equal(got[1], want[1].numpy().view(np.uint64))
    assert np.array_equal(got[0], pack.from_u32(np.asarray(jax_want[0])))
    for g, w, jw in zip(got[2:], want[2:], jax_want[2:]):
        assert np.array_equal(g.view(np.int64), w.numpy().view(np.int64))
        assert np.array_equal(g.view(np.int64), np.asarray(jw).view(np.int64))


@pytest.mark.parametrize("W", [1, 2, 3, 7, 15, 16])
@pytest.mark.parametrize("rows", [1, 77, 128])
def test_scan_tile_staging_indices(W, rows):
    """stage_rows / store_rows: thread t copies flat words t, t + 128, ...; its
    (row, column) is carried by adding (128 // W, 128 % W) with one carry."""
    threads, stride = 128, (16 if W > 8 else 8 if W > 4 else 4 if W > 2 else W) | 1
    hit = np.zeros(threads * stride, np.int64)
    for t in range(threads):
        r, c = divmod(t, W)
        for e in range(t, rows * W, threads):
            assert (r, c) == divmod(e, W)
            hit[r * stride + c] += 1
            r, c = r + threads // W, c + threads % W
            if c >= W:
                c, r = c - W, r + 1
    # every word of the tile once, at its row's odd stride
    want = np.zeros_like(hit)
    for r in range(rows):
        want[r * stride : r * stride + W] = 1
    assert np.array_equal(hit, want)
    # odd stride: the 16 threads of a half-warp reading word w of their rows
    # hit 16 distinct pairs of 4-byte banks
    banks = {(i * stride * 2) % 32 for i in range(16)}
    assert len(banks) == 16


# -- state_expval ------------------------------------------------------------------

def pair_walk(T, B, grid_threads):
    """The (t, b) each thread visits: start at its global id p, then step by
    the grid's thread count with t, b advanced by (stride // B, stride % B)
    and one carry, never a division per pair."""
    seen = []
    for p0 in range(grid_threads):
        if p0 >= T * B:
            continue
        t, b = divmod(p0, B)
        dt, db = divmod(grid_threads, B)
        p = p0
        while p < T * B:
            assert (t, b) == divmod(p, B)
            seen.append((t, b))
            b += db
            t += dt
            if b >= B:
                b -= B
                t += 1
            p += grid_threads
    return seen


@pytest.mark.parametrize("T,B,grid_threads", [(1, 1, 1024), (7, 3, 4), (5, 13, 9), (40, 3, 17)])
def test_expval_pair_walk_visits_every_pair_once(T, B, grid_threads):
    seen = pair_walk(T, B, grid_threads)
    assert sorted(seen) == [(t, b) for t in range(T) for b in range(B)]


def row_pairs(B):
    """The unordered row pairs of the "pairs" route: flat p = d B + b over
    p < B (B + 1) / 2, b2 = (b + d) mod B."""
    return [(p % B, (p % B + p // B) % B) for p in range(B * (B + 1) // 2)]


@pytest.mark.parametrize("B", [1, 2, 3, 4, 7, 8, 33])
def test_expval_row_pairs_cover_each_unordered_pair_once(B):
    got = sorted(tuple(sorted(pr)) for pr in row_pairs(B))
    assert got == [(i, j) for i in range(B) for j in range(i, B)]
    assert [pr for pr in row_pairs(B) if pr[0] == pr[1]] == [(b, b) for b in range(B)]


def hash_model(rows, cols):
    """The kernel's hash_rows: for every set bit of every word, XOR in its
    column (uint32)."""
    cols = cols.view(np.uint32)
    out = np.zeros(rows.shape[0], np.uint32)
    for i, row in enumerate(rows.view(np.uint64)):
        h = np.uint32(0)
        for w, word in enumerate(row):
            v = int(word)
            while v:
                bit = (v & -v).bit_length() - 1
                h ^= cols[64 * w + bit]
                v &= v - 1
        out[i] = h
    return out


class Table:
    """build_table / probe: open addressing with linear probing from the
    hash's low bits; keys inserted in a given order (the kernel's atomicCAS
    order varies, a probe's answer does not)."""

    def __init__(self, hashes, keys, capacity, order=None):
        assert capacity & (capacity - 1) == 0 and capacity > len(keys)
        self.mask, self.hashes, self.keys = capacity - 1, hashes, keys
        self.slots = np.full(capacity, -1, np.int64)
        self.probes = self.finds = 0
        for i in (range(len(keys)) if order is None else order):
            slot = int(hashes[i]) & self.mask
            while self.slots[slot] >= 0:
                slot = (slot + 1) & self.mask
            self.slots[slot] = i

    def find(self, h, target):
        slot = int(h) & self.mask
        self.finds += 1
        while True:
            self.probes += 1
            e = self.slots[slot]
            if e < 0:
                return -1
            if self.hashes[e] == h and np.array_equal(self.keys[e], target):
                return int(e)
            slot = (slot + 1) & self.mask

    def find_all(self, h, target):
        """Every key equal to target, probing on to the empty slot."""
        slot, hits = int(h) & self.mask, []
        self.finds += 1
        while self.slots[slot] >= 0:
            self.probes += 1
            e = self.slots[slot]
            if self.hashes[e] == h and np.array_equal(self.keys[e], target):
                hits.append(int(e))
            slot = (slot + 1) & self.mask
        self.probes += 1
        return hits


def group_model(x, z, c):
    """state_expval.cu's grouping: the terms' X hashes sorted stably (as
    int32, torch.sort), a group starting wherever the hash or the X part
    changes.  Returns (goff, the X part and hash of each group, z and the
    phases c_t (-i)^{|Y_t|} in sorted order)."""
    keys = hash_model(x.view(np.int64), torch_state.hash_columns(x.shape[1]).numpy())
    order = np.argsort(keys.view(np.int32), kind="stable")
    xs, ks = x[order], keys[order]
    start = np.ones(len(order), bool)
    start[1:] = (ks[1:] != ks[:-1]) | np.any(xs[1:] != xs[:-1], axis=1)
    goff = np.append(np.flatnonzero(start), len(order))
    y = popc(x & z).sum(1)
    phase = c * (-1j) ** (y % 4)
    return goff, xs[start], ks[start], z[order], phase[order]


def expval_model(x, z, c, s, a, route=None, capacity=None, order=None):
    """state_expval.cu: the grouping (group_model), the rows' linear hashes,
    then per (group, row) pair or per unordered row pair one probe, and on
    a hit a_b conj(a_b') times the group's sum of +-c'_t (the pairs probe
    sums every exact match).  Returns (value, route, the table)."""
    goff, gx, hx, zg, cp = group_model(x, z, c)
    S, gx, zg = s.view(np.int64), gx.view(np.int64), zg.view(np.uint64)
    B, U = S.shape[0], gx.shape[0]
    hs = hash_model(S, torch_state.hash_columns(S.shape[1]).numpy())
    route = route or torch_state.expval_route(U, B)
    capacity = capacity or torch_state.table_capacity(max(B, x.shape[0]))

    def group_sum(g, row):
        par = popc(row.view(np.uint64)[None, :] & zg[goff[g]:goff[g + 1]]).sum(1) & 1
        return np.sum(cp[goff[g]:goff[g + 1]] * (1 - 2 * par))

    total = 0j
    if route == "groups":
        tab = Table(hs, S, capacity, order)
        for g in range(U):
            for b in range(B):
                e = tab.find(hs[b] ^ hx[g], S[b] ^ gx[g])
                if e >= 0:
                    total += group_sum(g, S[e]) * (a[b] * np.conj(a[e]))
    else:
        tab = Table(hx, gx, capacity, order)
        for b, b2 in row_pairs(B):
            for g in tab.find_all(hs[b] ^ hs[b2], S[b] ^ S[b2]):
                m = a[b] * np.conj(a[b2])
                total += group_sum(g, S[b2]) * m
                if b != b2:
                    total += group_sum(g, S[b]) * np.conj(m)
    return total, route, tab


def expval_case(n_qubits, T, B, seed, diagonal=True):
    """Terms with repeated X parts (and I/Z-only ones), and a deduplicated
    state whose rows are reached from each other by the terms' X parts."""
    rng = np.random.default_rng(seed)
    xs = planes(rng, max(1, T // 3), n_qubits, 0.3)
    x = xs[rng.integers(0, xs.shape[0], T)]
    z = planes(rng, T, n_qubits, 0.3)
    if diagonal:
        x[: max(1, T // 4)] = 0
    s = planes(rng, 1, n_qubits)
    for t in rng.integers(0, T, B - 1):
        s = np.vstack([s, s[rng.integers(0, s.shape[0])] ^ x[t]])
    s = np.unique(s, axis=0)
    c = rng.normal(size=T) + 1j * rng.normal(size=T)
    a = rng.normal(size=s.shape[0]) + 1j * rng.normal(size=s.shape[0])
    return x, z, c, s, a


@pytest.mark.parametrize("n_qubits", [1, 20, 64, 130])
def test_expval_hash_is_linear(n_qubits):
    """h(a ^ b) = h(a) ^ h(b) for the kernel's hash (model) and for
    torch_state.linear_hash, and the two agree."""
    rng = np.random.default_rng(n_qubits)
    a, b = planes(rng, 40, n_qubits), planes(rng, 40, n_qubits)
    cols = torch_state.hash_columns(a.shape[1])
    ha, hb, hab = (hash_model(v.view(np.int64), cols.numpy()) for v in (a, b, a ^ b))
    assert np.array_equal(hab, ha ^ hb)
    got = torch_state.linear_hash(tt(a ^ b), cols).numpy().view(np.uint32)
    assert np.array_equal(got, hab)
    assert not np.any(hash_model(np.zeros((1, a.shape[1]), np.int64), cols.numpy()))


@pytest.mark.parametrize("n_qubits,T,B,route", [
    (1, 3, 2, "groups"), (20, 12, 9, "groups"), (64, 30, 6, "pairs"), (130, 10, 7, "pairs"),
    (20, 5, 1, "pairs"), (64, 6, 1, "groups"), (20, 40, 12, None),
])
def test_expval_model_routes_match_state_core(n_qubits, T, B, route):
    """Both routes give <psi|O|psi>, whatever the shape would choose; B = 1
    meets only the X = 0 group, on the diagonal pair."""
    x, z, c, s, a = expval_case(n_qubits, T, B, n_qubits + T + B)
    model, used, _ = expval_model(x, z, c, s, a, route)
    want = state_core.expval(x, z, c, s, a)
    assert abs(model - want) <= 1e-12 * abs(want)
    got = torch_state.expval(tt(x), tt(z), tt(c.real), tt(c.imag), tt(s), tt(a.real), tt(a.imag))
    assert abs(complex(float(got[0]), float(got[1])) - want) <= 1e-12 * abs(want)
    if route is None:  # 13 groups x 12 rows > 78 row pairs
        assert used == "pairs"


def test_expval_model_matches_jx_state():
    x, z, c, s, a = expval_case(20, 14, 9, 5)
    want = jx_state.expval(jj(x), jj(z), jnp.asarray(c.real), jnp.asarray(c.imag), jj(s),
                           jnp.asarray(a.real), jnp.asarray(a.imag), s.shape[0])
    want = complex(float(want[0]), float(want[1]))
    for route in ("groups", "pairs"):
        model, _, _ = expval_model(x, z, c, s, a, route)
        assert abs(model - want) <= 1e-12 * abs(want)


@pytest.mark.parametrize("route", ["groups", "pairs"])
def test_expval_model_tiny_table_collides(route):
    """A table with one slot more than keys at the least (a miss must reach
    an empty slot), filled in reverse order: long probe chains, the same
    value; with the kernel's capacity chains are no longer."""
    x, z, c, s, a = expval_case(20, 16, 10, 11)
    want = state_core.expval(x, z, c, s, a)
    keys = s.shape[0] if route == "groups" else len(group_model(x, z, c)[0]) - 1
    cap = 1 << keys.bit_length()
    tight, _, tab = expval_model(x, z, c, s, a, route, capacity=cap, order=range(keys - 1, -1, -1))
    loose, _, tab2 = expval_model(x, z, c, s, a, route)
    assert abs(tight - want) <= 1e-12 * abs(want) and abs(loose - want) <= 1e-12 * abs(want)
    assert tab.probes > tab.finds  # collisions: chains longer than one slot
    assert tab.probes >= tab2.probes


def test_expval_model_rows_sharing_low_hash_bits():
    """Rows chosen so that their hashes agree in the low 6 bits: every key
    lands on one slot, and the probes still find each exact row."""
    rng = np.random.default_rng(9)
    n = 20
    pool = planes(rng, 4000, n)
    h = hash_model(pool.view(np.int64), torch_state.hash_columns(1).numpy())
    low = h & 63
    s = pool[low == np.bincount(low).argmax()][:12]
    x = np.vstack([np.zeros((1, 1), np.uint64), s[1:4] ^ s[0]])
    z = planes(rng, 4, n, 0.3)
    c = rng.normal(size=4) + 1j * rng.normal(size=4)
    a = rng.normal(size=s.shape[0]) + 1j * rng.normal(size=s.shape[0])
    model, route, tab = expval_model(x, z, c, s, a, "groups")
    assert len({int(v) & 63 for v in tab.hashes}) == 1
    want = state_core.expval(x, z, c, s, a)
    assert abs(model - want) <= 1e-12 * abs(want)


# -- noncon_brute ------------------------------------------------------------------

@pytest.mark.parametrize("M,n_free", [(20, 1), (40, 7), (33, 12), (8, 31)])
def test_bitmask_parity_equals_jx_noncon_float_parity(M, n_free):
    """popc(kk & gmask) & 1, kk = (~k & (2^n - 1)) | 2^31, gmask bit
    n - 1 - j = generator j and bit 31 = the fixed parity, equals
    jx_noncon._chunk_min's mod(neg @ F^T + fixed, 2) at HIGHEST precision."""
    rng = np.random.default_rng(M + n_free)
    F = rng.integers(0, 2, (M, n_free))
    fixed = rng.integers(0, 2, M)
    g, _, _, _ = torch_noncon.kernel_inputs(
        F, fixed, np.ones(M), np.ones(M), np.zeros((0, M)), torch.device("cpu")
    )
    g = g.numpy().astype(np.uint32)
    k = np.unique(np.concatenate([
        np.arange(min(64, 1 << n_free)), rng.integers(0, 1 << n_free, 64),
        [(1 << n_free) - 1],
    ])).astype(np.uint32)
    kk = (~k & np.uint32((1 << n_free) - 1)) | np.uint32(1 << 31)
    model = (np.bitwise_count(kk[:, None] & g[None, :]) & 1).astype(np.int64)
    shifts = jnp.asarray(np.arange(n_free - 1, -1, -1, dtype=np.uint32))
    grid = (jnp.asarray(k)[:, None] >> shifts[None, :]) & jnp.uint32(1)
    neg = (1 - grid.astype(jnp.int32)).astype(jnp.float64)
    want = jnp.mod(
        jnp.matmul(neg, jnp.asarray(F, jnp.float64).T, precision=lax.Precision.HIGHEST)
        + jnp.asarray(fixed, jnp.float64)[None, :], 2.0,
    )
    assert np.array_equal(model, np.asarray(want).astype(np.int64))


def sign_flip(base, parity):
    """The kernel's (-1)^parity * base: XOR of the float64's top bit."""
    bits = base.view(np.uint64) ^ (parity.astype(np.uint64) << np.uint64(63))
    return bits.view(np.float64)


def fold_model(gmask, base, seg_off, n_free, n_lo):
    """The kernel's prologue: F = gmask's free bits, b' = (-1)^{bit31 +
    popc(F)} base, the terms sorted stably by (segment, F's low n_lo bits),
    and bucket[s 2^n_lo + f] the first sorted term of bucket (s, f)."""
    g = gmask.astype(np.uint64)
    full = np.uint64((1 << n_free) - 1)
    F = (g & full).astype(np.uint32)
    fold = popc(g & (full | np.uint64(1 << 31))) & 1
    b = sign_flip(base.astype(np.float64).copy(), fold)
    L = 1 << n_lo
    seg = np.repeat(np.arange(len(seg_off) - 1), np.diff(seg_off))
    key = seg * L + (F & np.uint32(L - 1))
    order = np.argsort(key, kind="stable")
    bucket = np.searchsorted(key[order], np.arange((len(seg_off) - 1) * L + 1))
    return F[order], b[order], bucket


@pytest.mark.parametrize("M,n_free", [(20, 1), (40, 7), (33, 12), (8, 31)])
def test_sign_fold_turns_the_parity_into_a_plain_transform(M, n_free):
    """(-1)^popc(kk & gmask) base = b' (-1)^popc(F & k) exactly, with
    kk = (~k & (2^n - 1)) | 2^31, F = gmask's free bits and b' the folded
    base of the kernel's prologue (one segment: the sort only reorders)."""
    rng = np.random.default_rng(3 * M + n_free)
    F = rng.integers(0, 2, (M, n_free))
    fixed = rng.integers(0, 2, M)
    base = rng.normal(size=M)
    g, b, off, _ = torch_noncon.kernel_inputs(F, fixed, base, np.ones(M), np.zeros((0, M)),
                                              torch.device("cpu"))
    n_lo = min(n_free, torch_noncon.MAX_SPLIT)
    fm, bs, _ = fold_model(g.numpy(), b.numpy(), off.tolist(), n_free, n_lo)
    order = np.argsort((g.numpy() & ((1 << n_free) - 1)) & ((1 << n_lo) - 1), kind="stable")
    g, b = g.numpy()[order].astype(np.uint32), b.numpy()[order]
    assert np.array_equal(fm, g & np.uint32((1 << n_free) - 1))
    k = np.unique(np.concatenate([np.arange(min(64, 1 << n_free)),
                                  rng.integers(0, 1 << n_free, 64)])).astype(np.uint32)
    kk = (~k & np.uint32((1 << n_free) - 1)) | np.uint32(1 << 31)
    direct = sign_flip(np.broadcast_to(b, (k.size, M)).copy(),
                       np.bitwise_count(kk[:, None] & g[None, :]) & 1)
    folded = sign_flip(np.broadcast_to(bs, (k.size, M)).copy(),
                       np.bitwise_count(k[:, None] & fm[None, :]) & 1)
    assert np.array_equal(direct.view(np.int64), folded.view(np.int64))


def split_model(gmask, base, seg_off, n_free, n_lo):
    """noncon_brute.cu: the prologue (fold_model), then for every k_hi, per
    segment either the direct sum (a segment of at most n_lo / 4 terms) or
    the buckets h[F_lo] (in-order sums signed by (-1)^popc(F_hi & k_hi))
    and the butterflies (a + c, a - c) over the bits 0 .. n_lo - 1 in turn
    (registers, lanes, then the bits above 8: increasing order);
    E = s0 - sqrt(sum of squares), then the (min, argmin) with ties to the
    smaller k."""
    fm, bs, bucket = fold_model(gmask, base, seg_off, n_free, n_lo)
    L, n_segs = 1 << n_lo, len(seg_off) - 1
    E = np.empty(1 << n_free)
    for kh in range(1 << (n_free - n_lo)):
        k = (np.uint32(kh) << np.uint32(n_lo)) | np.arange(L, dtype=np.uint32)
        s0, sq = np.zeros(L), np.zeros(L)
        for seg in range(n_segs):
            m0, m1 = seg_off[seg], seg_off[seg + 1]
            if torch_noncon.direct_segment(m1 - m0, n_lo):
                v = np.zeros(L)
                for m in range(m0, m1):
                    v += sign_flip(np.full(L, bs[m]), np.bitwise_count(fm[m] & k) & 1)
            else:
                v = np.zeros(L)
                for i in range(L):
                    for m in range(bucket[seg * L + i], bucket[seg * L + i + 1]):
                        assert fm[m] & (L - 1) == i
                        v[i] += sign_flip(np.array([bs[m]]),
                                          np.array([popc(np.uint32(fm[m] >> n_lo) & kh) & 1]))[0]
                for bit in range(n_lo):
                    v = v.reshape(-1, 2, 1 << bit)
                    v = np.stack([v[:, 0] + v[:, 1], v[:, 0] - v[:, 1]], axis=1).reshape(L)
            if seg == 0:
                s0 += v
            else:
                sq += v * v
        E[kh * L:(kh + 1) * L] = s0 - np.sqrt(sq)
    k = int(np.lexsort((np.arange(E.size), E))[0])
    return float(E[k]), k, E


def noncon_case(M, n_free, n_cliques, seed, empty_clique=False, n_masks=None, unused=0):
    rng = np.random.default_rng(seed)
    F = rng.integers(0, 2, (M, n_free))
    if n_masks:  # repeated F masks
        F = F[rng.integers(0, n_masks, M)]
    F[:, :unused] = 0  # generators no term carries: ties
    fixed = rng.integers(0, 2, M)
    base = rng.normal(size=M)
    clique = rng.integers(-1, n_cliques, M) if n_cliques else np.full(M, -1)
    if empty_clique:
        clique[clique == n_cliques - 1] = 0
    mCi = np.array([(clique == i) for i in range(n_cliques)], float).reshape(-1, M)
    return F.astype(float), fixed.astype(float), base, (clique < 0).astype(float), mCi


@pytest.mark.parametrize("M,n_free,n_cliques,n_lo,kw", [
    (40, 12, 3, 8, {}),                       # n_lo < n_free
    (30, 6, 2, 6, {}),                        # n_lo = n_free
    (5, 1, 1, 1, {}),                         # n_free = 1
    (24, 10, 3, 7, dict(empty_clique=True)),  # an empty segment
    (20, 9, 0, 9, {}),                        # every term in S0
    (60, 11, 2, 9, dict(n_masks=5)),          # repeated F masks
    (25, 9, 2, 8, dict(unused=2)),            # ties: unused generators
    (9, 10, 4, 10, {}),                       # small segments summed directly
    (300, 12, 3, 5, {}),                      # buckets of several terms
])
def test_brute_force_model_matches_jx_noncon(M, n_free, n_cliques, n_lo, kw):
    F, fixed, base, mS0, mCi = noncon_case(M, n_free, n_cliques, M + n_free + n_lo, **kw)
    g, b, off, _ = torch_noncon.kernel_inputs(F, fixed, base, mS0, mCi, torch.device("cpu"))
    e, k, E = split_model(g.numpy(), b.numpy(), off.tolist(), n_free, n_lo)
    e_j, k_j = jx_noncon.brute_force_minimise(F, fixed, base, mS0, mCi, n_free)
    tol = 1e-12 * max(1.0, abs(e_j))
    assert abs(e - e_j) <= tol
    assert k == k_j or abs(E[k_j] - e) <= tol  # another index only at a near-tie
    e_p, k_p = torch_noncon.brute_force_plain(g, b, off, n_free, len(off) - 2)
    assert abs(float(e_p) - e) <= tol
    if kw.get("unused"):
        assert np.sum(np.abs(E - e) <= tol) >= 4  # a tie of at least 2^unused indices


# -- group_diag.cu and lanczos_matvec.cu -------------------------------------

DIAG_TILE_BITS = 12   # csrc/group_diag.cu kTileBits


def group_diag_model(gidx, z_int, ph, G, n):
    """The build kernel's passes over a (G, 2^n) table, with its index
    arithmetic: per block (g, hi, loc) a tile of 2^kb points x C columns."""
    from symmer_torch.kernels.torch_lanczos import fwht_passes, pass_columns

    dim = 1 << n
    keys = gidx.astype(np.int64) * dim + z_int
    order = np.argsort(keys, kind="stable")
    keys, ph = keys[order], ph[order]
    S = np.full(G * dim, np.nan + 1j * np.nan)  # never zeroed in device memory
    for s, kb in fwht_passes(n):
        C = pass_columns(s, kb)
        logc = C.bit_length() - 1
        assert logc == min(s, DIAG_TILE_BITS - kb)
        E = 1 << (kb + logc)
        assert E <= 1 << DIAG_TILE_BITS
        n_loc, n_hi = (1 << s) >> logc, 1 << (n - s - kb)
        n_blocks = (G << n) >> (kb + logc)
        blk = np.arange(n_blocks)
        loc, rest = blk % n_loc, blk // n_loc
        hi, g = rest % n_hi, rest // n_hi
        base = g * dim + (hi << (s + kb)) + loc * C
        e = np.arange(E)
        addr = base[:, None] + ((e >> logc) << s)[None, :] + (e & (C - 1))[None, :]
        if s == 0:
            tile = np.zeros((n_blocks, E), complex)
            lo = np.searchsorted(keys, base, side="left")
            hi_k = np.searchsorted(keys, base + E, side="left")
            for b in range(n_blocks):
                for i in range(lo[b], hi_k[b]):
                    tile[b, keys[i] - base[b]] += ph[i]
        else:
            tile = S[addr]
        u = np.arange(E >> 1)
        c, jj = u & (C - 1), u >> logc
        for t in range(kb):
            j = ((jj >> t) << (t + 1)) | (jj & ((1 << t) - 1))
            ia, ib = (j << logc) | c, ((j | (1 << t)) << logc) | c
            a, b_ = tile[:, ia].copy(), tile[:, ib].copy()
            tile[:, ia] = (a.real + b_.real) + 1j * (a.imag + b_.imag)
            tile[:, ib] = (a.real - b_.real) + 1j * (a.imag - b_.imag)
        S[addr] = tile
    return S.reshape(G, dim)


@pytest.mark.parametrize("n", [0, 1, 5, 11, 12, 13, 15, 17, 21])
def test_group_diag_passes_equal_fwht_rows(n):
    from symmer_tpu.kernels import dense

    from symmer_torch.kernels.torch_lanczos import fwht_passes

    rng = np.random.default_rng(n)
    dim = 1 << n
    G = 3 if n <= 17 else 1
    T = min(G * dim, 200)
    flat = rng.choice(G * dim, T, replace=False)
    gidx, z_int = flat // dim, flat % dim
    ph = rng.normal(size=T) + 1j * rng.normal(size=T)
    ph[:2] = [-0.0 + 0.0j, 0.0 - 0.0j]  # signed zeros
    got = group_diag_model(gidx, z_int, ph, G, n)
    vals = np.zeros((G, dim), complex)
    np.add.at(vals, (gidx, z_int), ph)
    want = dense.fwht_rows(vals)
    assert np.array_equal(got.view(np.int64), want.view(np.int64))
    # every stage once, in the order h = 1, 2, 4, ...
    stages = [s + t for s, kb in fwht_passes(n) for t in range(kb)]
    assert stages == list(range(n))


def test_group_diag_model_equals_group_diagonals():
    from symmer_tpu import PauliwordOp
    from symmer_tpu.kernels import dense

    op = PauliwordOp.random(13, 300)
    ux, gidx, z_int, ph = dense.group_scatter_inputs(op.x_pack, op.z_pack, op.coeff_vec, 13)
    _, want = dense.group_diagonals(op.x_pack, op.z_pack, op.coeff_vec, 13)
    got = group_diag_model(gidx, z_int, ph, ux.shape[0], 13)
    assert np.array_equal(got.view(np.int64), want.view(np.int64))


MATVEC_THREADS, MATVEC_TARGET_BLOCKS, MATVEC_MAX_SLICES = 128, 512, 32  # csrc/lanczos_matvec.cu


def grouped(rng, n, G, T):
    """(ux, off, z, ph): G distinct X patterns, T >= G terms sorted by group."""
    dim = 1 << n
    ux = rng.choice(dim, G, replace=False) if G <= dim else rng.integers(0, dim, G)
    counts = np.minimum(1 + np.bincount(rng.integers(0, G, T - G), minlength=G), dim)
    z = np.concatenate([rng.choice(dim, c, replace=False) for c in counts])
    ph = rng.normal(size=z.size) + 1j * rng.normal(size=z.size)
    return ux, np.concatenate([[0], np.cumsum(counts)]), z, ph


def matvec_model(ux, off, z, ph, V):
    """The recomputing matvec as csrc/lanczos_matvec.cu runs it: tiles of
    128 R rows (R = 8 / b a thread, rows base + t + j 2^sb), the groups cut
    into S slices at term counts T s / S, each row's sign the parity of
    (base + t) & z flipped by z's bits sb + k for the bits k of j, D_g(r)
    summed over the group's terms in order and multiplied into the columns
    at its last term, the slices' partial sums added in slice order."""
    b, dim = V.shape
    R = 8 // b
    tile_rows = R if dim < R else min(dim, MATVEC_THREADS * R)
    sb = (tile_rows // R).bit_length() - 1
    tiles = 1 if dim < R else dim // tile_rows
    S = 1
    while S < MATVEC_MAX_SLICES and tiles * S < MATVEC_TARGET_BLOCKS:
        S *= 2
    T, G = off[-1], ux.shape[0]
    t = np.arange(tile_rows // R)
    j = np.arange(R)
    parity = lambda a: (np.bitwise_count(a) & 1).astype(np.int64)
    parts = np.zeros((S, b, dim), complex)
    for s in range(S):
        g0, g1 = np.searchsorted(off, [T * s // S, T * (s + 1) // S], side="left")
        for tile in range(tiles):
            rb = tile * tile_rows + t                            # (threads,)
            rows = rb[:, None] + (j[None, :] << sb)              # (threads, R)
            acc = np.zeros((b,) + rows.shape, complex)
            for g in range(g0, g1):
                D = np.zeros(rows.shape, complex)
                for k in range(off[g], off[g + 1]):
                    sign = parity(rb & z[k])[:, None] ^ parity(j & (z[k] >> sb))[None, :]
                    D += (1 - 2 * sign) * ph[k]
                acc += D[None] * V[:, (rows ^ ux[g]) & (dim - 1)]
            live = rows < dim
            parts[s][:, rows[live]] = acc[:, live]
    out = parts[0]
    for s in range(1, S):
        out = out + parts[s]
    return out


@pytest.mark.parametrize("n,G,T,b", [(1, 1, 2, 1), (2, 3, 5, 4), (3, 5, 9, 1), (6, 1, 30, 2),
                                     (7, 20, 60, 4), (9, 9, 40, 8), (10, 40, 160, 1),
                                     (11, 12, 50, 2)])
def test_matvec_slices_equal_dense(n, G, T, b):
    """The kernel's order of rows, terms, groups and slices gives the dense
    product within 1e-14 of the sum of |ph_t| |V[c, r ^ ux_g]| over a row's
    terms (another order of the same sums), as does the plain version (the
    table built, then read), on the same grouped terms."""
    from symmer_torch.kernels import torch_lanczos

    rng = np.random.default_rng(n + G + b)
    dim = 1 << n
    ux, off, z, ph = grouped(rng, n, G, T)
    V = rng.normal(size=(b, dim)) + 1j * rng.normal(size=(b, dim))
    got = matvec_model(ux, off, z, ph, V)
    M = np.zeros((dim, dim), complex)
    scale = np.zeros((b, dim))
    rows = np.arange(dim)
    for g in range(G):
        for k in range(off[g], off[g + 1]):
            sign = 1 - 2 * (np.bitwise_count(rows & z[k]) & 1).astype(np.int64)
            M[rows, rows ^ ux[g]] += sign * ph[k]
            scale += np.abs(ph[k]) * np.abs(V[:, rows ^ ux[g]])
    want = (M @ V.T).T
    plain = torch_lanczos.terms_matvec(torch.tensor(ux), torch.tensor(off, dtype=torch.int32),
                                       torch.tensor(z, dtype=torch.int32), torch.tensor(ph),
                                       torch.tensor(V)).numpy()
    assert np.all(np.abs(got - want) <= 1e-14 * scale)
    assert np.all(np.abs(plain - want) <= 1e-14 * scale)


# -- lanczos_step.cu ---------------------------------------------------------

STEP_CHUNK = 512  # csrc/lanczos_step.cu: rows a block takes at a time


def step_sum_model(x):
    """A pass-1 sum as the step kernel takes it: per 512-row chunk, each
    thread adds its two adjacent rows, warp shuffles xor 1 .. 16 and the 8
    warp sums add in adjacent pairs; then every block adds the chunk sums,
    each thread a contiguous run streamed through a stack of tree levels."""
    L = x.size
    chunk = min(L, STEP_CHUNK)
    sums = []
    for c in range(0, L, chunk):
        v = x[c:c + chunk]
        v = v[0::2] + v[1::2] if v.size > 1 else v.copy()     # each thread's pair
        while v.size > 1:                                      # shuffles, then warps
            v = v[0::2] + v[1::2]
        sums.append(v[0])
    part = np.array(sums)
    P = part.size
    if P > 256:                                                # a run per thread
        K = P // 256
        runs = []
        for t in range(256):
            stack = {}
            for i in range(K):
                val, lvl = part[t * K + i], 0
                while (i >> lvl) & 1:
                    val, lvl = stack[lvl] + val, lvl + 1
                stack[lvl] = val
            runs.append(stack[K.bit_length() - 1])
        part = np.array(runs)
    while part.size > 1:
        part = part[0::2] + part[1::2]
    return part[0]


@pytest.mark.parametrize("n", [0, 1, 5, 9, 10, 14, 18])
def test_step_sums_equal_pairwise_sum(n):
    """The step kernel's cut of a sum into chunks, shuffles, warps and runs
    of chunk sums is the tree of adjacent pairs (torch_lanczos.pairwise_sum)
    bit for bit, signed zeros included, at one and many chunks."""
    from symmer_torch.kernels import torch_lanczos

    rng = np.random.default_rng(n)
    x = rng.normal(size=1 << n) * np.exp(rng.normal(size=1 << n) * 10)
    x[:2] = -0.0
    got = step_sum_model(x)
    want = float(torch_lanczos.pairwise_sum(torch.tensor(x)))
    assert np.float64(got).view(np.int64) == np.float64(want).view(np.int64)
