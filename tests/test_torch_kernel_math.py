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
    sums and runs of chunk sums, bit for bit the pairwise tree;
  - vqe_rotate.cu: the rotation's phase product, sign and the c psi + i s g
    combination row by row, bit for bit torch_vqe.rotate and within 1e-14 of
    e^{i t G} as a dense matrix; the coset tiles (the representatives with
    zeros inserted at the pivots, the offsets B(j), the item rows that pair
    each tile row once) against torch_vqe.tile_rows, the forward over the
    tiles (stretch by stretch, the signs from popc(rep & z) + popc(j & zc))
    bit for bit P sequential torch_vqe.rotate calls; the sweep's per-coset
    partials (each thread's items in order, the pairwise tree over the
    threads and over the cosets, ph once) bit for bit
    torch_vqe.adjoint_sweep, and its warp reduce-scatter bit for bit the
    pairwise tree over the lanes;
  - pauli_overlaps.cu: the X groups, the rows a thread takes (2, 4, 16),
    w = conj(a) b[r ^ x] once per group, the Walsh sign patterns and the
    in-thread, block and chunk trees, ph once, bit for bit
    torch_vqe.pauli_overlaps and within 1e-13 of the dense <a|P|b>;
  - gf2_rref.cu: the window scan that skips zero rows, the pivot's word and
    lowest bit and one pass per pivot, bit for bit gf2core.rref_inplace,
    with rank passes.

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


# -- K15: vqe_rotate.cu, pauli_overlaps.cu -----------------------------------

def dense_pauli_op(x, z, ph, n):
    """ph (-1)^{popcount(r & z)} X^x as a dense matrix, rows r (qubit 0 the
    most significant bit)."""
    dim = 1 << n
    M = np.zeros((dim, dim), complex)
    for r in range(dim):
        M[r, r ^ x] = ph * (-1) ** bin(r & z).count("1")
    return M


def rotate_model(psi, x, z, phr, phi, c, s):
    """vqe_rotate.cu row by row: g = ph psi[r ^ x] (two products and a sum a
    part, each rounded), negated where popcount(r & z) is odd, then
    (c p.re - s g.im, c p.im + s g.re)."""
    out = np.empty_like(psi)
    for r in range(psi.size):
        q, p = psi[r ^ x], psi[r]
        gre = q.real * phr - q.imag * phi
        gim = q.imag * phr + q.real * phi
        if bin(r & z).count("1") & 1:
            gre, gim = -gre, -gim
        out[r] = complex(p.real * c - gim * s, p.imag * c + gre * s)
    return out


def random_state(rng, n):
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return v / np.linalg.norm(v)


@pytest.mark.parametrize("n,x,z,c", [(1, 1, 0, 1), (1, 1, 1, -1), (3, 5, 6, 1), (4, 0, 9, -1),
                                     (6, 37, 21, 1), (6, 63, 63, -1)])
def test_rotation_model(n, x, z, c):
    from symmer_torch.kernels import torch_vqe

    rng = np.random.default_rng(n + x + z)
    psi = random_state(rng, n)
    ph = (-1j) ** (bin(x & z).count("1") % 4) * c  # (-i)^{|Y|} c, c = +-1
    t = float(rng.normal())
    got = rotate_model(psi, x, z, ph.real, ph.imag, np.cos(t), np.sin(t))
    plain = torch_vqe.rotate(torch.tensor(psi), x, z, ph.real, ph.imag, np.cos(t), np.sin(t))
    assert np.array_equal(got.view(np.int64), plain.numpy().view(np.int64))
    import scipy.linalg

    U = scipy.linalg.expm(1j * t * dense_pauli_op(x, z, ph, n))
    assert np.abs(got - U @ psi).max() <= 1e-14


VQE_THREADS = 256


def bit_count(v):
    return bin(int(v)).count("1")


def coset_rep_model(c, piv):
    """vqe_rotate.cu's coset_rep: c with a zero inserted at each pivot bit,
    lowest first."""
    while piv:
        p = (piv & -piv).bit_length() - 1
        piv &= piv - 1
        c = ((c >> p) << (p + 1)) | (c & ((1 << p) - 1))
    return c


def tile_offset_model(j, basis):
    """B(j): the XOR of the basis vectors at j's set bits."""
    o, i = 0, 0
    while j:
        if j & 1:
            o ^= int(basis[i])
        j, i = j >> 1, i + 1
    return o


def item_row_model(p, m):
    """The first tile row j0 of item p: p, or p with a 0 at m's lowest bit."""
    if not m:
        return p
    h = (m & -m).bit_length() - 1
    return ((p >> h) << (h + 1)) | (p & ((1 << h) - 1))


def rotated_model(p, q, odd, ph, c, s):
    """One row of a rotation, as vqe_rotate.cu's rotated (and rotate_model)."""
    gre = q.real * ph.real - q.imag * ph.imag
    gim = q.imag * ph.real + q.real * ph.imag
    if odd:
        gre, gim = -gre, -gim
    return complex(p.real * c - gim * s, p.imag * c + gre * s)


def term_model(l, p, odd):
    """(-1)^odd conj(l) p as vqe_rotate.cu's term: (re, im)."""
    re = l.real * p.real + l.imag * p.imag
    im = l.real * p.imag - l.imag * p.real
    return (-re, -im) if odd else (re, im)


def tile_model(plan, r, c):
    """(rep, rows of the coset's tile, the generators' parities of rep & z)."""
    rep = coset_rep_model(c, int(plan.pivots[r]))
    rows = [rep ^ tile_offset_model(j, plan.basis[r]) for j in range(1 << plan.tile_bits)]
    return rep, rows


def forward_model(psi, plan, t):
    """vqe_rotate.cu's forward: per run and coset, the tile loaded by rep ^
    B(j); per stretch, each thread's items p = t, t + 256, ... (two at a
    time: disjoint pairs, so any order) through the stretch's rotations,
    the sign from popc(rep & z) + popc(j & zc); the tile written back."""
    out = psi.copy()
    for r in range(plan.n_runs):
        for c in range(plan.n_cosets):
            rep, rows = tile_model(plan, r, c)
            sh = out[rows].copy()
            for s in range(int(plan.run_off[r]), int(plan.run_off[r + 1])):
                m = int(plan.stretch_mask[s])
                ks = range(int(plan.stretch_off[s]), int(plan.stretch_off[s + 1]))
                items = len(rows) >> 1 if m else len(rows)
                for p in range(items):
                    j0 = item_row_model(p, m)
                    j1 = j0 ^ m
                    v0, v1 = sh[j0], sh[j1]
                    for k in ks:
                        ph = complex(*plan.ph[k])
                        par = bit_count(rep & int(plan.gz[k]))
                        o0 = (par + bit_count(j0 & int(plan.gzc[k]))) & 1
                        o1 = (par + bit_count(j1 & int(plan.gzc[k]))) & 1
                        if m:
                            v0, v1 = (rotated_model(v0, v1, o0, ph, np.cos(t[k]), np.sin(t[k])),
                                      rotated_model(v1, v0, o1, ph, np.cos(t[k]), np.sin(t[k])))
                        else:
                            v0 = rotated_model(v0, v0, o0, ph, np.cos(t[k]), np.sin(t[k]))
                    sh[j0] = v0
                    if m:
                        sh[j1] = v1
            out[rows] = sh
    return out


def pairwise_model(v):
    """The tree of adjacent pairs over a power-of-two axis (the last)."""
    v = np.asarray(v)
    while v.shape[-1] > 1:
        v = v[..., 0::2] + v[..., 1::2]
    return v[..., 0]


def reduce_scatter_model(vals):
    """vqe_rotate.cu's warp_reduce_scatter over 32 lanes x 16 values
    (vals[lane][i]): four halving levels (a lane keeps the values whose
    index bit is its lane bit and adds its partner's copies), then xor 16.
    Returns each lane's value, lane l holding value l & 15."""
    v = [list(vals[l]) for l in range(32)]
    for b in range(4):
        nxt = []
        for l in range(32):
            bit, q = (l >> b) & 1, l ^ (1 << b)
            qbit = (q >> b) & 1
            nxt.append([(v[l][2 * s + 1] if bit else v[l][2 * s])
                        + (v[q][2 * s] if qbit else v[q][2 * s + 1]) for s in range(8 >> b)])
        v = nxt
    return [v[l][0] + v[l ^ 16][0] for l in range(32)]


def sweep_model(psi, lam, plan, t):
    """vqe_rotate.cu's sweep: runs, then each coset's stretches, in reverse;
    a thread's items p = t + i T add their values left to right per step (a
    pair's two terms added, j0's first), un-rotating both vectors after
    each step but the last generator's; the block adds its threads' sums
    by the pairwise tree (the coset's partial); the totals add the partials
    by the pairwise tree over the cosets and multiply by ph."""
    P, C = plan.gx.size, plan.n_cosets
    part = np.zeros((P, C, 2))
    ps, ls = psi.copy(), lam.copy()
    for r in reversed(range(plan.n_runs)):
        for c in range(C):
            rep, rows = tile_model(plan, r, c)
            psh, lsh = ps[rows].copy(), ls[rows].copy()
            for s in reversed(range(int(plan.run_off[r]), int(plan.run_off[r + 1]))):
                m = int(plan.stretch_mask[s])
                ks = list(reversed(range(int(plan.stretch_off[s]), int(plan.stretch_off[s + 1]))))
                items = len(rows) >> 1 if m else len(rows)
                T = min(VQE_THREADS, items)
                acc = np.zeros((T, len(ks), 2))
                for th in range(T):
                    for i, p in enumerate(range(th, items, VQE_THREADS)):
                        j0 = item_row_model(p, m)
                        j1 = j0 ^ m
                        p0, p1, l0, l1 = psh[j0], psh[j1], lsh[j0], lsh[j1]
                        for u, k in enumerate(ks):
                            ph = complex(*plan.ph[k])
                            par = bit_count(rep & int(plan.gz[k]))
                            o0 = (par + bit_count(j0 & int(plan.gzc[k]))) & 1
                            o1 = (par + bit_count(j1 & int(plan.gzc[k]))) & 1
                            v = term_model(l0, p1 if m else p0, o0)
                            if m:
                                w = term_model(l1, p0, o1)
                                v = (v[0] + w[0], v[1] + w[1])
                            acc[th, u] = v if i == 0 else (acc[th, u, 0] + v[0], acc[th, u, 1] + v[1])
                            if k:
                                cc, sn = np.cos(t[k]), -np.sin(t[k])
                                if m:
                                    p0, p1 = (rotated_model(p0, p1, o0, ph, cc, sn),
                                              rotated_model(p1, p0, o1, ph, cc, sn))
                                    l0, l1 = (rotated_model(l0, l1, o0, ph, cc, sn),
                                              rotated_model(l1, l0, o1, ph, cc, sn))
                                else:
                                    p0 = rotated_model(p0, p0, o0, ph, cc, sn)
                                    l0 = rotated_model(l0, l0, o0, ph, cc, sn)
                        psh[j0], lsh[j0] = p0, l0
                        if m:
                            psh[j1], lsh[j1] = p1, l1
                for u, k in enumerate(ks):
                    part[k, c] = pairwise_model(acc[:, u].T)
            ps[rows], ls[rows] = psh, lsh
    tot = pairwise_model(part.transpose(0, 2, 1))
    ph = plan.ph
    return (tot[:, 0] * ph[:, 0] - tot[:, 1] * ph[:, 1]) + 1j * (tot[:, 1] * ph[:, 0]
                                                               + tot[:, 0] * ph[:, 1])


def vqe_generators(rng, n, P):
    dim = 1 << n
    pool = rng.integers(0, dim, size=max(2, P // 4))
    x = np.repeat(pool, rng.integers(1, 6, size=pool.size))[:P]
    x = np.concatenate([x, rng.integers(0, dim, size=P - x.size)]).astype(np.int64)
    x[rng.random(P) < 0.15] = 0
    z = rng.integers(0, dim, size=P).astype(np.int64)
    y = np.array([bit_count(a & b) for a, b in zip(x, z)])
    return x, z, (-1j) ** (y % 4) * rng.choice([1.0, -1.0], size=P)


@pytest.mark.parametrize("n,P,tile_bits", [(1, 3, None), (3, 8, 2), (5, 14, 3), (6, 16, None),
                                           (7, 10, 6)])
def test_coset_tiles_and_the_forward_model(n, P, tile_bits):
    """The kernel's coset representatives and tile offsets give the plan's
    tile rows; each item pairs tile rows once; the forward over the tiles
    is P sequential rotations bit for bit, and within 1e-13 of the dense
    exponentials."""
    from symmer_torch.kernels import torch_vqe

    rng = np.random.default_rng(n * 13 + P)
    x, z, ph = vqe_generators(rng, n, P)
    plan = torch_vqe.plan_runs(x, z, ph, n, tile_bits=tile_bits)
    for r in range(plan.n_runs):
        got = np.array([tile_model(plan, r, c)[1] for c in range(plan.n_cosets)])
        assert np.array_equal(got, torch_vqe.tile_rows(plan, r))
    for m in {int(v) for v in plan.stretch_mask}:
        tile = 1 << plan.tile_bits
        items = [item_row_model(p, m) for p in range(tile >> 1 if m else tile)]
        rows = items + ([j ^ m for j in items] if m else [])
        assert sorted(rows) == list(range(tile))
    t = rng.normal(size=P)
    psi = random_state(rng, n)
    got = forward_model(psi, plan, t)
    seq = torch.tensor(psi)
    for k in range(P):
        seq = torch_vqe.rotate(seq, int(x[k]), int(z[k]), ph[k].real, ph[k].imag, np.cos(t[k]),
                               np.sin(t[k]))
    assert np.array_equal(got.view(np.int64), seq.numpy().view(np.int64))
    import scipy.linalg

    want = psi
    for k in range(P):
        want = scipy.linalg.expm(1j * t[k] * dense_pauli_op(int(x[k]), int(z[k]), ph[k], n)) @ want
    assert np.abs(got - want).max() <= 1e-13


def test_warp_reduce_scatter_is_the_pairwise_tree():
    """The sweep's reduce-scatter of 16 values over 32 lanes gives each
    value's pairwise tree over the lanes (block_pairwise's shuffles) bit for
    bit, signed zeros included."""
    rng = np.random.default_rng(3)
    for _ in range(50):
        vals = rng.normal(size=(32, 16)) * np.exp(rng.normal(size=(32, 16)) * 8)
        vals[rng.random((32, 16)) < 0.1] = -0.0
        got = reduce_scatter_model(vals)
        for lane in range(32):
            want = pairwise_model(vals[:, lane & 15])
            assert np.float64(got[lane]).view(np.int64) == np.float64(want).view(np.int64)


@pytest.mark.parametrize("n,P,tile_bits", [(2, 5, None), (4, 9, 2), (6, 12, 5), (7, 10, None),
                                           (7, 8, 6)])
def test_sweep_model(n, P, tile_bits):
    """The sweep's per-coset partials and their trees, bit for bit
    torch_vqe.adjoint_sweep, and within 1e-13 of the overlaps taken one
    generator at a time on dense matrices."""
    from symmer_torch.kernels import torch_vqe

    rng = np.random.default_rng(n * 17 + P)
    x, z, ph = vqe_generators(rng, n, P)
    plan = torch_vqe.plan_runs(x, z, ph, n, tile_bits=tile_bits)
    t = rng.normal(size=P)
    psi, lam = random_state(rng, n), random_state(rng, n)
    got = sweep_model(psi, lam, plan, t)
    cs = torch.tensor(np.stack([np.cos(t), np.sin(t)], 1))
    plain = torch_vqe.adjoint_sweep(torch.tensor(psi), torch.tensor(lam), plan, cs).numpy()
    assert np.array_equal(got.view(np.int64), plain.view(np.int64))
    import scipy.linalg

    want, p, l = np.empty(P, complex), psi, lam
    for k in reversed(range(P)):
        G = dense_pauli_op(int(x[k]), int(z[k]), ph[k], n)
        want[k] = np.vdot(l, G @ p)
        U = scipy.linalg.expm(-1j * t[k] * G)
        p, l = U @ p, U @ l
    assert np.abs(got - want).max() <= 1e-13


OVERLAP_TARGET_BLOCKS = 2 * 132


def rows_per_thread_model(dim, n_groups):
    """pauli_overlaps.cu's rows a thread: 16, or 4 (2 below 4 rows) where 16
    leaves fewer blocks than the card wants."""
    chunks16 = dim // (16 * 256) if dim > 16 * 256 else 1
    if dim >= 16 and n_groups * chunks16 >= OVERLAP_TARGET_BLOCKS:
        return 16
    return 4 if dim >= 4 else 2


def walsh_model(zl):
    m = 0
    for b, pattern in enumerate((0xAAAA, 0xCCCC, 0xF0F0, 0xFF00)):
        if (zl >> b) & 1:
            m ^= pattern
    return m


def overlap_model(a, b, xs, zs, ph):
    """pauli_overlaps.cu: the Paulis grouped by x; per (group, chunk) a
    thread forms w(r) = conj(a[r]) b[r ^ x] for its RPT adjacent rows once,
    then per Pauli signs them by a Walsh pattern of z's low bits (flipped
    by the parity of the first row's bits), adds them by the pairwise tree,
    and the block adds its threads' sums by the same tree; the chunk sums
    add by the tree and ph multiplies the total once."""
    from symmer_torch.kernels import torch_vqe

    dim, N = a.size, xs.size
    ux, off, order = torch_vqe.x_groups(np.asarray(xs) & (dim - 1))
    rpt = rows_per_thread_model(dim, ux.size)
    rows = min(dim, rpt * 256)
    active, n_chunks = rows // rpt, dim // rows
    part = np.zeros((N, n_chunks, 2))
    u = np.arange(rpt)
    for g, x in enumerate(ux):
        for ch in range(n_chunks):
            r0 = ch * rows + np.arange(active) * rpt                      # each thread's first row
            r = (r0[:, None] + u[None, :])
            p, q = a[r], b[r ^ x]
            wre = p.real * q.real + p.imag * q.imag
            wim = p.real * q.imag - p.imag * q.real
            for slot in range(off[g], off[g + 1]):
                z = int(zs[order[slot]])
                wm = walsh_model(z & (rpt - 1))
                flip = np.bitwise_count(r0 & z) & 1
                odd = ((wm >> u)[None, :] & 1) ^ flip[:, None]
                vr, vi = np.where(odd == 1, -wre, wre), np.where(odd == 1, -wim, wim)
                part[slot, ch] = pairwise_model(pairwise_model(vr)), pairwise_model(pairwise_model(vi))
    tot = pairwise_model(part.transpose(0, 2, 1))                        # (N slots, 2)
    out = np.empty(N, complex)
    for slot, i in enumerate(order):
        re, im = tot[slot]
        out[i] = complex(re * ph[i].real - im * ph[i].imag, im * ph[i].real + re * ph[i].imag)
    return out


@pytest.mark.parametrize("n,N,n_x", [(1, 4, 2), (2, 6, 3), (9, 8, 4), (10, 12, 5), (11, 4, 4),
                                     (12, 300, 280)])
def test_overlap_model(n, N, n_x):
    """The X-grouped overlaps (2, 4 and 16 rows a thread) bit for bit
    torch_vqe.pauli_overlaps, and within 1e-13 of <a|P|b> summed by numpy."""
    from symmer_torch.kernels import torch_vqe

    rng = np.random.default_rng(n + N)
    a, b = random_state(rng, n), random_state(rng, n)
    dim = 1 << n
    pool = rng.choice(dim, size=min(n_x, dim), replace=False)
    xs = pool[rng.integers(0, pool.size, size=N)]
    xs[0] = 0
    zs = rng.integers(0, dim, size=N)
    phs = np.array([1, -1j, -1, 1j])[rng.integers(0, 4, size=N)]
    got = overlap_model(a, b, xs, zs, phs)
    plain = torch_vqe.pauli_overlaps(torch.tensor(a), torch.tensor(b), torch.tensor(xs),
                                     torch.tensor(zs), torch.tensor(np.stack([phs.real, phs.imag], 1)))
    assert np.array_equal(got.view(np.int64), plain.numpy().view(np.int64))
    r = np.arange(dim)
    want = [np.vdot(a, p * (1 - 2 * (np.bitwise_count(r & z) & 1).astype(np.int64)) * b[r ^ x])
            for x, z, p in zip(xs, zs, phs)]
    assert np.abs(got - want).max() <= 1e-13


# -- K11: gf2_rref.cu ------------------------------------------------------------

RREF_THREADS, RREF_ROWS_PER_GROUP = 256, 8


def rref_model(M):
    """gf2_rref.cu's loop: a window of (256 / L) x 8 rows scanned for the
    first nonzero row (L lanes a row, L the power of two >= W up to 32);
    none: the next window, no barrier; else the pivot's first nonzero word
    and lowest bit, one pass XORing row p into every other row holding it,
    and the scan resumes after p.  Returns (M, passes, windows)."""
    M = M.copy()
    R, W = M.shape
    L = 1
    while L < 32 and L < W:
        L *= 2
    window = RREF_THREADS // L * RREF_ROWS_PER_GROUP
    i = passes = windows = 0
    while i < R:
        windows += 1
        nz = np.flatnonzero(M[i:i + window].any(axis=1))
        if nz.size == 0:
            i += window
            continue
        p = i + int(nz[0])
        pw = int(np.flatnonzero(M[p])[0])
        pbit = M[p, pw] & (~M[p, pw] + np.uint64(1))
        hit = (M[:, pw] & pbit) != 0
        hit[p] = False
        M[hit] ^= M[p]
        passes += 1
        i = p + 1
    return M, passes, windows


@pytest.mark.parametrize("R,W,rank_bits", [(1, 1, 1), (300, 1, 20), (3000, 2, 90),
                                           (500, 33, 2100), (64, 40, 0)])
def test_rref_model_equals_host(R, W, rank_bits):
    from symmer_torch.native import gf2core

    rng = np.random.default_rng(R + W)
    M = np.zeros((R, W), np.uint64)
    basis = pack.pack_bits(rng.random((max(rank_bits, 1), W * 64)) < 0.3, W * 64)
    if rank_bits:
        picks = rng.random((R, basis.shape[0])) < 0.5
        for j in range(basis.shape[0]):
            M[picks[:, j]] ^= basis[j]
    got, passes, windows = rref_model(M)
    want = M.copy()
    gf2core.rref_inplace(want)
    assert np.array_equal(got, want)
    assert passes == int(want.any(axis=1).sum())  # one pass per pivot: the rank
    # zero rows cost window scans, not passes: a run of them a window at a time
    window = RREF_THREADS // min(32, 1 << (W - 1).bit_length()) * RREF_ROWS_PER_GROUP
    assert windows <= 2 * passes + R // window + 1
