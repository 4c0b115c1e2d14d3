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
  - lanczos_step.cu: the grid route's cut of each sum into chunks, warp
    shuffles, warp sums and runs of chunk sums, and the cluster route's cut
    (each block's aligned range of rows in slots of its active threads, the
    slots' shuffles, the slot-major warp sums run by run, the lanes of warp
    0 and the cluster's block sums), bit for bit the pairwise tree;
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
  - gf2_rref.cu: the panel (chunks of the next 64 live rows,
    each reduced by the panel's pivots so far, then walked in row order as
    combination masks T and a two-word window, rows built from T where the
    window is zero, at most P pivots or 512 live rows a panel, the earlier
    pivots reduced by the new ones) and the update (a row's bits at the
    pivot columns as a mask, the XOR of the masked pivots), bit for bit
    gf2core.rref_inplace and torch_gf2.rref at P = 1, 3 and 64;
  - pair_products.cu: the tiles of ti x tj pairs (every pair written by
    one thread), the words in chunks, the power of i and the sign's
    popcount in uint32, each half-word hashed in four lanes, the
    coefficient's products and sum rounded apart, bit for bit
    torch_core.pair_products;
  - merge_groups.cu: pass A (a head sums its group's first 32 rows from
    +0.0 in sorted order, its warp the rest in chunks whose group rows are
    a prefix, and flags its first row; every flag written once; with live
    flags a dead row adds +0.0 and the first live row, found by a ballot
    in the warp's chunks, is flagged) and pass B (route_rows.cu's look-back
    over tiles of input order, the ballot scatter, the rows copied by lane
    groups from the planes or rebuilt from their pairs, a rotation's rows
    or masked rows), bit for bit torch_core.merge_groups;
  - merge_small.cu (K3's one-block route): the live slots' hash table in
    shared memory (claims in any order of the threads, each group's first
    slot by atomicMin), the keys (first slot << 16) | slot, the bitonic
    network four keys a thread (steps in registers, by shuffles and through
    the exchange buffers), each group's end at its first slot, the sums
    from +0.0 in slot order, the survivors' exclusive scan and the rows
    copied by lane groups from the four row sources, bit for bit
    torch_core.merge_small and the parent's composition; its fused route's
    step 0' (each slot signed once, by one block or by the cluster's, in
    registers: the words in order, the position constants of each word,
    the pair's power of i and sign, the coefficient rounded apart), bit for
    bit torch_core.cleanup_small and product_small;
  - rotation_rows.cu and project_rows.cu: units of V words of x and z a
    lane, the row's (and its P Q twin's, or its masked) signature, the
    popcounts in uint32, the group's xor-shuffle tree, the coefficients'
    products by +-1.0 and by cos / sin rounded apart and the live flags,
    bit for bit torch_core.rotation_rows and project_rows.

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
from symmer_torch.kernels import cuda, torch_core, torch_noncon, torch_state

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


STEP_THREADS = 256  # csrc/pairwise_sum.cuh: kThreads


def butterfly(v, width):
    """lanes_pairwise: each lane adds its partner's value at xor 1 .. width / 2
    (own value first) along the last axis; returns lane 0's."""
    lane = np.arange(v.shape[-1])
    m = 1
    while m < width:
        v = v + v[..., lane ^ m]
        m <<= 1
    return v[..., 0]


def cluster_step_sum_model(x, blocks):
    """A pass-1 sum as the cluster route takes it (csrc/lanczos_step.cu):
    C blocks of R = dim / C rows, A = min(R, 256) active threads, Q = R / A
    slots a thread (row b R + i A + t); each slot's warp shuffles, the Q x nw
    warp sums slot-major, warp 0's lanes a run of K adjacent ones each and
    then the lanes, and every warp's shuffles over the C block sums."""
    dim = x.size
    C = min(blocks, max(1, dim // STEP_THREADS))
    R = dim // C
    A = min(R, STEP_THREADS)
    Q = R // A
    width = min(A, 32)
    nw = A // 32 if A > 32 else 1
    rows = x.reshape(C, Q, nw, width)               # (block, slot, warp, lane)
    ws = butterfly(rows, width).reshape(C, Q * nw)  # slot-major warp sums
    P = Q * nw
    K = Q // 4 if Q >= 8 else 1
    L = min(P, 32)
    a = ws.reshape(C, L, K)
    h = 1
    while h < K:
        a = a.copy()
        a[..., 0::2 * h] = a[..., 0::2 * h] + a[..., h::2 * h]
        h *= 2
    sums = butterfly(a[..., 0], L)                  # each block's sum
    lanes = np.zeros(32)
    lanes[:C] = sums
    return butterfly(lanes, C)


@pytest.mark.parametrize("blocks", [16, 8])
@pytest.mark.parametrize("n", range(21))
def test_cluster_step_sums_equal_pairwise_sum(n, blocks):
    """The cluster route's cut of a sum (block ranges, slots, shuffles, warp
    sums, warp 0's runs and lanes, the cluster's block sums) is the tree of
    adjacent pairs (torch_lanczos.pairwise_sum) bit for bit, signed zeros
    included, for clusters of 16 and 8 blocks at every size up to 2^20."""
    from symmer_torch.kernels import torch_lanczos

    rng = np.random.default_rng(100 + n)
    x = rng.normal(size=1 << n) * np.exp(rng.normal(size=1 << n) * 10)
    x[: min(2, x.size)] = -0.0
    got = cluster_step_sum_model(x, blocks)
    want = float(torch_lanczos.pairwise_sum(torch.tensor(x)))
    assert np.float64(got).view(np.int64) == np.float64(want).view(np.int64)
    zeros = np.full(1 << n, -0.0)
    assert np.float64(cluster_step_sum_model(zeros, blocks)).view(np.int64) == (
        np.float64(float(torch_lanczos.pairwise_sum(torch.tensor(zeros)))).view(np.int64))


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

RREF_CHUNK, RREF_BUDGET = 64, 512  # gf2_rref.cu: kChunk, kBudget (kPivots = 64)


def pivot_masks(rows, cols):
    """bool[n, P]: each row's bit at each pivot column (word, bit)."""
    return np.stack([(rows[:, w] >> np.uint64(b)) & np.uint64(1) for w, b in cols], axis=1) == 1


def lowest_bit(row):
    w = int(np.flatnonzero(row)[0])
    return w, (int(row[w]) & -int(row[w])).bit_length() - 1


def chunk_walk(rows, p_left):
    """gf2_rref.cu's walk of one chunk (rows: its rows reduced by the
    panel's pivots so far).  Row j is tracked as T_j, a mask over the chunk's
    rows, and its words w0 and w0 + 1 (all rows are zero below w0); in row
    order a row with a nonzero window pivots there and the rows holding its
    bit take its window and T; a row with a zero window is built from T to
    find its pivot further on (or none), and the rows' bits at that column
    are parities of T_j and the column.  Stops at p_left pivots.  Returns
    ([(chunk row, pivot row, word, bit)], the last row walked)."""
    n, W = rows.shape
    nonzero = rows.any(axis=1)
    w0 = min(int(np.flatnonzero(r)[0]) for r in rows[nonzero]) if nonzero.any() else 0
    A = min(2, W - w0)
    a = [[int(rows[j, w0 + x]) for x in range(A)] for j in range(n)]
    T = [1 << j for j in range(n)]
    walked, tlast = [], n - 1
    for t in range(n):
        if not nonzero[t]:
            continue
        at = a[t]
        if any(at):
            x = 0 if at[0] else 1
            pw, pb = w0 + x, (at[x] & -at[x]).bit_length() - 1
            for j in range(n):
                if j != t and (a[j][x] >> pb) & 1:
                    a[j] = [a[j][y] ^ at[y] for y in range(A)]
                    T[j] ^= T[t]
        else:
            cur = np.bitwise_xor.reduce(rows[[k for k in range(n) if (T[t] >> k) & 1]], axis=0)
            if not cur.any():
                continue
            pw, pb = lowest_bit(cur)
            col = sum(((int(rows[k, pw]) >> pb) & 1) << k for k in range(n))
            for j in range(n):
                if j != t and bin(T[j] & col).count("1") & 1:
                    T[j] ^= T[t]
        walked.append((t, pw, pb))
        if len(walked) == p_left:
            tlast = t
            break
    built = [(t, np.bitwise_xor.reduce(rows[[k for k in range(n) if (T[t] >> k) & 1]], axis=0),
              pw, pb) for t, pw, pb in walked]
    return built, tlast


def blocked_rref_model(M, P=64, chunk=RREF_CHUNK, budget=RREF_BUDGET):
    """gf2_rref.cu's blocked schedule.  A pass: the panel takes the next
    `chunk` live rows from the cursor (a row is live while nonzero), reduces
    each by the panel's pivots so far (mask at their columns, XOR of the
    masked pivots), walks them (chunk_walk), reduces the panel's earlier
    pivots by the new ones (one mask each) and zeroes the walked rows that
    did not pivot; it stops at P pivots, after `budget` live rows or at the
    end, and writes the pivots.  The update reduces every other live row
    (outside the panel's rows) by the pass's pivots with one mask each.
    Returns (M, pivots per pass)."""
    M = M.copy()
    R, W = M.shape
    live = M.any(axis=1)
    i, passes = 0, []
    while True:
        piv, cols, prow = np.zeros((0, W), np.uint64), [], []
        cursor, taken = i, 0
        while len(cols) < P and taken < budget and cursor < R:
            ahead = cursor + np.flatnonzero(live[cursor:])[:chunk]
            n = ahead.size
            if n == 0:
                cursor = R
                break
            rows = M[ahead]
            if cols:
                m = pivot_masks(rows, cols)
                for k in range(len(cols)):
                    rows[m[:, k]] ^= piv[k]
            new, tlast = chunk_walk(rows, P - len(cols))
            if new and cols:
                m = pivot_masks(piv, [(pw, pb) for _, _, pw, pb in new])
                for q, (_, v, _, _) in enumerate(new):
                    piv[m[:, q]] ^= v
            ispiv = np.zeros(n, bool)
            for t, v, pw, pb in new:
                piv = np.vstack([piv, v])
                cols.append((pw, pb))
                prow.append(int(ahead[t]))
                ispiv[t] = True
            walked = ahead[: tlast + 1][~ispiv[: tlast + 1]]
            M[walked] = 0
            live[walked] = False
            taken += tlast + 1
            cursor = R if (n < chunk and tlast == n - 1) else int(ahead[tlast]) + 1
        M[prow] = piv
        passes.append(len(cols))
        if not cols:
            break
        others = live.copy()
        others[i:cursor] = False
        idx = np.flatnonzero(others)
        m = pivot_masks(M[idx], cols)
        for k in range(len(cols)):
            M[idx[m[:, k]]] ^= piv[k]
        live[idx] = M[idx].any(axis=1)
        if cursor >= R:
            break
        i = cursor
    return M, passes


def rref_blocked_stack(rng, W, kind):
    """uint64[R, W] stacks that put pivots at the panel's edges.

    rankN: random sums of N independent rows (a few dependent rows early, so
    chunks end mid-panel); spreadN: the same with the rows' lowest bits
    spread over all words (pivots beyond the walk's two-word window); firstN: N independent rows, then sums of them (a
    chunk whose rows are all dependent); edges: 60 independent rows, 10
    sums of two of them (rows that turn zero inside the panel), 70 more,
    400 zero rows, 64 sums of the first 130 and 30 independent rows."""
    def indep(n, gap=1):  # n rows of distinct lowest set bits, shuffled: rank n
        B = rng.integers(0, 1 << 64, size=(n, W), dtype=np.uint64)
        for j in range(n):
            b = j * gap
            B[j, : b // 64] = 0
            B[j, b // 64] &= ~np.uint64((1 << (b % 64)) - 1)
            B[j, b // 64] |= np.uint64(1 << (b % 64))
        return B[rng.permutation(n)]

    def sums(B, n):
        out = np.zeros((n, W), np.uint64)
        for j in range(B.shape[0]):
            out[rng.random(n) < 0.5] ^= B[j]
        return out

    if kind.startswith("rank"):
        return sums(indep(int(kind[4:])), 200)
    if kind.startswith("spread"):  # lowest bits spread over the words
        n = int(kind[6:])
        return sums(indep(n, 64 * W // n), 200)
    if kind.startswith("first"):  # 700 sums: a panel can end on its budget
        B = indep(int(kind[5:]))
        return np.vstack([B, sums(B, 700)])
    A, C, D = indep(60), indep(70), indep(30)
    pairs = A[rng.integers(0, 60, 10)] ^ A[rng.integers(0, 60, 10)]
    return np.vstack([A, pairs, C, np.zeros((400, W), np.uint64),
                      sums(np.vstack([A, C]), 64), D])


@pytest.mark.parametrize("P", [1, 3, 64])
@pytest.mark.parametrize("W,kind", [(1, "first63"), (1, "first64"), (2, "rank63"),
                                    (2, "rank64"), (2, "rank65"), (2, "first65"),
                                    (32, "edges"), (70, "rank65"), (32, "spread65")])
def test_rref_blocked_model_equals_host_and_plain(P, W, kind):
    from symmer_torch.kernels import torch_gf2
    from symmer_torch.native import gf2core

    rng = np.random.default_rng(7 * W + len(kind))
    M = rref_blocked_stack(rng, W, kind)
    got, passes = blocked_rref_model(M, P)
    want = M.copy()
    gf2core.rref_inplace(want)
    assert np.array_equal(got, want)
    plain = torch_gf2.rref(torch.from_numpy(M.view(np.int64).copy())).numpy()
    assert np.array_equal(got.view(np.int64), plain)
    rank = int(want.any(axis=1).sum())
    # a pass ends at P pivots, after its budget of live rows or at the end
    assert sum(passes) == rank and max(passes) <= P
    assert len(passes) <= -(-rank // P) + -(-M.shape[0] // RREF_BUDGET) + 1
    if kind.startswith("first"):
        # N independent rows first: full panels while they last
        assert passes[: rank // P] == [P] * (rank // P)


@pytest.mark.parametrize("R,W,rank_bits", [(1, 1, 1), (300, 1, 20), (3000, 2, 90),
                                           (500, 33, 2100), (64, 40, 0)])
def test_rref_model_equals_host(R, W, rank_bits):
    """The blocked schedule on random sums of a random basis (a zero stack,
    one row, ranks far below P, a stack of mostly dependent rows past the
    panel's budget, full rank over 33 words): bit for bit gf2core, rank
    pivots, about rank / 64 passes and one more per 512 rows walked."""
    from symmer_torch.native import gf2core

    rng = np.random.default_rng(R + W)
    M = np.zeros((R, W), np.uint64)
    basis = pack.pack_bits(rng.random((max(rank_bits, 1), W * 64)) < 0.3, W * 64)
    if rank_bits:
        picks = rng.random((R, basis.shape[0])) < 0.5
        for j in range(basis.shape[0]):
            M[picks[:, j]] ^= basis[j]
    got, passes = blocked_rref_model(M)
    want = M.copy()
    gf2core.rref_inplace(want)
    assert np.array_equal(got, want)
    rank = int(want.any(axis=1).sum())
    assert sum(passes) == rank and max(passes) <= 64
    # zero rows cost no pass: a zero stack is one empty panel
    assert len(passes) <= -(-rank // 64) + -(-R // RREF_BUDGET) + 1


# -- row_signature.cu (K2) ---------------------------------------------------

# the kernel's constants: lane multipliers and seeds, the two mix rounds
SIG_MULT = (0x1E3779B1, 0x045D9F3B, 0x2C1B3C6D, 0x297A2D39)
SIG_INIT = (0x811C9DC5, 0xDEADBEEF, 0x1B873593, 0x165667B1)
SIG_MIX = (0x7FEB352D, 0x6C8E9CF5)


def sig_split(W, aligned=True):
    """(words a unit, units a row, log2 of the lanes a row): one 16-byte
    unit of two words where W is even and the planes aligned, else one
    word; the lanes the power of two at or above the units, at most 32."""
    V = 2 if W % 2 == 0 and aligned else 1
    units = 2 * W // V
    log2 = 0
    while (1 << log2) < units and log2 < 5:
        log2 += 1
    return V, units, log2


def sig_model(x, z, aligned=True):
    """K2 as the kernel computes it, in uint32: each lane of a row's group
    hashes its units' half-words in four lanes with position constants
    computed in registers, then the group's xor-shuffle tree adds the lanes'
    sums and its first lane assembles ka, kb."""
    u32 = np.uint32
    T, W = x.shape
    V, units, log2 = sig_split(W, aligned)
    L = 1 << log2
    words = np.concatenate([x, z], axis=1).view(np.uint64)
    acc = np.zeros((T, L, 4), u32)
    for u in range(units):
        for e in range(2 * V):
            j = u * 2 * V + e  # the half-word's place in the row
            h = ((words[:, j // 2] >> np.uint64(32 * (j % 2))) & np.uint64(0xFFFFFFFF)).astype(u32)
            for lane in range(4):
                p = u32((j + SIG_INIT[lane]) * 0x9E3779B9 % (1 << 32))
                p ^= p >> u32(16)
                v = (h ^ p) * u32(SIG_MULT[lane])
                v = (v ^ (v >> u32(15))) * u32(SIG_MIX[0])
                v = (v ^ (v >> u32(13))) * u32(SIG_MIX[1])
                acc[:, u % L, lane] += v ^ (v >> u32(16))
    o = L >> 1
    while o:  # __shfl_xor_sync over the group's lanes
        acc = acc + acc[:, np.arange(L) ^ o]
        o >>= 1
    a = acc[:, 0].astype(np.uint64)
    top = np.uint64(0x80000000)
    ka = (((a[:, 0] ^ top) << np.uint64(32)) | a[:, 1]).view(np.int64)
    kb = (((a[:, 2] ^ top) << np.uint64(32)) | a[:, 3]).view(np.int64)
    return ka, kb


def sig_rows_visited(T, W, grid_warps, aligned=True):
    """How often the grid's warps visit each row: warp w takes the rows
    from w * R on, R = 32 / lanes a row, striding by grid_warps * R."""
    _, _, log2 = sig_split(W, aligned)
    R = 32 >> log2
    seen = np.zeros(T, np.int64)
    for w in range(grid_warps):
        for base in range(w * R, T, grid_warps * R):
            for lane in range(32):
                row = base + (lane >> log2)
                if row < T and lane & ((1 << log2) - 1) == 0:
                    seen[row] += 1
    return seen


@pytest.mark.parametrize("W", [1, 2, 3, 16, 17, 33])
@pytest.mark.parametrize("T", [1, 31, 33, 1000])
def test_signature_model_equals_plain(W, T):
    rng = np.random.default_rng(10 * W + T)
    x = rng.integers(0, 1 << 64, (T, W), dtype=np.uint64).view(np.int64)
    z = rng.integers(0, 1 << 64, (T, W), dtype=np.uint64).view(np.int64)
    ka, kb = torch_core.row_signature(torch.from_numpy(x), torch.from_numpy(z))
    for aligned in (True, False):  # the 16-byte units, and one word a unit
        ma, mb = sig_model(x, z, aligned)
        assert np.array_equal(ma, ka.numpy()) and np.array_equal(mb, kb.numpy())
    for grid_warps in (1, 3, 64):  # one wave of warps striding over the rows
        assert (sig_rows_visited(T, W, grid_warps) == 1).all()


@pytest.mark.parametrize("W", [1, 16, 17])
def test_signature_model_on_all_zero_and_all_one_words(W):
    for fill in (0, -1):
        x = np.full((33, W), fill, np.int64)
        z = np.full((33, W), -1 - fill, np.int64)
        z[:3] = fill  # rows of one kind and rows of both
        ka, kb = torch_core.row_signature(torch.from_numpy(x), torch.from_numpy(z))
        ma, mb = sig_model(x, z)
        assert np.array_equal(ma, ka.numpy()) and np.array_equal(mb, kb.numpy())


def test_cleanup_goes_through_the_signature_wrapper(monkeypatch):
    """Every cleanup outside the fused route (cuda.small_fused; here off:
    cuda.FUSED_WORDS set to -1) takes its keys from cuda.row_signature (K2
    on a card; the plain version for these CPU tensors), once a call."""
    from symmer_torch.kernels import cuda

    monkeypatch.setattr(cuda, "FUSED_WORDS", -1)
    calls = []
    plain = cuda.row_signature
    monkeypatch.setattr(cuda, "row_signature", lambda x, z: calls.append(x.shape) or plain(x, z))
    rng = np.random.default_rng(3)
    base = rng.integers(-2**62, 2**62, (40, 3))
    x = torch.from_numpy(base[rng.integers(0, 40, 100)])
    z = torch.zeros_like(x)
    cr = torch.from_numpy(rng.normal(size=100))
    ci = torch.zeros(100, dtype=torch.float64)
    out = torch_core.cleanup_sorted(x, z, cr, ci)
    keyed = torch_core.cleanup_keyed(x, z, cr, ci)
    state = torch_state.cleanup_state(x, cr, ci)
    assert calls == [(100, 3)] * 3
    assert out[0].shape[0] == keyed[0].shape[0] == state[0].shape[0] == len(np.unique(
        x.numpy(), axis=0))
    # the key the mesh routes by is the signature's first key
    assert torch.equal(keyed[4], torch_core.row_signature(keyed[0], keyed[1])[0])


# -- route_rows.cu (K16): the decoupled look-back ----------------------------

ROUTE_COUNT, ROUTE_PREFIX = 1, 2  # the flags of a status word


def look_back_model(tile_counts, order_rng, lanes=32, per_lane=8, stale=None):
    """The tiles' look-back with the blocks' steps interleaved at random.

    Each tile publishes its count (tile 0 its inclusive prefix), then walks
    back a window of lanes * per_lane status words at a time: the window
    waits until every word in it is published in this call's epoch (words
    left by an earlier call, `stale`, carry the last epoch and read as not
    published), each lane finds its nearest inclusive prefix among its
    words and adds the counts after it, the nearest lane with a prefix ends
    the walk.  Returns each tile's count of kept rows before it."""
    B = len(tile_counts)
    epoch = 7
    status = [(epoch - 1, ROUTE_PREFIX, v) for v in stale] if stale is not None else \
        [(0, 0, 0)] * B
    state = {t: ("publish", t - 1, 0) for t in range(B)}
    before = [None] * B
    while state:
        t = int(order_rng.choice(list(state)))
        step, j, acc = state[t]
        if step == "publish":
            flag = ROUTE_PREFIX if t == 0 else ROUTE_COUNT
            status[t] = (epoch, flag, tile_counts[t])
            if t == 0:
                before[0] = 0
                del state[t]
            else:
                state[t] = ("walk", j, 0)
            continue
        words = []
        for lane in range(lanes):
            row = []
            for r in range(per_lane):
                p = j - lane * per_lane - r
                row.append((epoch, ROUTE_PREFIX, 0) if p < 0 else status[p])
            words.append(row)
        if any(w[0] != epoch or w[1] == 0 for row in words for w in row):
            continue  # a word in the window is not published yet: spin
        parts, found = [], []
        for row in words:
            part, hit = 0, False
            for w in row:
                if not hit:
                    part += w[2]
                hit |= w[1] == ROUTE_PREFIX
            parts.append(part)
            found.append(hit)
        stop = found.index(True) if any(found) else lanes - 1
        acc += sum(parts[:stop + 1])
        if any(found):
            before[t] = acc
            status[t] = (epoch, ROUTE_PREFIX, acc + tile_counts[t])
            del state[t]
        else:
            state[t] = ("walk", j - lanes * per_lane, acc)
    return before


def route_model(key, k, bit, tile_rows, before_tile):
    """Each row's side and place as the kernel scatters it: per tile of
    tile_rows rows, 8 warps of 32-row chunks, one ballot mask a chunk; a
    kept row goes to the kept rows before it, a sent row i to i minus them."""
    n = len(key)
    go = ((key >> k) & 1) == bit
    side, place = np.zeros(n, bool), np.zeros(n, np.int64)
    chunks = tile_rows // 256
    for t, base in enumerate(before_tile):
        r0, r1 = t * tile_rows, min(n, (t + 1) * tile_rows)
        masks = {}
        for warp in range(8):
            w0 = r0 + warp * chunks * 32
            for c in range(chunks):
                rows = range(w0 + c * 32, min(w0 + c * 32 + 32, r1))
                masks[(warp, c)] = sum(1 << (i - w0 - c * 32) for i in rows if go[i])
        kept_warp = [sum(bin(masks[(w, c)]).count("1") for c in range(chunks)) for w in range(8)]
        for warp in range(8):
            kept_before = base + sum(kept_warp[:warp])
            w0 = r0 + warp * chunks * 32
            for c in range(chunks):
                m = masks[(warp, c)]
                for lane in range(32):
                    i = w0 + c * 32 + lane
                    if i >= r1:
                        break
                    ki = kept_before + bin(m & ((1 << lane) - 1)).count("1")
                    side[i] = (m >> lane) & 1
                    place[i] = ki if side[i] else i - ki
                kept_before += bin(m).count("1")
    return side, place


@pytest.mark.parametrize("n,tile_rows,lanes,per_lane", [
    (1, 256, 32, 2), (5000, 256, 32, 2), (20_000, 256, 2, 2), (20_000, 512, 4, 1),
    (70_000, 256, 32, 2), (3000, 768, 1, 1)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_look_back_model_gives_exclusive_prefixes_and_route_rows(n, tile_rows, lanes, per_lane,
                                                                seed):
    """Tiles finishing in random orders (a window of lanes x per_lane status
    words: the kernel's 32 x 2, and narrow ones that walk many windows),
    status words left by an earlier call: every tile gets the exclusive
    prefix of the kept counts, and the scatter by those places is
    torch_core.route_rows's, counts included."""
    rng = np.random.default_rng(seed)
    W, k, bit = 2, 5, int(seed % 2)
    x = rng.integers(-2**62, 2**62, (n, W))
    z = rng.integers(-2**62, 2**62, (n, W))
    c = rng.normal(size=(2, n))
    key = rng.integers(-2**62, 2**62, n)
    go = ((key >> k) & 1) == bit
    B = -(-n // tile_rows)
    tile_counts = [int(go[t * tile_rows:(t + 1) * tile_rows].sum()) for t in range(B)]
    stale = rng.integers(0, n + 1, B)
    before = look_back_model(tile_counts, rng, lanes, per_lane, stale=stale)
    assert before == [int(v) for v in np.concatenate([[0], np.cumsum(tile_counts)[:-1]])]
    side, place = route_model(key, k, bit, tile_rows, before)
    kept = int(go.sum())
    got = {s: [np.zeros((n, W), np.int64), np.zeros((n, W), np.int64), np.zeros(n), np.zeros(n)]
           for s in (True, False)}
    for src, idx in ((x, 0), (z, 1), (c[0], 2), (c[1], 3)):
        for s in (True, False):
            got[s][idx][place[side == s]] = src[side == s]
    bufs = [tuple(torch.zeros_like(torch.from_numpy(a)) for a in got[s]) for s in (True, False)]
    counts = torch_core.route_rows(torch.from_numpy(x), torch.from_numpy(z),
                                   torch.from_numpy(c[0]), torch.from_numpy(c[1]),
                                   torch.from_numpy(key), k, bit, *bufs)
    assert counts.tolist() == [kept, n - kept]
    for s, m, plain in ((True, kept, bufs[0]), (False, n - kept, bufs[1])):
        for a, b in zip(got[s], plain):
            assert np.array_equal(a[:m], b.numpy()[:m])


# -- pair_products.cu (K4): the product rows' signatures and coefficients ----

PAIR_THREADS, PAIR_PER_THREAD, PAIR_LOG2_TILE, PAIR_SHARED = 256, 4, 10, 32 * 1024


def ceil_log2(n, cap):
    log2 = 0
    while (1 << log2) < n and log2 < cap:
        log2 += 1
    return log2


def pair_tiles(M1, M2, W):
    """(ti, tj, words a chunk): tj = 32 operand-2 rows or fewer where M2 is
    smaller, ti the rest of the 1,024 pairs, or fewer where M1 is smaller
    and then tj up to the rest; the chunk of words whose rows and position
    constants fit the block's 32 KB."""
    log2_tj = ceil_log2(M2, 5)
    log2_ti = PAIR_LOG2_TILE - log2_tj
    log2_m1 = ceil_log2(M1, PAIR_LOG2_TILE)
    if log2_ti > log2_m1:
        log2_ti = log2_m1
        log2_tj = ceil_log2(M2, PAIR_LOG2_TILE - log2_ti)
    ti, tj = 1 << log2_ti, 1 << log2_tj
    qc = max(1, min(W, PAIR_SHARED // (16 * (ti + tj) + 64)))
    return ti, tj, qc


def pair_writes(M1, M2, W):
    """How often the blocks write each pair: block b takes tile (b // tiles_j,
    b % tiles_j), thread t its pairs p = t + 256 k, j fastest, the live ones
    (p < ti tj) inside the operands."""
    ti, tj, _ = pair_tiles(M1, M2, W)
    tiles_j = -(-M2 // tj)
    seen = np.zeros(M1 * M2, np.int64)
    p = (np.arange(PAIR_THREADS)[None, :] + PAIR_THREADS * np.arange(PAIR_PER_THREAD)[:, None])
    p = p.ravel()
    for tile in range(-(-M1 // ti) * tiles_j):
        i = (tile // tiles_j) * ti + p // tj
        j = (tile % tiles_j) * tj + p % tj
        ok = (p < ti * tj) & (i < M1) & (j < M2)
        np.add.at(seen, i[ok] * M2 + j[ok], 1)
    return seen


def sig_position(j, lane):
    p = np.uint32((j + SIG_INIT[lane]) * 0x9E3779B9 % (1 << 32))
    return p ^ (p >> np.uint32(16))


def sig_mix(h, p, lane):
    u32 = np.uint32
    v = (h ^ p) * u32(SIG_MULT[lane])
    v = (v ^ (v >> u32(15))) * u32(SIG_MIX[0])
    v = (v ^ (v >> u32(13))) * u32(SIG_MIX[1])
    return v ^ (v >> u32(16))


def pair_model(x1, z1, c1, x2, z2, c2):
    """K4 as the kernel computes it, every pair at once: the words in chunks,
    per word the XOR products, the power of i and the sign's popcount added
    in uint32, the four half-words hashed in four lanes with the chunk's
    position constants; then the coefficient, each product and the sum or
    difference rounded apart, negated for an odd sign and turned by i^(k mod
    4).  Returns (ka, kb, pr, pi) in pair order i * M2 + j."""
    u32, u64 = np.uint32, np.uint64
    M1, W = x1.shape
    M2 = x2.shape[0]
    I, J = np.divmod(np.arange(M1 * M2), M2)
    acc = np.zeros((M1 * M2, 4), u32)
    ipow = np.zeros(M1 * M2, u32)
    par = np.zeros(M1 * M2, u32)
    _, _, qc = pair_tiles(M1, M2, W)
    for q0 in range(0, W, qc):
        for q in range(q0, min(W, q0 + qc)):
            a, b = x1.view(u64)[I, q], z1.view(u64)[I, q]
            c, d = x2.view(u64)[J, q], z2.view(u64)[J, q]
            xo, zo = a ^ c, b ^ d
            ipow += u32(3) * (popc(a & b) + popc(c & d)).astype(u32) + popc(xo & zo).astype(u32)
            par += popc(a & d).astype(u32)
            for w, base in ((xo, 2 * q), (zo, 2 * (W + q))):
                for half in (0, 1):
                    h = ((w >> u64(32 * half)) & u64(0xFFFFFFFF)).astype(u32)
                    for lane in range(4):
                        acc[:, lane] += sig_mix(h, sig_position(base + half, lane), lane)
    a, b, c, d = c1.real[I], c1.imag[I], c2.real[J], c2.imag[J]
    re, im = a * c - b * d, a * d + b * c
    odd = (par & u32(1)).astype(bool)
    re, im = np.where(odd, -re, re), np.where(odd, -im, im)
    k = ipow & u32(3)
    pr = np.select([k == 0, k == 1, k == 2], [re, -im, -re], im)
    pi = np.select([k == 0, k == 1, k == 2], [im, re, -im], -re)
    a64 = acc.astype(u64)
    top = u64(0x80000000)
    ka = (((a64[:, 0] ^ top) << u64(32)) | a64[:, 1]).view(np.int64)
    kb = (((a64[:, 2] ^ top) << u64(32)) | a64[:, 3]).view(np.int64)
    return ka, kb, pr, pi


@pytest.mark.parametrize("M1,M2,W", [(1, 1, 1), (7, 5, 3), (40, 33, 16), (1, 70, 2),
                                     (70, 1, 1), (3, 2, 17), (2, 600, 1)])
def test_pair_model_equals_plain(M1, M2, W):
    """The model's keys and coefficients bit for bit torch_core.pair_products
    (signed zeros and the four powers of i included), each pair written by
    one thread of one block."""
    rng = np.random.default_rng(M1 * 1000 + M2 * 10 + W)
    x1, z1 = (rng.integers(-2**63, 2**63 - 1, (M1, W), endpoint=True) for _ in range(2))
    x2, z2 = (rng.integers(-2**63, 2**63 - 1, (M2, W), endpoint=True) for _ in range(2))
    c1 = rng.normal(size=M1) + 1j * rng.normal(size=M1)
    c2 = rng.normal(size=M2) + 1j * rng.normal(size=M2)
    c1[0] = complex(0.0, -0.0)  # signed zeros through the products and negations
    want = torch_core.pair_products(tt(x1), tt(z1), tt(c1.real), tt(c1.imag),
                                    tt(x2), tt(z2), tt(c2.real), tt(c2.imag))
    got = pair_model(x1, z1, c1, x2, z2, c2)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g).view(np.int64), w.numpy().view(np.int64))
    assert (pair_writes(M1, M2, W) == 1).all()


@pytest.mark.parametrize("M1,M2", [(1, 1), (1, 3000), (3000, 1), (3, 5), (500, 500),
                                   (33, 1025), (2, 2)])
def test_pair_tiles_write_every_pair_once(M1, M2):
    ti, tj, qc = pair_tiles(M1, M2, 16)
    assert ti * tj <= 1 << PAIR_LOG2_TILE and 1 <= qc <= 16
    assert (16 * (ti + tj) + 64) * qc <= PAIR_SHARED or qc == 1
    assert (pair_writes(M1, M2, 16) == 1).all()


# -- merge_groups.cu (K3): the sums over sorted positions, the compaction ----

MERGE_THREADS = 256
MERGE_SHORT, MERGE_SPAN = 32, 8  # merge_groups.cu's kShort, kSpan


def merge_sums_model(perm, kas, kb, cr, ci, threshold, live=None, check=True):
    """Pass A, a thread a sorted position: perm and the sorted keys kas read
    in order (the predecessor's from the lane below), kb through perm only
    where a position's kas equals its predecessor's (both neighbours'; with
    `check`, unequal kb there is a split run, reported); a head (keys
    unlike its predecessor's) sums its group's first MERGE_SHORT rows from
    +0.0 one coefficient at a time in sorted order, a dead row (live flags)
    adding +0.0; where the group goes on, its warp loads MERGE_SPAN chunks
    of 32 positions at a time, the group's rows a prefix of each chunk, adds
    them on one by one and, while the group has no live row yet, takes the
    first live lane's row (a ballot); the head tests hypot against the
    threshold and writes the sum and its keep flag at the group's first
    live row.  Without flags every other row's flag is 0 (each written
    once); with them the flags start at 0 (zeroed before the launch) and
    only the kept groups' rows are written, once each.  Returns (keep,
    sums, split)."""
    T = len(perm)
    keep = np.full(T, 2 if live is None else 0, np.int8)  # 2: never written
    sums = np.full((2, T), np.nan)
    kb_reads = set()

    def kb_of(q):  # kb through perm: only at a position whose kas repeats
        assert q > 0 and kas[q] == kas[q - 1] or q + 1 < T and kas[q + 1] == kas[q]
        kb_reads.add(q)
        return kb[perm[q]]

    same = lambda q, p: kas[q] == kas[p] and kb_of(q) == kb_of(p)
    on = (lambda g: True) if live is None else (lambda g: bool(live[g]))
    add = lambda g: (cr[g], ci[g]) if on(g) else (0.0, 0.0)
    written = np.zeros(T, np.int64)
    split = False
    for p in range(T):
        i = perm[p]
        if p and kas[p - 1] == kas[p]:
            if kb_of(p - 1) == kb_of(p):
                if live is None:
                    assert keep[i] == 2
                    keep[i] = 0
                continue
            split |= check
        re, im = 0.0 + add(i)[0], 0.0 + add(i)[1]
        rep = i if on(i) else None
        q = p + 1
        while q < T and q < p + MERGE_SHORT and same(q, p):
            g = perm[q]
            re, im = re + add(g)[0], im + add(g)[1]
            rep = g if rep is None and on(g) else rep
            q += 1
        more = q == p + MERGE_SHORT and q < T
        while more:  # the warp, MERGE_SPAN chunks a load
            for u in range(MERGE_SPAN):
                if not more:
                    break
                lanes = [q + lane < T and same(q + lane, p) for lane in range(32)]
                n = lanes.index(False) if False in lanes else 32
                assert check or not any(lanes[n:])  # the group's rows: a prefix of the chunk
                ballot = [lane for lane in range(n) if on(perm[q + lane])]
                if rep is None and ballot:
                    rep = perm[q + ballot[0]]
                for s in range(q, q + n):
                    re, im = re + add(perm[s])[0], im + add(perm[s])[1]
                q += n
                more = n == 32
        kept = rep is not None and (threshold is None or bool(np.hypot(re, im) > threshold))
        if live is None:
            assert keep[i] == 2 and rep == i
            keep[i] = kept
        elif kept:
            keep[rep] = 1
            written[rep] += 1
        if kept:
            sums[:, rep] = re, im
    assert (keep != 2).all()  # perm is a permutation: every flag written once
    assert (written <= 1).all()
    return keep.astype(bool), sums, split


def source_word(rows, plane, r, u):
    """Word u of plane (0: x, 1: z) of row r of a row source
    (cuda.row_source): planes, a product's operands, a rotation's rows and
    their P Q twins, masked rows."""
    if len(rows) == 2:
        return rows[plane][r, u]
    if len(rows) == 3:
        return rows[plane][r, u] & rows[2][u]
    if rows[2].ndim == 1:  # rotation: M2 = T / 2, the input rows
        M = rows[0].shape[0]
        return rows[plane][r % M, u] ^ (rows[2 + plane][u] if r >= M else 0)
    a, b = divmod(r, rows[2].shape[0])
    return rows[plane][a, u] ^ rows[2 + plane][b, u]


def merge_model(perm, kas, ka, kb, cr, ci, threshold, rows, tile_rows, rng, live=None,
                check=True):
    """K3's two passes: pass A's sums and flags, the count the host reads
    (None where pass A reports a split run: pass B does not run), then pass
    B over tiles of input order finishing in a random order: the
    look-back's prefix of kept rows before each tile, each kept row's place
    from its warp's ballot masks (route_model's scatter with the flags as
    the key), its row copied by a group of lanes (a word of x and z a lane)
    from its source."""
    keep, sums, split = merge_sums_model(perm, kas, kb, cr, ci, threshold, live, check)
    if split:
        return None
    n = int(keep.sum())
    T = len(perm)
    counts = [int(keep[t:t + tile_rows].sum()) for t in range(0, T, tile_rows)]
    before = look_back_model(counts, rng, stale=rng.integers(0, T + 1, len(counts)))
    side, place = route_model(keep.astype(np.int64), 0, 1, tile_rows, before)
    assert np.array_equal(side, keep)
    W = rows[0].shape[1]
    out = np.zeros((2, n, W), np.int64)
    L = 1 << ceil_log2(W, 5)
    for r in np.flatnonzero(keep):  # lane li of the row's group: words li, li + L, ...
        for li in range(L):
            for u in range(li, W, L):
                for plane in (0, 1):
                    out[plane, place[r], u] = source_word(rows, plane, r, u)
    order = np.argsort(place[keep])
    kept_rows = np.flatnonzero(keep)[order]
    return out[0], out[1], sums[0, kept_rows], sums[1, kept_rows], ka[kept_rows]


def merge_case(rng, T, W, uniq, long_group=0, cancel=0):
    """Rows drawn from `uniq` distinct rows (the first `long_group` rows all
    one row, and no other), coefficients with groups that cancel exactly,
    exact zeros."""
    base = rng.integers(-2**62, 2**62, (uniq, 2, W))
    idx = rng.integers(0, uniq, T)
    if long_group:
        idx[idx == 0] = 1
        idx[:long_group] = 0
    x, z = base[idx, 0], base[idx, 1]
    c = rng.normal(size=(2, T))
    c[:, rng.random(T) < 0.1] = 0.0
    for k in range(cancel):  # a lone pair of rows whose coefficients cancel
        row = rng.integers(-2**62, 2**62, (2, W))
        x[2 * k:2 * k + 2], z[2 * k:2 * k + 2] = row[0], row[1]
        c[:, 2 * k + 1] = -c[:, 2 * k]
    return x, z, c


def sorted_by(sort, ka, kb):
    """(perm, kas, check) of a merge's sort: "ka", K17's stable sort by ka
    alone (torch_core.sort_keys) under K3's split check; "lexsort", the
    parent's sort by (ka, kb) (torch_core._lexsort) without it."""
    if sort == "ka":
        perm, kas = torch_core.sort_keys(ka)
        return perm, kas, True
    perm = torch_core._lexsort(ka, kb)
    return perm, ka[perm], False


def parent_merge(ka, kb, cr, ci, th, rows, live=None):
    """torch_core.merge_groups after the parent's sort by (ka, kb)."""
    perm = torch_core._lexsort(ka, kb)
    return torch_core.merge_groups(perm, ka[perm], ka, kb, cr, ci, th, rows, live, False)


@pytest.mark.parametrize("T,W,uniq,th,long_group,cancel,tile_rows", [
    (1, 1, 1, 1e-12, 0, 0, 256), (1, 3, 1, None, 0, 0, 256),
    (700, 2, 150, 1e-12, 520, 4, 256), (700, 2, 150, None, 520, 4, 256),
    (3000, 1, 40, 1e-12, 0, 10, 512), (3000, 16, 2800, None, 0, 30, 256),
    (900, 3, 100, 0.5, 0, 0, 768), (400, 2, 300, 1e-12, 32, 0, 256),
    (400, 2, 300, 1e-12, 33, 0, 256), (600, 1, 300, None, 288, 0, 256),
    (600, 1, 300, 0.5, 289, 0, 256)])
@pytest.mark.parametrize("sort", ["ka", "lexsort"])
def test_merge_model_equals_plain(T, W, uniq, th, long_group, cancel, tile_rows, sort):
    """The model of K3's two passes bit for bit torch_core.merge_groups,
    after K17's sort by ka (checked) and after the parent's sort by (ka,
    kb), both the parent's output: a group of 520 rows summed one by one,
    groups of 32 and 33 rows (the head alone, then its warp) and of 288 and
    289 (a warp's load of 256 more rows ending at a chunk's edge and one
    past it), groups that cancel to zero, exact zeros kept under
    zero_threshold=None, T = 1, the tiles' look-back in a random order."""
    rng = np.random.default_rng(T + W + uniq)
    x, z, c = merge_case(rng, T, W, uniq, long_group, cancel)
    X, Z, CR, CI = tt(x), tt(z), tt(c[0]), tt(c[1])
    ka, kb = torch_core.row_signature(X, Z)
    perm, kas, check = sorted_by(sort, ka, kb)
    want = parent_merge(ka, kb, CR, CI, th, (X, Z))
    same_arrays(torch_core.merge_groups(perm, kas, ka, kb, CR, CI, th, (X, Z), None, check), want)
    got = merge_model(perm.numpy(), kas.numpy(), ka.numpy(), kb.numpy(), c[0], c[1], th, (x, z),
                      tile_rows, rng, None, check)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g).view(np.int64), w.numpy().view(np.int64))


@pytest.mark.parametrize("M1,M2,W,th", [(30, 20, 3, 1e-12), (1, 9, 1, None), (12, 1, 16, None)])
@pytest.mark.parametrize("sort", ["ka", "lexsort"])
def test_merge_model_pair_rows_equal_plain(M1, M2, W, th, sort):
    """The survivors' rows rebuilt from their pairs (x1[r // M2] ^ x2[r %
    M2]), bit for bit merge_groups on the pair source and on the product
    planes."""
    rng = np.random.default_rng(M1 * M2 + W)
    x1, z1 = (rng.integers(-2**62, 2**62, (M1, W)) for _ in range(2))
    x2, z2 = (rng.integers(-2**62, 2**62, (M2, W)) for _ in range(2))
    if M1 > 1:
        x1[1] = x1[0]  # a repeated row: products that fall together
    c = rng.normal(size=(4, max(M1, M2)))
    args = [tt(a) for a in (x1, z1, c[0, :M1], c[1, :M1], x2, z2, c[2, :M2], c[3, :M2])]
    ka, kb, pr, pi = torch_core.pair_products(*args)
    perm, kas, check = sorted_by(sort, ka, kb)
    rows = (args[0], args[1], args[4], args[5])
    want = torch_core.merge_groups(perm, kas, ka, kb, pr, pi, th, rows, None, check)
    same_arrays(want, parent_merge(ka, kb, pr, pi, th, rows))
    xo = (x1[:, None] ^ x2[None]).reshape(-1, W)
    zo = (z1[:, None] ^ z2[None]).reshape(-1, W)
    flat = torch_core.merge_groups(perm, kas, ka, kb, pr, pi, th, (tt(xo), tt(zo)), None, check)
    got = merge_model(perm.numpy(), kas.numpy(), ka.numpy(), kb.numpy(), pr.numpy(), pi.numpy(),
                      th, (x1, z1, x2, z2), 256, rng, None, check)
    for g, w, f in zip(got, want, flat):
        assert np.array_equal(np.asarray(g).view(np.int64), w.numpy().view(np.int64))
        assert torch.equal(w, f)


@pytest.mark.parametrize("L,dead", [(32, [0]), (33, [0, 31]), (33, list(range(32))),
                                    (288, list(range(40))), (289, list(range(288))),
                                    (289, list(range(0, 289, 2))), (300, list(range(300))),
                                    (520, list(range(257)))])
@pytest.mark.parametrize("th", [1e-12, None])
@pytest.mark.parametrize("sort", ["ka", "lexsort"])
def test_merge_model_live_flags_equal_plain(L, dead, th, sort):
    """Pass A with live flags, bit for bit torch_core.merge_groups with them:
    a group of L rows (the head alone up to 32, then its warp; 288 and 289:
    a load of 256 more ending at a chunk's edge and one past it) whose
    dead rows are its head, its first 32 or 288, every other one or all of
    it, its rows interleaved with groups of a few rows with dead rows too
    (so the order of the outputs shows which row represents a group), exact
    zeros kept under None."""
    rng = np.random.default_rng(L + len(dead))
    T, W = L + 300, 2
    x, z, c = merge_case(rng, T, W, 120, L)  # the long group: rows 0 .. L - 1
    order = np.argsort(np.concatenate([2 * np.arange(L), 2 * np.arange(T - L) + 1]),
                       kind="stable")  # ... interleaved with the others
    x, z, c = x[order], z[order], c[:, order]
    X, Z, CR, CI = tt(x), tt(z), tt(c[0]), tt(c[1])
    ka, kb = torch_core.row_signature(X, Z)
    perm, kas, check = sorted_by(sort, ka, kb)
    live = rng.random(T) < 0.7
    live[np.argsort(order)[np.asarray(dead, np.int64)]] = False
    want = parent_merge(ka, kb, CR, CI, th, (X, Z), torch.from_numpy(live))
    same_arrays(torch_core.merge_groups(perm, kas, ka, kb, CR, CI, th, (X, Z),
                                        torch.from_numpy(live), check), want)
    got = merge_model(perm.numpy(), kas.numpy(), ka.numpy(), kb.numpy(), c[0], c[1], th, (x, z),
                      256, rng, live, check)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g).view(np.int64), w.numpy().view(np.int64))


# -- sort_keys.cu (K17): a partition on the split digit, then each bucket ---

SORT_THREADS, SORT_WARPS, SORT_BITS = 256, 8, 8  # sort_keys.cu's kThreads, kWarps, kBits
SORT_ITEMS, SORT_SMALL_ITEMS, SORT_WINDOW = 8, 16, 16  # kItems, kSmallItems, kWindow
SORT_COMPARE = 64  # kCompare
SORT_SIGN = np.uint64(1 << 63)


def sort_digits(u, shift, width=SORT_BITS):
    return ((u >> np.uint64(shift)) & np.uint64((1 << width) - 1)).astype(np.int64)


def tile_rank_model(d, rounds, width=SORT_BITS):
    """A tile's stable ranking by digit (rank_tile): (place of each of the
    tile's n keys in the tile in digit order, the tile's digit counts, their
    exclusive starts).  Warp w holds keys w * 32 * rounds + r * 32 + lane;
    round r of a warp finds each lane's peers (the lanes of its digit) with
    one ballot a digit bit (width of them), ranks a key after its warp's
    earlier keys of its digit (uint16 counters, updated by the peers' lowest
    lane) and its lower peers; the warps' counters become exclusive offsets,
    the bins' counts (a thread a bin) an exclusive block scan (warp
    shuffles, then the warps' sums)."""
    bins, n = 1 << SORT_BITS, len(d)
    assert n <= SORT_THREADS * rounds and d.max(initial=0) < 1 << width
    D = np.zeros(SORT_THREADS * rounds, np.int64)
    D[:n] = d
    D = D.reshape(SORT_WARPS, rounds, 32)
    V = (np.arange(SORT_THREADS * rounds) < n).reshape(SORT_WARPS, rounds, 32)
    lane_bit = np.int64(1) << np.arange(32, dtype=np.int64)
    full = np.int64(0xFFFFFFFF)
    peers = np.broadcast_to((V * lane_bit).sum(-1, keepdims=True), D.shape).copy()
    for b in range(width):
        bit = (D >> b) & 1 == 1
        m = (bit * lane_bit).sum(-1, keepdims=True)
        peers &= np.where(bit, m, ~m & full)
    cnt = np.zeros((SORT_WARPS, bins), np.int64)
    rank = np.zeros(D.shape, np.int64)
    wi = np.arange(SORT_WARPS)[:, None]
    lanes = np.arange(32)
    for r in range(rounds):
        d_r, v_r, p_r = D[:, r], V[:, r], peers[:, r]
        old = np.where(v_r, cnt[wi, d_r], 0)
        rank[:, r] = old + popc(p_r & (lane_bit - 1))
        lead = v_r & (lanes == popc((p_r & -p_r) - 1))  # the lowest peer
        cnt[np.broadcast_to(wi, d_r.shape)[lead], d_r[lead]] = (old + popc(p_r))[lead]
    assert cnt.max() < 1 << 16  # uint16 counters
    off = np.cumsum(cnt, axis=0) - cnt  # the warps' exclusive offsets, a bin
    count = cnt.sum(axis=0)
    sums = count.reshape(SORT_WARPS, 32)  # thread t owns bin t
    incl = np.cumsum(sums, axis=1)  # the shuffle scan in each warp
    warp_sum = incl[:, -1]
    start = ((np.cumsum(warp_sum) - warp_sum)[:, None] + incl - sums).reshape(-1)
    pos = start[D] + off[wi[:, :, None], D] + rank
    return pos.reshape(-1)[:n], count, start


def bin_look_back_model(status, at, t, epoch, done, base):
    """One look-back step of every bin of tile t not done: bin b reads the
    words of bin b of the SORT_WINDOW tiles at[t][b], at[t][b] - 1, ...
    (below tile 0: an inclusive prefix of 0); it waits while one of them is
    unpublished in this call (another epoch, or no flag), else adds their
    counts up to its nearest inclusive prefix, which ends its walk, or walks
    on below the window."""
    bins = at.shape[1]
    b = np.arange(bins)
    words = []
    for r in range(SORT_WINDOW):
        p = at[t] - r
        pc, inside = np.maximum(p, 0), p >= 0
        words.append((np.where(inside, status["e"][pc, b], epoch),
                      np.where(inside, status["f"][pc, b], ROUTE_PREFIX),
                      np.where(inside, status["v"][pc, b], 0)))
    ready = ~done[t] & np.all([(e == epoch) & (f != 0) for e, f, _ in words], axis=0)
    acc, found = np.zeros(bins, np.int64), np.zeros(bins, bool)
    for _, f, v in words:
        acc += np.where(found, 0, v)
        found |= f == ROUTE_PREFIX
    base[t] = np.where(ready, base[t] + acc, base[t])
    done[t] |= ready & found
    at[t] = np.where(ready & ~found, at[t] - SORT_WINDOW, at[t])


def sort_pass_model(u, v, shift, hist, epoch, status, rng):
    """The partition (sort_partition_kernel) over tiles of SORT_THREADS *
    SORT_ITEMS keys taking their steps in a random order: a tile ranks its
    keys (tile_rank_model), publishes its digits' counts (tile 0 its
    inclusive prefixes from the histogram's exclusive scan), looks back, its
    bins apart (bin_look_back_model), each bin publishing its prefix when
    its walk ends; each key goes to its digit's base plus its place in the
    tile's digit order less the digit's start.  Status words of another
    epoch read as unpublished."""
    bins, tile_keys = 1 << SORT_BITS, SORT_THREADS * SORT_ITEMS
    T = len(u)
    tiles = -(-T // tile_keys)
    d = sort_digits(u, shift)
    ranks = [tile_rank_model(d[t * tile_keys:(t + 1) * tile_keys], SORT_ITEMS)
             for t in range(tiles)]
    starts = np.cumsum(hist) - hist
    base = np.zeros((tiles, bins), np.int64)
    done = np.zeros((tiles, bins), bool)
    at = np.repeat(np.arange(tiles)[:, None] - 1, bins, axis=1)
    state = dict.fromkeys(range(tiles), "publish")
    while state:
        t = int(rng.choice(list(state)))
        count = ranks[t][1]
        if state[t] == "publish":
            status["e"][t], status["v"][t] = epoch, count
            status["f"][t] = ROUTE_COUNT
            if t == 0:
                base[0], done[0] = starts, True
            state[t] = "walk"
        else:
            bin_look_back_model(status, at, t, epoch, done, base)
        status["f"][t] = np.where(done[t], ROUTE_PREFIX, status["f"][t])
        status["v"][t] = np.where(done[t], base[t] + count, status["v"][t])
        if done[t].all():
            del state[t]
    out_u, out_v = np.zeros_like(u), np.zeros_like(v)
    for t in range(tiles):
        pos, count, start = ranks[t]
        sl = slice(t * tile_keys, min(T, (t + 1) * tile_keys))
        g = base[t][d[sl]] + pos - start[d[sl]]
        out_u[g], out_v[g] = u[sl], v[sl]
    return out_u, out_v


def split_digit_model(u, hist):
    """(d*, below): the highest digit on which the keys differ (-1: none)
    and whether a lower one differs, read as the kernel reads them: digit p
    is constant iff the bin of key 0's digit p holds all T keys."""
    varies = [p for p in range(64 // SORT_BITS - 1, -1, -1)
              if hist[p][sort_digits(u[:1], p * SORT_BITS)[0]] != len(u)]
    return (varies[0] if varies else -1), len(varies) > 1


def bucket_items_model(T):
    """sort_keys.cu's bucket_items: 16 keys a thread (4,096 a block on
    chip) unless hash keys' largest bucket (mean T / 256 plus five standard
    deviations, plus 64) may pass that; then 24."""
    mean = T / (1 << SORT_BITS)
    return 16 if mean + 5.0 * np.sqrt(mean) + 64.0 <= 16.0 * SORT_THREADS else 24


def place_model(key, val, ranges, equal, out_u, out_v, written, stats):
    """place: each key p of a range [a, e) to a + #{smaller keys of the
    range} + #{equal keys before p}, or, where every key of the range is
    equal, to p (ranges grouped by size, each group's comparisons at once)."""
    by_size = {}
    for a, e in ranges:
        by_size.setdefault(e - a, []).append(a)
    for m, heads in by_size.items():
        idx = np.asarray(heads, np.int64)[:, None] + np.arange(m)
        at = idx
        if not equal and m > 1:
            k = key[idx]
            j = np.arange(m)
            smaller = k[:, None, :] < k[:, :, None]  # [range, p, j]: key j below key p
            before = (k[:, None, :] == k[:, :, None]) & (j[None, None, :] < j[None, :, None])
            at = idx[:, :1] + (smaller | before).sum(-1)
            stats["compared"] = max(stats.get("compared", 0), m)
        assert not written[at].any()
        written[at] = True
        out_u[at], out_v[at] = key[idx], val[idx]


def on_chip_model(u, v, items, rng, stats):
    """sort_on_chip: the n <= SORT_THREADS * items keys u (sign flipped) and
    indices v of one block, sorted stably.  Ranges come off a stack (the
    sub-ranges of a step pushed in a random order, as the block's atomics
    may push them); a range's varying bits are the OR of its keys' XOR with
    its first key; a range of equal keys stays, one of at most SORT_COMPARE
    keys is ranked by comparison, a larger one takes one radix step on its
    top varying bits (up to SORT_BITS; rank_tile at ceil(m / 256) rounds)
    and its sub-ranges are placed (equal keys where the step reached bit 0),
    ranked by comparison or pushed."""
    n = len(u)
    assert n <= SORT_THREADS * items
    key, val = u.copy(), v.copy()
    out_u, out_v = np.zeros_like(u), np.zeros_like(v)
    written = np.zeros(n, bool)
    stack = [(0, n)]
    while stack:
        lo, hi = stack.pop()
        m = hi - lo
        mask = int(np.bitwise_or.reduce(key[lo:hi] ^ key[lo]))
        if mask == 0 or m <= SORT_COMPARE:
            place_model(key, val, [(lo, hi)], mask == 0, out_u, out_v, written, stats)
            continue
        h = mask.bit_length() - 1
        shift = max(h - (SORT_BITS - 1), 0)
        width = h - shift + 1
        rounds = -(-m // SORT_THREADS)
        assert rounds <= items
        pos, count, start = tile_rank_model(sort_digits(key[lo:hi], shift, width), rounds, width)
        key[lo + pos], val[lo + pos] = key[lo:hi].copy(), val[lo:hi].copy()
        subs = [(lo + start[b], lo + start[b] + count[b]) for b in np.nonzero(count)[0]]
        big = [(a, e) for a, e in subs if shift > 0 and e - a > SORT_COMPARE]
        place_model(key, val, [r for r in subs if r not in big], shift == 0, out_u, out_v,
                    written, stats)
        assert len(stack) + len(big) <= n // (SORT_COMPARE + 1) + 1  # the stack's slots
        stats["steps"] = stats.get("steps", 0) + 1
        stats["pushed"] = stats.get("pushed", []) + [e - a for a, e in big]
        stack.extend(big[i] for i in rng.permutation(len(big)))
    assert written.all()
    return out_u, out_v


def through_memory_model(u, v, items, stats):
    """sort_through_memory: a bucket of more keys than a block holds on
    chip, sorted stably by one LSD pass for each window of up to SORT_BITS
    of its varying bits, lowest first: the window's bin counts, then tiles
    of SORT_THREADS * items keys in order, each ranked (tile_rank_model)
    and scattered after its digits' running bases."""
    n, tile = len(u), SORT_THREADS * items
    mask = int(np.bitwise_or.reduce(u ^ u[0]))
    while mask:
        shift = (mask & -mask).bit_length() - 1
        width = min(SORT_BITS, 64 - shift)
        mask = 0 if shift + width >= 64 else mask & ~((1 << (shift + width)) - 1)
        d = sort_digits(u, shift, width)
        h = np.bincount(d, minlength=1 << SORT_BITS)
        nxt = np.cumsum(h) - h
        out_u, out_v = np.zeros_like(u), np.zeros_like(v)
        for t0 in range(0, n, tile):
            dd = d[t0:t0 + tile]
            pos, count, start = tile_rank_model(dd, -(-len(dd) // SORT_THREADS), width)
            g = (nxt - start)[dd] + pos
            out_u[g], out_v[g] = u[t0:t0 + tile], v[t0:t0 + tile]
            nxt += count
        u, v = out_u, out_v
        stats["passes"] = stats.get("passes", 0) + 1
    return u, v


def sort_keys_model(keys, rng, stats):
    """K17: (perm, sorted keys) of u = key ^ 2^63.  Up to SORT_THREADS *
    SORT_SMALL_ITEMS keys, one block (on_chip_model on every key).  Above,
    the digit histograms, the partition on the split digit (its status
    words zeroed by the histogram launch, epoch 1), then each bucket of
    more than one key, where a digit below the split digit varies: on chip
    up to SORT_THREADS * bucket_items_model(T) keys, else through memory."""
    T = len(keys)
    u = keys.view(np.uint64) ^ SORT_SIGN
    v = np.arange(T, dtype=np.int64)
    if T <= SORT_THREADS * SORT_SMALL_ITEMS:
        out_u, out_v = on_chip_model(u, v, SORT_SMALL_ITEMS, rng, stats)
    else:
        hist = np.stack([np.bincount(sort_digits(u, p * SORT_BITS), minlength=1 << SORT_BITS)
                         for p in range(64 // SORT_BITS)])
        split, below = split_digit_model(u, hist)
        stats["split"] = split
        tiles = -(-T // (SORT_THREADS * SORT_ITEMS))
        status = {k: np.zeros((tiles, 1 << SORT_BITS), np.int64) for k in "efv"}
        p = max(split, 0)  # no digit varies: any digit gives the identity
        out_u, out_v = sort_pass_model(u, v, SORT_BITS * p, hist[p], 1, status, rng)
        if split > 0 and below:
            items, h = bucket_items_model(T), hist[split]
            starts = np.cumsum(h) - h
            for b in rng.permutation(np.nonzero(h > 1)[0]):
                sl = slice(starts[b], starts[b] + h[b])
                route = "on_chip" if h[b] <= SORT_THREADS * items else "memory"
                stats[route] = stats.get(route, 0) + 1
                sort_bucket = (on_chip_model(out_u[sl], out_v[sl], items, rng, stats)
                               if route == "on_chip" else
                               through_memory_model(out_u[sl], out_v[sl], items, stats))
                out_u[sl], out_v[sl] = sort_bucket
    return out_v.astype(np.int32), (out_u ^ SORT_SIGN).view(np.int64)


SORT_X, SORT_Y = 0x42, 0x17  # the top byte and the next of the skewed kinds below


def sort_case(rng, T, kind):
    """T int64 keys: "random" (full range, a third repeating others, the
    extremes, -1 and 0 among them), "hash" (full range), "equal" (one key),
    "negative" (all below 0, few distinct: long runs of equal keys),
    "extremes" (INT64_MIN, INT64_MAX, -1, 0 and 1 only), "small" (below
    2^24: the top five digits constant); and hash keys skewed: "big_bucket"
    (a third of them with top byte SORT_X of u = key ^ 2^63, a bucket past
    a block's shared memory), "group500" (one key 500 times), "cap" /
    "cap_past" (exactly 64 / 65 keys with top bytes SORT_X, SORT_Y)."""
    if kind == "equal":
        return np.full(T, -5, np.int64)
    if kind == "negative":
        return -rng.integers(1, 50, T)
    if kind == "extremes":
        return rng.choice(np.array([-2**63, 2**63 - 1, -1, 0, 1], np.int64), T)
    if kind == "small":
        return rng.integers(0, 2**24, T)
    keys = rng.integers(-2**63, 2**63 - 1, T, endpoint=True)
    if kind == "random":
        again = rng.random(T) < 0.3
        keys[again] = keys[rng.integers(0, T, int(again.sum()))]
        for j, k in enumerate((-2**63, 2**63 - 1, -1, 0, -2**63, 2**63 - 1)):
            if T > 3 * j:
                keys[(7 * j) % T] = k
        return keys
    u = keys.view(np.uint64) ^ SORT_SIGN
    top = (u >> np.uint64(48)).astype(np.int64)
    if kind == "big_bucket":
        pick = rng.random(T) < 1 / 3
        u[pick] = (u[pick] & np.uint64(2**56 - 1)) | np.uint64(SORT_X << 56)
    elif kind == "group500":
        u[rng.permutation(T)[:min(500, T // 2)]] = u[0]
    elif kind in ("cap", "cap_past"):
        xy = (SORT_X << 8) | SORT_Y
        u[top == xy] += np.uint64(1 << 48)  # none left with both top bytes
        pick = rng.permutation(T)[:SORT_COMPARE + (kind == "cap_past")]
        u[pick] = (u[pick] & np.uint64(2**48 - 1)) | np.uint64(xy << 48)
    return (u ^ SORT_SIGN).view(np.int64)


@pytest.mark.parametrize("T,kind", [
    (1, "random"), (2, "equal"), (2, "random"), (31, "negative"), (4095, "random"),
    (4096, "random"), (4096, "equal"), (4096, "negative"), (4097, "random"), (4097, "equal"),
    (4097, "negative"), (6144, "random"), (6145, "random"), (2**17 + 3, "random"),
    (2**17 + 3, "equal"), (2**17 + 3, "negative"), (2**17 + 3, "hash"), (2**17 + 3, "small"),
    (2**17 + 3, "extremes"), (2**17 + 3, "big_bucket"), (2**17 + 3, "group500"),
    (2**17 + 3, "cap"), (2**17 + 3, "cap_past"), (4096, "cap"), (4096, "cap_past")])
def test_sort_model_equals_stable_argsort(T, kind):
    """The model of K17 bit for bit torch.argsort(stable=True) and
    torch_core.sort_keys (perm and sorted keys), and each kind through the
    route it is built for: one key; one block's 4,096 either side (the
    one-block route; past it the histograms, the partition and the
    buckets); a partition tile's edge (6,144 = 3 x 2,048) and one past it;
    2^17 + 3 keys (65 tiles, look-backs of several windows, tiles finishing
    in a random order): hash keys (each bucket on chip, one radix step, no
    range pushed), small integers (the split digit below the top), a bucket
    past a block's shared memory (through memory), a 500-key group in a
    bucket (pushed, then equal keys), a sub-range at the comparison's cap
    (ranked by comparison) and one past it (pushed); all keys equal and
    negative keys (the partition alone), the int64 extremes (the sign flip,
    buckets of equal keys and a bucket of 0 and 1 through memory)."""
    rng = np.random.default_rng(T)
    keys = sort_case(rng, T, kind)
    stats = {}
    perm, sorted_keys = sort_keys_model(keys, rng, stats)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # torch's parallel CPU sort crawls on a shared host
    try:
        want = torch.argsort(tt(keys), stable=True)
        plain_perm, plain_keys = torch_core.sort_keys(tt(keys))
    finally:
        torch.set_num_threads(threads)
    assert np.array_equal(perm, want.numpy())
    assert plain_perm.dtype == torch.int32
    assert np.array_equal(perm, plain_perm.numpy())
    assert np.array_equal(sorted_keys, plain_keys.numpy())
    big = T > SORT_THREADS * SORT_SMALL_ITEMS
    if kind == "hash":
        assert stats["split"] == 7 and stats["on_chip"] == 256 and stats["steps"] == 256
        assert not stats["pushed"] and "memory" not in stats
    elif kind == "small":
        assert stats["split"] == 2 and stats["on_chip"] == 256 and "memory" not in stats
    elif kind in ("equal", "negative") and big:
        assert stats == {"split": -1 if kind == "equal" else 0}
    elif kind == "extremes":
        assert stats["split"] == 7 and stats["memory"] == 4 and stats["passes"] == 1
    elif kind == "big_bucket":
        assert stats["memory"] == 1 and stats["passes"] == 7 and stats["on_chip"] == 255
    elif kind == "group500":
        assert max(stats["pushed"]) >= 500 and "memory" not in stats
    elif kind == "cap":
        assert stats["compared"] == SORT_COMPARE and SORT_COMPARE + 1 not in stats["pushed"]
    elif kind == "cap_past":
        assert SORT_COMPARE + 1 in stats["pushed"]


def forged_keys(ka, kb, shift=60):
    """ka with only its top 64 - shift bits kept: many signatures share ka
    (a forged 64-bit collision), kb unchanged."""
    return (ka >> shift) << shift, kb


@pytest.mark.parametrize("T,W,uniq,live", [(700, 2, 150, False), (3000, 1, 2900, True),
                                           (520, 3, 40, True)])
@pytest.mark.parametrize("th", [1e-12, None])
def test_merge_model_split_run_and_repair(monkeypatch, T, W, uniq, live, th):
    """Pass A after a sort by forged keys that many signatures share: with
    the check on it reports a split run (dead positions count too) and
    torch_core.merge_groups returns None; the repair's sort by (ka, kb)
    (lexsort_keys: two stable sorts, equal to _lexsort) with the check off
    gives the parent's output bit for bit; _merge_sorted on the large route
    (cuda.SMALL_ROWS set to 0) takes that route and counts it."""
    monkeypatch.setattr(cuda, "SMALL_ROWS", 0)
    rng = np.random.default_rng(T + uniq)
    x, z, c = merge_case(rng, T, W, uniq, 0, 3)
    X, Z, CR, CI = tt(x), tt(z), tt(c[0]), tt(c[1])
    ka, kb = forged_keys(*torch_core.row_signature(X, Z))
    flags = torch.from_numpy(rng.random(T) < 0.6) if live else None
    perm, kas = torch_core.sort_keys(ka)
    assert merge_model(perm.numpy(), kas.numpy(), ka.numpy(), kb.numpy(), c[0], c[1], th, (x, z),
                       256, rng, None if flags is None else flags.numpy()) is None
    assert torch_core.merge_groups(perm, kas, ka, kb, CR, CI, th, (X, Z), flags) is None
    perm, kas = torch_core.lexsort_keys(ka, kb)
    assert torch.equal(perm.long(), torch_core._lexsort(ka, kb))
    want = parent_merge(ka, kb, CR, CI, th, (X, Z), flags)
    got = merge_model(perm.numpy(), kas.numpy(), ka.numpy(), kb.numpy(), c[0], c[1], th, (x, z),
                      256, rng, None if flags is None else flags.numpy(), check=False)
    same_arrays(got, want)
    same_arrays(torch_core.merge_groups(perm, kas, ka, kb, CR, CI, th, (X, Z), flags, False), want)
    before = cuda.sort_repairs
    same_arrays(torch_core._merge_sorted(ka, kb, CR, CI, th, (X, Z), flags), want)
    assert cuda.sort_repairs == before + 1


def test_merge_model_split_check_covers_dead_rows():
    """Two live rows of one signature with a dead row of another signature
    but the same ka between them in sorted order: the check reports the
    split although the dead row takes no part."""
    ka = tt(np.array([7, 7, 7, 1], np.int64))
    kb = tt(np.array([3, 9, 3, 4], np.int64))
    c = np.array([1.0, 2.0, 4.0, 8.0])
    live = np.array([True, False, True, True])
    x = np.arange(4, dtype=np.int64)[:, None]
    perm, kas = torch_core.sort_keys(ka)
    assert merge_sums_model(perm.numpy(), kas.numpy(), kb.numpy(), c, c, None, live)[2]
    assert not merge_sums_model(perm.numpy(), kas.numpy(), kb.numpy(), c, c, None, live,
                                check=False)[2]
    assert torch_core.merge_groups(perm, kas, ka, kb, tt(c), tt(c), None, (tt(x), tt(x)),
                                   torch.from_numpy(live)) is None


# -- rotation_rows.cu (K6) and project_rows.cu (K7): the rows' signatures,
# coefficients and live flags ------------------------------------------------

def row_split(W, aligned=True):
    """(words a unit, units a row, log2 of the lanes a row) of K6 and K7: a
    unit is V words of x and the same V of z, V = 2 where W is even and the
    planes aligned, else 1; the lanes the power of two at or above the
    units, at most 32."""
    V = 2 if W % 2 == 0 and aligned else 1
    return V, W // V, ceil_log2(W // V, 5)


def hash_word_model(acc, w, j):
    """hash_word: the low and high halves of the words w at half-word
    positions j and j + 1 into the four lane sums acc[..., l]."""
    u32, u64 = np.uint32, np.uint64
    for half in (0, 1):
        h = ((w >> u64(32 * half)) & u64(0xFFFFFFFF)).astype(u32)
        for lane in range(4):
            acc[..., lane] += sig_mix(h, sig_position(j + half, lane), lane)


def group_tree(acc, L):
    """The group's xor-shuffle tree: every lane ends with the group's sum."""
    o = L >> 1
    while o:
        acc = acc + acc[:, np.arange(L) ^ o]
        o >>= 1
    return acc[:, 0]


def keys_of(acc):
    a = acc.astype(np.uint64)
    top = np.uint64(0x80000000)
    ka = (((a[:, 0] ^ top) << np.uint64(32)) | a[:, 1]).view(np.int64)
    kb = (((a[:, 2] ^ top) << np.uint64(32)) | a[:, 3]).view(np.int64)
    return ka, kb


def rows_visited(T, log2, grid_warps):
    """How often the grid's warps visit each row (K2's stride: warp w takes
    the rows from w * R on, R = 32 / lanes a row, by grid_warps * R)."""
    R = 32 >> log2
    seen = np.zeros(T, np.int64)
    for w in range(grid_warps):
        for base in range(w * R, T, grid_warps * R):
            rows = base + np.arange(R)
            np.add.at(seen, rows[rows < T], 1)
    return seen


def rotation_model(x, z, c, xr, zr, cos_t, sin_t, aligned=True):
    """K6 as the kernel computes it: lane u % L of a row's group takes unit
    u (V words of x and of z, Q's words and the position constants in
    registers), hashes the row and its twin (x ^ xr, z ^ zr) and adds
    popc(x & zr), popc(z & xr), y + y_Q and y_out in uint32; the group's
    tree; its first lane's two coefficients (products rounded apart, the
    sign a product by +-1.0, apply_i_pow's table) and flags."""
    u32, u64 = np.uint32, np.uint64
    T, W = x.shape
    V, units, log2 = row_split(W, aligned)
    L = 1 << log2
    X, Z, QX, QZ = x.view(u64), z.view(u64), xr.view(u64), zr.view(u64)
    s0, s1 = np.zeros((T, L, 4), u32), np.zeros((T, L, 4), u32)
    n = np.zeros((T, L, 4), u32)  # n_zr, n_xr, y, y_out
    for u in range(units):
        li = u % L
        for q in range(u * V, u * V + V):
            a, b, cq, d = X[:, q], Z[:, q], QX[q], QZ[q]
            for acc, wx, wz in ((s0, a, b), (s1, a ^ cq, b ^ d)):
                hash_word_model(acc[:, li], wx, 2 * q)
                hash_word_model(acc[:, li], wz, 2 * (W + q))
            n[:, li, 0] += popc(a & d).astype(u32)
            n[:, li, 1] += popc(b & cq).astype(u32)
            n[:, li, 2] += (popc(a & b) + popc(np.asarray(cq & d))).astype(u32)
            n[:, li, 3] += popc((a ^ cq) & (b ^ d)).astype(u32)
    s0, s1, n = group_tree(s0, L), group_tree(s1, L), group_tree(n, L)
    ac = ((n[:, 0] + n[:, 1]) & u32(1)).astype(bool)
    re, im = c.real, c.imag
    s = np.where(n[:, 0] & u32(1), -1.0, 1.0)
    sr, si = re * s, im * s
    k = (u32(3) * n[:, 2] + n[:, 3]) & u32(3)
    mr = np.select([k == 0, k == 1, k == 2], [sr, -si, -sr], si)
    mi = np.select([k == 0, k == 1, k == 2], [si, sr, -si], -sr)
    (ka0, kb0), (ka1, kb1) = keys_of(s0), keys_of(s1)
    return (np.concatenate([ka0, ka1]), np.concatenate([kb0, kb1]),
            np.concatenate([np.where(ac, re * cos_t, re), mi * sin_t]),
            np.concatenate([np.where(ac, im * cos_t, im), (-mr) * sin_t]),
            np.concatenate([np.ones(T, bool), ac]))


def projection_model(x, z, c, ac, neg_x, neg_z, col_keep, aligned=True):
    """K7 as the kernel computes it: lane u % L of a row's group takes unit
    u, hashes the masked words (x & col_keep, z & col_keep) and adds
    popc(x & neg_x) + popc(z & neg_z); lane li reads the row's entries li,
    li + L, ... of ac; the group's tree; its first lane's coefficient times
    +-1.0 and live flag."""
    u32, u64 = np.uint32, np.uint64
    T, W = x.shape
    S = ac.shape[1]
    V, units, log2 = row_split(W, aligned)
    L = 1 << log2
    X, Z = x.view(u64), z.view(u64)
    NX, NZ, K = neg_x.view(u64), neg_z.view(u64), col_keep.view(u64)
    s = np.zeros((T, L, 4), u32)
    n = np.zeros((T, L, 2), u32)  # flips, hits
    for u in range(units):
        li = u % L
        for q in range(u * V, u * V + V):
            hash_word_model(s[:, li], X[:, q] & K[q], 2 * q)
            hash_word_model(s[:, li], Z[:, q] & K[q], 2 * (W + q))
            n[:, li, 0] += (popc(X[:, q] & NX[q]) + popc(Z[:, q] & NZ[q])).astype(u32)
    for k in range(S):
        n[:, k % L, 1] += ac[:, k].astype(u32)
    s, n = group_tree(s, L), group_tree(n, L)
    f = np.where(n[:, 0] & u32(1), -1.0, 1.0)
    ka, kb = keys_of(s)
    return ka, kb, c.real * f, c.imag * f, n[:, 1] == 0


def same_arrays(got, want):
    for g, w in zip(got, want):
        g, w = np.asarray(g), w.numpy()
        assert g.shape == w.shape
        if g.dtype == bool:
            assert np.array_equal(g, w)
        else:
            assert np.array_equal(g.view(np.int64), w.view(np.int64))


@pytest.mark.parametrize("W", [1, 2, 3, 16, 17, 33])
@pytest.mark.parametrize("T", [1, 33, 300])
def test_rotation_model_equals_plain(W, T):
    """The model of K6 bit for bit torch_core.rotation_rows (keys, both
    halves' coefficients with signed zeros, live flags), at both unit
    widths, Q and the rows random and with some rows Q's own product; the
    grid's stride visits every row once."""
    rng = np.random.default_rng(100 * W + T)
    x, z = (rng.integers(-2**63, 2**63 - 1, (T, W), endpoint=True) for _ in range(2))
    xr, zr = (rng.integers(-2**63, 2**63 - 1, W, endpoint=True) for _ in range(2))
    x[T // 2:] = x[:T - T // 2] ^ xr  # P Q rows among the inputs
    c = rng.normal(size=T) + 1j * rng.normal(size=T)
    c[0] = complex(0.0, -0.0)
    want = torch_core.rotation_rows(tt(x), tt(z), tt(c.real), tt(c.imag), tt(xr), tt(zr),
                                    np.cos(0.37), np.sin(0.37))
    for aligned in (True, False):
        same_arrays(rotation_model(x, z, c, xr, zr, np.cos(0.37), np.sin(0.37), aligned), want)
    for grid_warps in (1, 3, 64):
        assert (rows_visited(T, row_split(W)[2], grid_warps) == 1).all()


@pytest.mark.parametrize("W", [1, 2, 3, 16, 17])
@pytest.mark.parametrize("S", [0, 1, 4, 40])
def test_projection_model_equals_plain(W, S):
    """The model of K7 bit for bit torch_core.project_rows (keys of the
    masked rows, coefficients times +-1.0 with signed zeros, live flags),
    at both unit widths, with no stabilizer and with more stabilizers than
    lanes."""
    rng = np.random.default_rng(10 * W + S)
    T = 200
    x, z = (rng.integers(-2**63, 2**63 - 1, (T, W), endpoint=True) for _ in range(2))
    neg_x, neg_z, col_keep = (rng.integers(-2**63, 2**63 - 1, W, endpoint=True)
                              for _ in range(3))
    ac = rng.random((T, S)) < 0.1
    c = rng.normal(size=T) + 1j * rng.normal(size=T)
    c[:2] = complex(0.0, -0.0)
    want = torch_core.project_rows(tt(x), tt(z), tt(c.real), tt(c.imag), torch.from_numpy(ac),
                                   tt(neg_x), tt(neg_z), tt(col_keep))
    for aligned in (True, False):
        same_arrays(projection_model(x, z, c, ac, neg_x, neg_z, col_keep, aligned), want)


@pytest.mark.parametrize("source", ["rotation", "masked"])
@pytest.mark.parametrize("th", [1e-12, None])
@pytest.mark.parametrize("sort", ["ka", "lexsort"])
def test_merge_model_rotation_and_masked_rows_equal_plain(source, th, sort):
    """K3 on K6's and K7's slots: pass A with their live flags and pass B
    rebuilding the survivors' rows from the rotation's (x ^ xr for the
    second half) and the masked (x & col_keep) row sources, bit for bit
    torch_core.merge_groups on those sources and on the materialised rows."""
    rng = np.random.default_rng(3 + len(source))
    T, W = 300, 3
    x, z = (rng.integers(-2**62, 2**62, (T, W)) for _ in range(2))
    x[100:150], z[100:150] = x[0], z[0]  # a long group
    c = rng.normal(size=(2, T))
    if source == "rotation":
        xr, zr = (rng.integers(-2**62, 2**62, W) for _ in range(2))
        x[200:210] = x[:10] ^ xr  # twins equal to input rows
        z[200:210] = z[:10] ^ zr
        ka, kb, pr, pi, live = torch_core.rotation_rows(tt(x), tt(z), tt(c[0]), tt(c[1]),
                                                        tt(xr), tt(zr), 0.6, 0.8)
        rows = (x, z, xr, zr)
        flat = (np.concatenate([x, x ^ xr]), np.concatenate([z, z ^ zr]))
    else:
        col_keep = np.full(W, -1, np.int64)
        col_keep[1] = ~np.int64(0xF0F0)
        x[250:260], z[250:260] = x[240:250], z[240:250]
        x[250:260, 1] ^= 0x1010  # equal once masked
        ka, kb, pr, pi, live = torch_core.project_rows(
            tt(x), tt(z), tt(c[0]), tt(c[1]), torch.from_numpy(rng.random((T, 2)) < 0.3),
            tt(np.zeros(W, np.int64)), tt(np.zeros(W, np.int64)), tt(col_keep))
        rows = (x, z, col_keep)
        flat = (x & col_keep, z & col_keep)
    perm, kas, check = sorted_by(sort, ka, kb)
    want = torch_core.merge_groups(perm, kas, ka, kb, pr, pi, th, tuple(tt(a) for a in rows),
                                   live, check)
    same_arrays([t.numpy() for t in parent_merge(ka, kb, pr, pi, th, tuple(tt(a) for a in rows),
                                                 live)], want)
    same = torch_core.merge_groups(perm, kas, ka, kb, pr, pi, th, tuple(tt(a) for a in flat),
                                   live, check)
    got = merge_model(perm.numpy(), kas.numpy(), ka.numpy(), kb.numpy(), pr.numpy(), pi.numpy(),
                      th, rows, 256, rng, live.numpy(), check)
    same_arrays(got, want)
    same_arrays([t.numpy() for t in same], want)


# -- merge_small.cu (K3's one-block route): group, sort, sum, compact --------

MS_ITEMS, MS_MIN_SLOTS, MS_UNROLL = 4, 128, 8  # merge_small.cu's kItems, kMinSlots, kUnroll
MS_COPY_BLOCKS, MS_COPY_WORDS = 8, 8192  # kCopyBlocks, kCopyWords
MS_EMPTY = 0xFFFFFFFF  # kEmpty
M64 = (1 << 64) - 1


def signature_hash_model(a, b):
    """merge_small.cu's signature_hash in uint64 arithmetic."""
    h = ((int(a) & M64) * 0x9E3779B97F4A7C15 + (int(b) & M64)) & M64
    h ^= h >> 29
    h = (h * 0xBF58476D1CE4E5B9) & M64
    return (h ^ (h >> 32)) & 0xFFFFFFFF


def group_firsts_model(ka, kb, live, N, rng):
    """Step 1 as the block runs it: each live slot (t + i nt) writes its slot
    at its hash's entry of a table of 4 N (the threads in a random order:
    the last write stays); each joins the slot it reads back if they share
    a signature, else walks on from the next entry, in a random order of
    the threads, past other signatures' entries until it joins its own or
    claims a free one (compare-and-swap).  Then each entry's first slot,
    its own lowered by each slot below it (atomicMin), by the lowest lane
    alone where a warp's lowering slots of one item share one entry.  Returns each slot's
    group's first slot (-1: dead) and whether a signature repeats."""
    T = len(ka)
    table = np.full(4 * N, MS_EMPTY, np.int64)
    owner = np.full(N, -1)
    h = {s: signature_hash_model(ka[s], kb[s]) & (4 * N - 1) for s in range(T) if live[s]}
    same = lambda e, s: ka[e] == ka[s] and kb[e] == kb[s]
    for s in rng.permutation(sorted(h)):
        table[h[s]] = s
    for s in rng.permutation(sorted(h)):
        e = table[h[s]]
        while True:
            if e == MS_EMPTY:
                table[h[s]] = owner[s] = s
                break
            if same(e, s):
                owner[s] = e
                break
            h[s] = (h[s] + 1) & (4 * N - 1)
            e = table[h[s]]
    first = np.arange(N)
    nt = N // MS_ITEMS
    for w in range(nt // 32):
        for i in range(MS_ITEMS):
            lanes = [(lane, 32 * w + lane + i * nt) for lane in range(32)]
            lower = [(lane, s) for lane, s in lanes if s < T and live[s] and s < owner[s]]
            if len({owner[s] for _, s in lower}) == 1:  # one entry: its lowest lane
                leader = min(lower)
                assert leader[1] == min(s for _, s in lower)  # slots rise with lanes
                lower = [leader]
            for _, s in lower:
                first[owner[s]] = min(first[owner[s]], s)
    repeat = bool(any(owner[s] != s for s in h))
    return np.array([first[owner[s]] if s < T and live[s] else -1 for s in range(T)],
                    np.int64), repeat


def bitonic_model(v, N):
    """Step 3 as the threads run it: v[t, i] the key at position 4 t + i;
    steps of distance 1 and 2 in a thread's registers, 4 to 64 between
    lanes (d = j / 4 < 32), 128 and up through the exchange buffers.
    Returns the keys by position and the steps of each kind."""
    t = np.arange(N // MS_ITEMS)
    steps = {"registers": 0, "shuffles": 0, "buffers": 0}

    def order(v, a, b, up):
        lo, hi = np.minimum(v[:, a], v[:, b]), np.maximum(v[:, a], v[:, b])
        v[:, a], v[:, b] = np.where(up, lo, hi), np.where(up, hi, lo)

    k = 2
    while k <= N:
        j = k // 2
        while j > 0:
            if j >= MS_ITEMS:
                d = j // MS_ITEMS
                keep_min = (((MS_ITEMS * t) & k) == 0) == ((t & d) == 0)
                o = v[t ^ d]
                v = np.where(keep_min[:, None], np.minimum(v, o), np.maximum(v, o))
                steps["shuffles" if d < 32 else "buffers"] += 1
            else:
                v = v.copy()
                if j == 2:
                    up = ((MS_ITEMS * t) & k) == 0
                    order(v, 0, 2, up)
                    order(v, 1, 3, up)
                else:
                    order(v, 0, 1, ((MS_ITEMS * t) & k) == 0)
                    order(v, 2, 3, ((MS_ITEMS * t + 2) & k) == 0)
                steps["registers"] += 1
            j //= 2
        k *= 2
    return v.reshape(-1), steps


def source_rows_np(rows, rep):
    """The rows `rep` of a numpy row source (source_word, vectorised)."""
    if len(rows) == 2:
        return rows[0][rep], rows[1][rep]
    if len(rows) == 3:
        return rows[0][rep] & rows[2], rows[1][rep] & rows[2]
    if rows[2].ndim == 1:
        M = rows[0].shape[0]
        twin = (rep >= M)[:, None]
        return (np.where(twin, rows[0][rep % M] ^ rows[2], rows[0][rep % M]),
                np.where(twin, rows[1][rep % M] ^ rows[3], rows[1][rep % M]))
    a, b = np.divmod(rep, rows[2].shape[0])
    return rows[0][a] ^ rows[2][b], rows[1][a] ^ rows[3][b]


def merge_small_model(ka, kb, cr, ci, th, rows, live, rng):
    """K3's one-block route step by step (merge_small.cu): (x, z, cr, ci,
    ka) of the survivors, and the route to the keys by position ("scan"
    where no signature repeats, else the bitonic network's steps of each
    kind)."""
    T = len(ka)
    live = np.ones(T, bool) if live is None else live
    N = MS_MIN_SLOTS
    while N < T:
        N *= 2
    nt = N // MS_ITEMS
    first, repeat = group_firsts_model(ka, kb, live, N, rng)
    on = first >= 0
    keys = np.full(N, MS_EMPTY, np.int64)
    keys[:T][on] = (first[on] << 16) | np.arange(T)[on]
    if repeat:  # steps 2' and 3: thread t's registers hold slots 4 t + i
        v, steps = bitonic_model(keys.reshape(nt, MS_ITEMS).copy(), N)
    else:  # step 2: a live slot's position is the live slots before it
        assert (first[on] == np.flatnonzero(on)).all()
        v = np.full(N, MS_EMPTY, np.int64)
        before = np.concatenate([[0], np.cumsum(on)[:-1]])
        v[before[on]] = keys[:T][on]
        steps = "scan"
    assert np.array_equal(v, np.sort(keys))
    # step 4: the coefficients by position, each group's end at its first slot
    c = np.zeros((N, 2))
    end = {}
    for p in range(N):
        if v[p] != MS_EMPTY:
            c[p] = cr[v[p] & 0xFFFF], ci[v[p] & 0xFFFF]
            if p + 1 == N or v[p + 1] >> 16 != v[p] >> 16:
                end[v[p] >> 16] = p + 1
    # step 5: a group's first position sums it from +0.0 (one position: its
    # coefficient added to +0.0), kUnroll loads at a time
    sums, reps = {}, {}
    for p in range(N):
        if v[p] != MS_EMPTY and (p == 0 or v[p - 1] >> 16 != v[p] >> 16):
            f, e, re, im = v[p] >> 16, end[v[p] >> 16], 0.0, 0.0
            for q0 in range(p, e, MS_UNROLL):
                for q in range(q0, min(q0 + MS_UNROLL, e)):
                    re, im = re + c[q, 0], im + c[q, 1]
            if th is None or np.hypot(re, im) > th:
                sums[p], reps[p] = (re, im), f
    # step 6: positions t + i nt; the four rounds' survivors scanned at once,
    # 16 bits a round, warp by warp
    flags = np.array([[p in reps for p in range(t, N, nt)] for t in range(nt)], np.uint64)
    mine = (flags << (np.arange(MS_ITEMS, dtype=np.uint64) * np.uint64(16))).sum(axis=1)
    incl = mine.reshape(-1, 32).cumsum(axis=1)
    before_warp = np.concatenate([np.zeros(1, np.uint64), incl[:, -1].cumsum()[:-1]])
    before = (before_warp[:, None] + incl).reshape(-1) - mine
    total = int(mine.sum())
    field = lambda x, i: (int(x) >> (16 * i)) & 0xFFFF
    n = sum(field(total, i) for i in range(MS_ITEMS))
    rep = np.zeros(n, np.int64)
    out_c = np.zeros((2, n))
    for t in range(nt):
        base = 0
        for i in range(MS_ITEMS):
            p = t + i * nt
            if p in reps:
                d = base + field(before[t], i)
                rep[d], out_c[:, d] = reps[p], sums[p]
            base += field(total, i)
    assert (np.diff(rep) > 0).all()  # first-occurrence order
    # step 8: block b's rows r = (b warps + warp) P + g, + C warps P ...,
    # words li, li + L, ... once each
    W = rows[0].shape[1]
    log2 = ceil_log2(W, 5)
    L, P, warps = 1 << log2, 32 >> log2, nt // 32
    C = MS_COPY_BLOCKS if T * W > MS_COPY_WORDS else 1
    copies = np.zeros((n, W), np.int64)
    for b in range(C):
        for warp in range(warps):
            for lane in range(32):
                copies[(b * warps + warp) * P + (lane >> log2)::C * warps * P,
                       lane & (L - 1)::L] += 1
    assert (copies == 1).all()
    x, z = source_rows_np(rows, rep)
    return (x.reshape(n, W), z.reshape(n, W), out_c[0], out_c[1], ka[rep]), steps


def merge_small_source(rng, source, T, W):
    """(T, numpy row source, its T rows as planes) with repeated rows: the
    planes drawn from T / 3 rows; a product's operand-1 rows from M1 / 2;
    a rotation's rows with some equal to another's P Q twin; masked rows
    equal once masked."""
    word = lambda *shape: rng.integers(-2**62, 2**62, shape)
    if source == "planes":
        base = word(max(1, T // 3), 2, W)
        rows = base[rng.integers(0, base.shape[0], T)]
        rows = (rows[:, 0].copy(), rows[:, 1].copy())
        flat = rows
    elif source == "pairs":
        M2 = next(m for m in (3, 2, 1) if T % m == 0)
        M1 = T // M2
        x1, z1 = (word(max(1, M1 // 2), W)[rng.integers(0, max(1, M1 // 2), M1)]
                  for _ in range(2))
        rows = (x1, z1, word(M2, W), word(M2, W))
        flat = source_rows_np(rows, np.arange(T))
    elif source == "rotation":
        T += T % 2
        x, z = word(T // 2, W), word(T // 2, W)
        xr, zr = word(W), word(W)
        k = T // 8
        x[T // 2 - k:], z[T // 2 - k:] = x[:k] ^ xr, z[:k] ^ zr
        rows = (x, z, xr, zr)
        flat = source_rows_np(rows, np.arange(T))
    else:
        x, z = word(T, W), word(T, W)
        keep = word(W) & ~np.int64(0xFF)
        x[T // 2:] = (x[:T - T // 2] & keep) | (x[T // 2:] & 0xFF)
        z[T // 2:] = z[:T - T // 2]
        rows = (x, z, keep)
        flat = source_rows_np(rows, np.arange(T))
    return T, rows, flat


MS_SIZES = [1, 2, 31, 32, 33, 67, 1023, 1024, 1025, 2229, 4095, 4096]


@pytest.fixture
def one_torch_thread():
    """torch on one thread for the test (its parallel CPU sorts and
    reductions crawl on a shared host)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("T", MS_SIZES)
@pytest.mark.parametrize("source", ["planes", "pairs", "rotation", "masked"])
def test_merge_small_model_equals_plain_and_parent(one_torch_thread, T, source):
    """The model of K3's one-block route bit for bit torch_core.merge_small
    and the parent's composition (_lexsort, then merge_groups) and the
    large route's plain version (K17's sort by ka, merge_groups with the
    check), at padded sizes and one past them, on each row source (a
    rotation's T rounded up to even), with no live flags and a 1e-12
    threshold, some slots dead and no threshold (exact zeros kept), some
    dead and a 0.5 threshold that drops groups, every slot dead; a tenth of
    the coefficients exact zeros and half the groups of two rows cancelling
    exactly."""
    rng = np.random.default_rng([T, len(source)])
    W = (1, 2, 3, 16)[T % 4]
    T, rows, flat = merge_small_source(rng, source, T, W)
    ka, kb = torch_core.row_signature(tt(flat[0]), tt(flat[1]))
    c = rng.normal(size=(2, T))
    c[:, rng.random(T) < 0.1] = 0.0
    _, inverse, counts = np.unique(np.stack([ka.numpy(), kb.numpy()]), axis=1,
                                   return_inverse=True, return_counts=True)
    for g in np.flatnonzero(counts == 2)[::2]:  # cancelling pairs
        a, b = np.flatnonzero(inverse.reshape(-1) == g)
        c[:, b] = -c[:, a]
    CR, CI = tt(c[0]), tt(c[1])
    trows = tuple(tt(a) for a in rows)
    for kind, th in (("none", 1e-12), ("some", None), ("some", 0.5), ("dead", None)):
        live = None if kind == "none" else (rng.random(T) < 0.7) & (kind == "some")
        flags = None if live is None else torch.from_numpy(live)
        want = torch_core.merge_small(ka, kb, CR, CI, th, trows, flags)
        same_arrays([t.numpy() for t in parent_merge(ka, kb, CR, CI, th, trows, flags)], want)
        if kind == "some" and th is None:  # the large route's plain version
            perm, kas = torch_core.sort_keys(ka)
            same_arrays([t.numpy() for t in torch_core.merge_groups(
                perm, kas, ka, kb, CR, CI, th, trows, flags)], want)
        got, steps = merge_small_model(ka.numpy(), kb.numpy(), c[0], c[1], th, rows, live, rng)
        same_arrays(got, want)
        if kind == "dead":
            assert want[0].shape[0] == 0
        if kind == "none" and source == "planes" and T > 1:
            assert steps != "scan"  # T / 3 distinct rows: signatures repeat
    N = max(MS_MIN_SLOTS, 1 << (T - 1).bit_length())
    if N == 4096 and steps != "scan":
        assert steps == {"registers": 23, "shuffles": 40, "buffers": 15}


@pytest.mark.parametrize("T", [1025, 4096])
@pytest.mark.parametrize("dead", [False, True])
def test_merge_small_model_one_group_of_all_slots(one_torch_thread, T, dead):
    """One group of every slot, summed by one thread in slot order from
    +0.0 (a third of its slots dead, the first among them), bit for bit
    torch_core.merge_small: one survivor, its first live slot's row."""
    rng = np.random.default_rng(T + dead)
    row = rng.integers(-2**62, 2**62, (2, 1, 16))
    x, z = np.repeat(row[0], T, 0), np.repeat(row[1], T, 0)
    c = rng.normal(size=(2, T)) * 10.0 ** rng.integers(-8, 8, T)
    live = (rng.random(T) < 2 / 3) if dead else None
    if dead:
        live[0] = False
    ka, kb = torch_core.row_signature(tt(x), tt(z))
    flags = None if live is None else torch.from_numpy(live)
    want = torch_core.merge_small(ka, kb, tt(c[0]), tt(c[1]), 1e-12, (tt(x), tt(z)), flags)
    got, _ = merge_small_model(ka.numpy(), kb.numpy(), c[0], c[1], 1e-12, (x, z), live, rng)
    same_arrays(got, want)
    on = np.ones(T, bool) if live is None else live
    re = 0.0
    for v in c[0][on]:
        re += v
    assert want[0].shape[0] == 1 and want[2].item() == re


@pytest.mark.parametrize("T,W,uniq,live", [(700, 2, 150, False), (4096, 1, 3000, True),
                                           (520, 3, 40, True)])
@pytest.mark.parametrize("th", [1e-12, None])
def test_merge_small_model_forged_collisions(one_torch_thread, T, W, uniq, live, th):
    """The twin of test_merge_model_split_run_and_repair on K3's one-block
    route: signatures that share a forged first key are grouped by (ka, kb)
    in the hash table, so the model and _merge_sorted give the parent's
    output bit for bit with no split check and no repair counted."""
    rng = np.random.default_rng(T + uniq)
    x, z, c = merge_case(rng, T, W, uniq, 0, 3)
    X, Z, CR, CI = tt(x), tt(z), tt(c[0]), tt(c[1])
    ka, kb = forged_keys(*torch_core.row_signature(X, Z))
    flags = torch.from_numpy(rng.random(T) < 0.6) if live else None
    perm, kas = torch_core.sort_keys(ka)
    assert torch_core.merge_groups(perm, kas, ka, kb, CR, CI, th, (X, Z), flags) is None
    want = parent_merge(ka, kb, CR, CI, th, (X, Z), flags)
    got, _ = merge_small_model(ka.numpy(), kb.numpy(), c[0], c[1], th, (x, z),
                               None if flags is None else flags.numpy(), rng)
    same_arrays(got, want)
    before = cuda.sort_repairs
    same_arrays(torch_core._merge_sorted(ka, kb, CR, CI, th, (X, Z), flags), want)
    assert cuda.sort_repairs == before


def test_merge_small_model_grouping_ignores_the_threads_order():
    """Each group's first slot, whatever order the threads claim their
    entries in (a tiny table that collides: 64 slots of 5 signatures and
    forged keys that share ka); unique signatures take the scan route."""
    rng = np.random.default_rng(9)
    ka = np.repeat(np.int64(7) << np.int64(60), 64)
    kb = rng.integers(0, 5, 64)
    live = rng.random(64) < 0.8
    want = [int(np.flatnonzero((kb == kb[s]) & live)[0]) if live[s] else -1 for s in range(64)]
    for _ in range(20):
        first, repeat = group_firsts_model(ka, kb, live, 128, rng)
        assert first.tolist() == want and repeat
    kb = np.arange(64)
    first, repeat = group_firsts_model(ka, kb, live, 128, rng)
    assert not repeat and first.tolist() == [s if live[s] else -1 for s in range(64)]


@pytest.mark.parametrize("T", [1, 67, 2229, 4096])
@pytest.mark.parametrize("W", [1, 16])
def test_merge_small_model_unique_signatures_take_the_scan(one_torch_thread, T, W):
    """Unique rows (the CS-VQE products, tapered N2's cleanup, the
    flagship's rows) skip the network: the live slots' positions by a scan,
    bit for bit torch_core.merge_small; the rows copied by one block up to
    kCopyWords words, by the cluster above."""
    rng = np.random.default_rng(T + W)
    x, z = rng.integers(-2**62, 2**62, (T, W)), rng.integers(-2**62, 2**62, (T, W))
    c = rng.normal(size=(2, T))
    live = rng.random(T) < 0.8
    ka, kb = torch_core.row_signature(tt(x), tt(z))
    want = torch_core.merge_small(ka, kb, tt(c[0]), tt(c[1]), 1e-12, (tt(x), tt(z)),
                                  torch.from_numpy(live))
    got, steps = merge_small_model(ka.numpy(), kb.numpy(), c[0], c[1], 1e-12, (x, z), live, rng)
    assert steps == "scan"
    same_arrays(got, want)


# -- merge_small.cu's fused route: each slot signed in the launch ------------

MS_SIGN_ROUNDS = cuda._source_constant("kSignRounds", "merge_small.cu")


def sign_split(T, W, blocks):
    """Step 0' of the fused route as the launch cuts it (sign_slots): the
    threads of `blocks` blocks of nt = N / 4 in groups of L lanes (L the
    power of two at or above W, at most 32), group g taking slots g, g + G,
    ... (G groups; rounds loaded kAhead at a time), lane li words li, li +
    L, ... of the slot's row, the group's first lane storing it.  Returns
    how often each slot is stored, how often each (slot, word) is hashed,
    and the rounds of each group."""
    N = max(MS_MIN_SLOTS, 1 << (T - 1).bit_length())
    threads = blocks * (N // MS_ITEMS)
    L = 1 << ceil_log2(max(W, 1), 5)
    G = threads // L
    stored, hashed = np.zeros(T, np.int64), np.zeros((T, W), np.int64)
    rounds = np.zeros(G, np.int64)
    for thread in range(threads):
        g, li = divmod(thread, L)
        for s in range(g, T, G):
            stored[s] += li == 0
            hashed[s, li::L] += 1
            rounds[g] += li == 0
    return stored, hashed, rounds


@pytest.mark.parametrize("T,W", [(1, 1), (67, 1), (2229, 1), (4096, 1), (4096, 2), (67, 16),
                                 (1, 40), (3, 0)])
@pytest.mark.parametrize("blocks", [1, MS_COPY_BLOCKS])
def test_sign_split_signs_every_slot_once(T, W, blocks):
    """Every slot is signed and stored exactly once and every word of its
    row hashed once, by one block or by the cluster of kCopyBlocks, at the
    CS-VQE flows' products, tapered N2's cleanup, the route's most slots,
    16-word rows (a group of 16 lanes a slot), rows past 32 words (lanes
    take words li, li + 32) and rows of no words; the cluster's rounds at
    most a quarter of one block's; the launch takes the cluster where one
    block would take more than kSignRounds rounds."""
    stored, hashed, rounds = sign_split(T, W, blocks)
    assert (stored == 1).all() and (hashed == 1).all()
    one_block = sign_split(T, W, 1)[2].max()
    assert rounds.max() <= (one_block if blocks == 1 else max(1, -(-one_block // 4)))
    assert sign_launch_blocks(T, W) == (1 if one_block <= MS_SIGN_ROUNDS else MS_COPY_BLOCKS)


def sign_launch_blocks(T, W):
    """symmer_sign_merge_small's blocks: kCopyBlocks where one block's lane
    groups would take more than kSignRounds rounds of slots, else one."""
    N = max(MS_MIN_SLOTS, 1 << (T - 1).bit_length())
    L = 1 << ceil_log2(max(W, 1), 5)
    return MS_COPY_BLOCKS if -(-T * L // (N // MS_ITEMS)) > MS_SIGN_ROUNDS else 1


def sign_model(source, rows, coeffs, blocks):
    """Step 0' as the lanes compute each slot (sign_split's cut): each
    word q (its lane's; the sums mod 2^32 do not depend on which lane adds
    which word, nor the group's xor-shuffle tree on their order), its four
    position constants (x's halves 2q, 2q + 1, z's 2(W + q), 2(W + q) + 1),
    for a pair the power of i and the sign's popcount in uint32 (pair_word)
    and the product words, the four half-words hashed into four uint32
    lanes; then, by the group's first lane, the coefficient
    (the planes', or the product rounded apart, negated for an odd sign,
    turned by i^(k mod 4): pair_coefficient).  Returns (ka, kb, cr, ci) by
    slot."""
    u32, u64 = np.uint32, np.uint64
    if source == "planes":
        T, W = rows[0].shape
        xs, zs = rows[0].view(u64), rows[1].view(u64)
    else:
        M2, W = rows[2].shape
        T = rows[0].shape[0] * M2
        I, J = np.divmod(np.arange(T), M2)
    stored, hashed, _ = sign_split(T, W, blocks)
    assert (stored == 1).all() and (hashed == 1).all()
    acc = np.zeros((T, 4), u32)
    ipow, par = np.zeros(T, u32), np.zeros(T, u32)
    for q in range(W):
        if source == "planes":
            xw, zw = xs[:, q], zs[:, q]
        else:
            a, b = rows[0].view(u64)[I, q], rows[1].view(u64)[I, q]
            c, d = rows[2].view(u64)[J, q], rows[3].view(u64)[J, q]
            xw, zw = a ^ c, b ^ d
            ipow += u32(3) * (popc(a & b) + popc(c & d)).astype(u32) + popc(xw & zw).astype(u32)
            par += popc(a & d).astype(u32)
        for w, base in ((xw, 2 * q), (zw, 2 * (W + q))):
            for half in (0, 1):
                h = ((w >> u64(32 * half)) & u64(0xFFFFFFFF)).astype(u32)
                for lane in range(4):
                    acc[:, lane] += sig_mix(h, sig_position(base + half, lane), lane)
    if source == "planes":
        cr, ci = coeffs
    else:
        c1, c2 = coeffs
        a, b, c, d = c1.real[I], c1.imag[I], c2.real[J], c2.imag[J]
        re, im = a * c - b * d, a * d + b * c
        odd = (par & u32(1)).astype(bool)
        re, im = np.where(odd, -re, re), np.where(odd, -im, im)
        k = ipow & u32(3)
        cr = np.select([k == 0, k == 1, k == 2], [re, -im, -re], im)
        ci = np.select([k == 0, k == 1, k == 2], [im, re, -im], -re)
    a64 = acc.astype(u64)
    top = u64(0x80000000)
    ka = (((a64[:, 0] ^ top) << u64(32)) | a64[:, 1]).view(np.int64)
    kb = (((a64[:, 2] ^ top) << u64(32)) | a64[:, 3]).view(np.int64)
    return ka, kb, cr, ci


@pytest.mark.parametrize("source,dims,th", [("pairs", (1, 1, 1), None),
                                            ("pairs", (67, 1, 1), 1e-12),
                                            ("pairs", (20, 13, 16), 0.5),
                                            ("planes", (2229, 1), None),
                                            ("planes", (300, 16), 1e-12)])
def test_fused_model_equals_plain(one_torch_thread, source, dims, th):
    """The fused route's model, step 0' (sign_model, by the launch's block
    count: the cluster where one block would take more than kSignRounds
    rounds), then K3's one-block
    route (merge_small_model), bit for bit torch_core.cleanup_small or
    product_small (signed zeros and the four powers of i included) and the
    keys bit for bit row_signature / pair_products."""
    rng = np.random.default_rng(sum(dims))
    word = lambda *shape: rng.integers(-2**63, 2**63 - 1, shape, endpoint=True)
    if source == "planes":
        T, W = dims
        base = word(T // 3, 2, W)
        pick = base[rng.integers(0, T // 3, T)]
        rows = (pick[:, 0].copy(), pick[:, 1].copy())
        c = rng.normal(size=(2, T))
        coeffs = (c[0], c[1])
        want = torch_core.cleanup_small(tt(rows[0]), tt(rows[1]), tt(c[0]), tt(c[1]), th)
        keys = torch_core.row_signature(tt(rows[0]), tt(rows[1]))
    else:
        M1, M2, W = dims
        x1, z1 = (word(max(1, M1 // 2), W)[rng.integers(0, max(1, M1 // 2), M1)]
                  for _ in range(2))
        rows = (x1, z1, word(M2, W), word(M2, W))
        c1 = rng.normal(size=M1) + 1j * rng.normal(size=M1)
        c2 = rng.normal(size=M2) + 1j * rng.normal(size=M2)
        c1[0] = complex(0.0, -0.0)
        coeffs = (c1, c2)
        args = (tt(x1), tt(z1), tt(c1.real), tt(c1.imag), tt(rows[2]), tt(rows[3]),
                tt(c2.real), tt(c2.imag))
        want = torch_core.product_small(*args, th)
        keys = torch_core.pair_products(*args)
        T = M1 * M2
    ka, kb, cr, ci = sign_model(source, rows, coeffs, sign_launch_blocks(T, W))
    same_arrays([ka, kb] + ([cr, ci] if source == "pairs" else []), keys)
    got, _ = merge_small_model(ka, kb, cr, ci, th, rows, None, rng)
    same_arrays(got, want)
