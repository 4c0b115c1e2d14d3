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
  - state_expval.cu: the walk of each thread over the flattened (term,
    basis row) pairs, the lower-bound binary search over the sorted state
    rows with targets formed word by word, and the per-pair arithmetic;
  - noncon_brute.cu: the bitmask parity popc(kk & gmask) & 1 with the fixed
    parity in bit 31, the sign flip as an XOR of the float64's top bit, the
    per-segment sums across shared-memory tiles and the (min, argmin) fold.

The references: np_core.anticommutes, the Pallas kernel in interpret mode
(pallas_gf2.anticommutes_tiled) and jx_core.anticommutes; torch_core and
jx_core.clifford_scan, bit for bit, signed zeros included; state_core.expval
(within 1e-12 relative); jx_noncon's float parity matmul (exactly) and its
brute-force (min, argmin).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax import lax

from symmer_tpu.kernels import jx_core, jx_noncon, np_core, pack, state_core
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


def expval_model(x, z, c, s, a):
    """state_expval.cu per pair: rows sorted (word 0 first, signed words),
    the lower bound of s_b ^ x_t with target words formed on the fly, an
    exact whole-row compare, then a_b conj(a_b'), c_t (-i)^y and the sign."""
    xs, zs = x.view(np.int64), z.view(np.int64)
    order = np.lexsort(s.view(np.int64).T[::-1])
    S, A = s.view(np.int64)[order], a[order]
    B, W = S.shape
    total = 0j
    for t in range(xs.shape[0]):
        y = int(popc(x[t] & z[t]).sum())
        c_t = c[t] * (-1j) ** (y % 4)
        for b in range(B):
            target = S[b] ^ xs[t]
            par = int(popc((S[b] ^ xs[t]).view(np.uint64) & z[t]).sum()) & 1
            lo, hi = 0, B
            while lo < hi:
                mid = (lo + hi) >> 1
                diff = np.flatnonzero(S[mid] != target)
                before = diff.size > 0 and S[mid][diff[0]] < target[diff[0]]
                lo, hi = (mid + 1, hi) if before else (lo, mid)
            if lo < B and np.array_equal(S[lo], target):
                total += c_t * A[b] * np.conj(A[lo]) * (1 - 2 * par)
    return total


@pytest.mark.parametrize("n_qubits,T,B", [(1, 3, 2), (20, 12, 9), (64, 8, 16), (130, 10, 7)])
def test_expval_binary_search_model_matches_state_core(n_qubits, T, B):
    rng = np.random.default_rng(n_qubits + T + B)
    x, z = planes(rng, T, n_qubits, 0.3), planes(rng, T, n_qubits, 0.3)
    x[0] = 0
    s = planes(rng, 1, n_qubits)
    for t in rng.integers(0, T, B - 1):
        s = np.vstack([s, s[-1] ^ x[t]])
    s = np.unique(s, axis=0)
    c = rng.normal(size=T) + 1j * rng.normal(size=T)
    a = rng.normal(size=s.shape[0]) + 1j * rng.normal(size=s.shape[0])
    model = expval_model(x, z, c, s, a)
    want = state_core.expval(x, z, c, s, a)
    assert abs(model - want) <= 1e-12 * abs(want)
    got = torch_state.expval(tt(x), tt(z), tt(c.real), tt(c.imag), tt(s), tt(a.real), tt(a.imag))
    assert abs(complex(float(got[0]), float(got[1])) - want) <= 1e-12 * abs(want)


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


def brute_model(gmask, base, seg_off, n_free, tile, threads=8, per_thread=4, blocks=3):
    """noncon_brute.cu with small blocks: each pass gives a thread
    per_thread consecutive indices; segment sums run term by term with tiles
    of `tile` terms reloaded whenever the next term lies outside (the
    barrier-synchronised reload); each thread keeps a running (min, argmin),
    then the block tree and the final fold, ties to the smaller index."""
    N, M = 1 << n_free, gmask.shape[0]
    full = np.uint32(N - 1)
    better = lambda e2, k2, e1, k1: e2 < e1 or (e2 == e1 and k2 < k1)
    per_block = threads * per_thread
    part = []
    for blk in range(blocks):
        best = [(np.inf, 2**63 - 1)] * threads
        first = blk * per_block
        while first < N:
            for th in range(threads):
                k0 = first + th * per_thread
                kk = (~np.arange(k0, k0 + per_thread, dtype=np.uint32) & full) | np.uint32(1 << 31)
                s0 = np.zeros(per_thread)
                sq = np.zeros(per_thread)
                t0 = t1 = 0
                reloads = 0
                for seg in range(len(seg_off) - 1):
                    acc = np.zeros(per_thread)
                    for m in range(seg_off[seg], seg_off[seg + 1]):
                        if m < t0 or m >= t1:
                            t0, t1 = m, min(M, m + tile)
                            reloads += 1
                        par = np.bitwise_count(kk & np.uint32(gmask[m])) & 1
                        acc += sign_flip(np.full(per_thread, base[m]), par)
                    if seg == 0:
                        s0 += acc
                    else:
                        sq += acc * acc
                assert reloads == -(-M // tile)
                for j in range(per_thread):
                    e = s0[j] - np.sqrt(sq[j])
                    if k0 + j < N and better(e, k0 + j, *best[th]):
                        best[th] = (e, k0 + j)
            first += blocks * per_block
        off = threads // 2
        while off:
            for th in range(off):
                if better(*best[th + off], *best[th]):
                    best[th] = best[th + off]
            off //= 2
        part.append(best[0])
    e, k = np.inf, 2**63 - 1
    for pe, pk in part:
        if better(pe, pk, e, k):
            e, k = pe, pk
    return e, k


@pytest.mark.parametrize("M,n_free,n_cliques,tile", [
    (12, 5, 2, 64), (30, 7, 3, 7), (9, 6, 0, 4), (25, 8, 1, 25),
])
def test_brute_force_model_matches_jx_noncon(M, n_free, n_cliques, tile):
    rng = np.random.default_rng(M + n_free + tile)
    F = rng.integers(0, 2, (M, n_free)).astype(float)
    fixed = rng.integers(0, 2, M).astype(float)
    base = rng.normal(size=M)
    clique = rng.integers(-1, n_cliques, M) if n_cliques else np.full(M, -1)
    mCi = np.array([(clique == i) for i in range(n_cliques)], float).reshape(-1, M)
    mS0 = (clique < 0).astype(float)
    g, b, off, _ = torch_noncon.kernel_inputs(F, fixed, base, mS0, mCi, torch.device("cpu"))
    e, k = brute_model(g.numpy(), b.numpy(), off.tolist(), n_free, tile)
    e_j, k_j = jx_noncon.brute_force_minimise(F, fixed, base, mS0, mCi, n_free)
    assert abs(e - e_j) <= 1e-12 * max(1.0, abs(e_j))
    assert k == k_j
