"""The port's exchange (symmer_torch/parallel/distributed.py) on CPU meshes.

A mesh here is ``Mesh([cpu] * N)``: N shards, each step run on the CPU with
the plain versions of the kernels (``route_rows``, K16, is
torch_core.route_rows).  Checked: K16's plain version against a numpy
stable partition (0 rows, all kept, all sent); every row on the shard its
routing key's low bits address after log2 N rounds; all duplicates of one
term; a capacity sweep against the one-device cleanup; an overflow flagged
in the exchange and recovered through the public API; the noncontextual
brute force split over shards bit for bit the one-device search.
Coefficients within 1e-12 relative where the merge adds in another order.
"""
import numpy as np
import pytest
import torch

import symmer_torch
from symmer_torch import PauliwordOp, config
from symmer_torch.kernels import cuda, torch_core, torch_noncon
from symmer_torch.parallel import distributed, sharded
from symmer_torch.parallel.mesh import Mesh, shard_terms
from symmer_torch.profiling import kernel_stats

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def cpu_device():
    old = (config.backend, config.device, config.mesh_threshold)
    config.backend, config.device, config.mesh_threshold = "device", "cpu", 64
    yield
    config.backend, config.device, config.mesh_threshold = old


def planes(rng, T, W, dup=4):
    """Random int64 planes with duplicate rows (about T / dup distinct)."""
    base = rng.integers(-2**62, 2**62, (max(T // dup, 1), 2 * W))
    rows = base[rng.integers(0, base.shape[0], T)]
    return (torch.from_numpy(rows[:, :W].copy()), torch.from_numpy(rows[:, W:].copy()),
            torch.from_numpy(rng.normal(size=T)), torch.from_numpy(rng.normal(size=T)))


def as_dict(xs, zs, crs, cis, ns):
    """{(x bytes, z bytes): coefficient} over every shard's valid rows; a row
    seen twice fails."""
    out = {}
    for x, z, cr, ci, n in zip(xs, zs, crs, cis, ns):
        for i in range(n):
            key = (x[i].numpy().tobytes(), z[i].numpy().tobytes())
            assert key not in out, "a term on two shards, or twice on one"
            out[key] = complex(cr[i], ci[i])
    return out


def assert_close(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-12 * max(abs(v), 1e-300), (got[k], v)


def sharded_planes(x, z, cr, ci, N):
    mesh = Mesh([CPU] * N)
    L = -(-x.shape[0] // N)
    ns = [min(max(x.shape[0] - L * s, 0), L) for s in range(N)]
    return mesh, [shard_terms(a, mesh) for a in (x, z, cr, ci)], ns


@pytest.mark.parametrize("n,keep_all,send_all", [
    (0, False, False), (1, False, False), (300, False, False), (64, True, False),
    (64, False, True), (1000, False, False)])
@pytest.mark.parametrize("W", [1, 3])
def test_route_rows_plain_is_a_stable_partition(n, keep_all, send_all, W):
    rng = np.random.default_rng(n + W)
    x = rng.integers(-2**62, 2**62, (n, W))
    z = rng.integers(-2**62, 2**62, (n, W))
    cr, ci = rng.normal(size=n), rng.normal(size=n)
    key = rng.integers(-2**62, 2**62, n)
    k, bit = 3, 1
    if keep_all or send_all:
        key = key & ~(1 << k) | ((bit if keep_all else 1 - bit) << k)
    go = ((key >> k) & 1) == bit
    bufs = [(torch.full((n + 5, W), -7, dtype=torch.int64),
             torch.full((n + 5, W), -7, dtype=torch.int64),
             torch.full((n + 5,), -7.0, dtype=torch.float64),
             torch.full((n + 5,), -7.0, dtype=torch.float64)) for _ in range(2)]
    t = [torch.from_numpy(a) for a in (x, z, cr, ci, key)]
    counts = cuda.route_rows(*t, k, bit, *bufs)
    assert counts.tolist() == [int(go.sum()), int((~go).sum())]
    for side, rows in ((bufs[0], go), (bufs[1], ~go)):
        m = int(rows.sum())
        for got, want in zip(side, (x, z, cr, ci)):
            assert np.array_equal(got[:m].numpy(), want[rows])  # input order kept
            assert (got[m:].numpy() == -7).all()  # nothing past the count


@pytest.mark.parametrize("N", [2, 4, 8])
def test_rows_sit_on_the_shard_of_their_key(N):
    rng = np.random.default_rng(N)
    x, z, cr, ci = planes(rng, 480, 2)
    mesh, shards, ns = sharded_planes(x, z, cr, ci, N)
    xs, zs, crs, cis, n_out, ovf = distributed.distributed_cleanup(*shards, ns, mesh)
    assert not any(ovf)
    for s in range(N):
        assert xs[s].shape[0] == 2 * shards[0][0].shape[0]  # capacity 2 T_local
        ka, _ = torch_core.row_signature(xs[s][:n_out[s]], zs[s][:n_out[s]])
        assert ((ka & (N - 1)) == s).all()
    want = torch_core.cleanup_sorted(x, z, cr, ci)
    assert_close(as_dict(xs, zs, crs, cis, n_out),
                 as_dict(*([a] for a in want), [want[0].shape[0]]))


def test_all_duplicates_of_one_term():
    """Every row the same term: all go to one shard, and the merge before
    each round keeps one copy a shard, so capacity 2 holds."""
    T, W, N = 512, 3, 8
    x = torch.arange(1, W + 1, dtype=torch.int64).expand(T, W).contiguous()
    z = torch.arange(11, 11 + W, dtype=torch.int64).expand(T, W).contiguous()
    cr, ci = torch.full((T,), 0.25, dtype=torch.float64), torch.full((T,), -1.0,
                                                                   dtype=torch.float64)
    mesh, shards, ns = sharded_planes(x, z, cr, ci, N)
    *out, n_out, ovf = distributed.distributed_cleanup(*shards, ns, mesh)
    assert not any(ovf)
    got = as_dict(*out, n_out)
    assert list(got.values()) == [T * (0.25 - 1j)]


@pytest.mark.parametrize("capacity_factor", [1, 2, 4])
@pytest.mark.parametrize("zero_threshold", [None, 1e-10])
def test_capacity_factor_sweep(capacity_factor, zero_threshold):
    rng = np.random.default_rng(7)
    x, z, cr, ci = planes(rng, 256, 2)
    cr[1], ci[1], x[1], z[1] = -cr[0], -ci[0], x[0], z[0]  # one exact cancellation
    mesh, shards, ns = sharded_planes(x, z, cr, ci, 8)
    *out, n_out, ovf = distributed.distributed_cleanup(
        *shards, ns, mesh, zero_threshold=zero_threshold, capacity_factor=capacity_factor)
    if any(ovf):
        assert capacity_factor == 1  # a tight capacity may overflow: flagged
        return
    want = torch_core.cleanup_sorted(x, z, cr, ci, zero_threshold)
    assert_close(as_dict(*out, n_out), as_dict(*([a] for a in want), [want[0].shape[0]]))


def test_overflow_flagged_and_public_api_recovers():
    """Distinct rows all routed to shard 0: the exchange flags the overflow
    at capacity 2 (and the driver's retry at 4), and PauliwordOp.cleanup
    under use_mesh falls back to the one-device result."""
    N, T = 8, 256
    rng = np.random.default_rng(3)
    cand = rng.integers(0, 2**63, (40 * T, 2), dtype=np.uint64)
    ka, _ = torch_core.row_signature(*(torch.from_numpy(cand[:, i:i + 1].view(np.int64))
                                       for i in (0, 1)))
    rows = cand[(ka & (N - 1) == 0).numpy()][:T]
    assert len(rows) == T
    x64, z64 = rows[:, :1].copy(), rows[:, 1:].copy()
    c = np.arange(1, T + 1).astype(complex)
    mesh = Mesh([CPU] * N)
    shards = sharded._upload(x64, z64, c, mesh)
    *_, ovf = distributed.distributed_cleanup(*shards, mesh, zero_threshold=1e-15)
    assert any(ovf), "the skew must overflow capacity 2"
    assert sharded.cleanup(x64, z64, c, 1e-15, mesh) is None
    op = PauliwordOp.from_planes(x64, z64, c, 64)
    single = op.cleanup()
    kernel_stats.reset()
    with symmer_torch.use_mesh(mesh=mesh):
        out = op.cleanup()
    assert kernel_stats.mesh_calls["cleanup"] == 0
    assert out.n_terms == T and out == single


def test_fully_cancelled_operator_keeps_one_zero_row():
    op = PauliwordOp.from_planes(np.array([[5], [5]] * 40, np.uint64),
                                 np.array([[9], [9]] * 40, np.uint64),
                                 np.array([1.0, -1.0] * 40, complex), 64)
    with symmer_torch.use_mesh(mesh=Mesh([CPU] * 4)):
        x, z, c = sharded.cleanup(op.x_pack, op.z_pack, op.coeff_vec, 1e-15, config.mesh)
    assert x.shape == (1, 1) and not x.any() and not z.any() and c.tolist() == [0j]


def search(rng, M, n_free, n_cliques):
    clique = rng.integers(-1, n_cliques, M)
    mCi = np.array([(clique == i) for i in range(n_cliques)], float).reshape(-1, M)
    return (rng.integers(0, 2, (M, n_free)), rng.integers(0, 2, M), rng.normal(size=M),
            (clique < 0).astype(float), mCi)


@pytest.mark.parametrize("N", [2, 3, 4, 8])
@pytest.mark.parametrize("M,n_free,n_cliques", [(40, 6, 2), (120, 12, 3), (9, 2, 1)])
def test_sharded_brute_force_is_the_one_device_search_bit_for_bit(N, M, n_free, n_cliques):
    """Ranges of [0, 2^n_free) one a shard (some empty when 2^n_free < N),
    the minimum over the shards' minima: the same index and the same energy
    bits as one search; also the plain version over each range."""
    args = search(np.random.default_rng(M + N), M, n_free, n_cliques)
    e1, k1 = torch_noncon.brute_force_minimise(*args, n_free, CPU)
    eN, kN = torch_noncon.brute_force_minimise(*args, n_free, CPU, mesh=Mesh([CPU] * N))
    assert kN == k1 and np.float64(eN).view(np.int64) == np.float64(e1).view(np.int64)
    g, b, off, nc = torch_noncon.kernel_inputs(*args, CPU)
    S = 1 << n_free
    parts = [torch_noncon.brute_force_plain(g, b, off, n_free, nc, chunk=5,
                                            start=s * S // N, stop=(s + 1) * S // N)
             for s in range(N) if s * S // N < (s + 1) * S // N]
    e, k = min((float(e), int(k)) for e, k in parts)
    assert (e, k) == (e1, k1)


def test_mesh_rotations_drop_exact_zeros_under_none():
    """sharded.perform_rotations turns zero_threshold=None into 0.0, as
    symmer_tpu's mesh driver does (its sharded.py:179): an exact zero
    survives the one-device route and not the mesh's (ROADMAP Queue 3)."""
    from symmer_torch.kernels import dispatch

    rng = np.random.default_rng(8)
    x = rng.integers(0, 2**63, (80, 1), dtype=np.uint64)
    z = rng.integers(0, 2**63, (80, 1), dtype=np.uint64)
    c = rng.normal(size=80) + 0j
    c[5] = 0
    rot = [(np.array([3], np.uint64), np.array([5], np.uint64), 0.3)]
    one = dispatch.perform_rotations(x, z, c, rot, None)
    mesh = sharded.perform_rotations(x, z, c, rot, None, Mesh([CPU] * 4))
    assert len(one[2]) == len(mesh[2]) + 1 and (one[2] == 0).sum() == 1
    assert not (mesh[2] == 0).any()
