"""K11, the GF(2) row reduction, against symmer_tpu and the native host path.

The plain version (``torch_gf2.rref``, what ``cuda.gf2_rref`` runs for CPU
tensors) must equal ``jx_gf2.rref_packed_device`` (JAX on the CPU backend)
and ``gf2core.rref_inplace`` bit for bit: the reduced rows are unique given
the row order.  Stacks of 2,048 and 4,096 rows, full rank and rank
deficient (repeated rows, zero rows, sums of earlier rows), one word and
several.  The route of ``gf2.rref_packed`` is the reference's: 2,048 rows
or more and ``config.use_device_io(R * W)``.
"""
import numpy as np
import pytest
import torch

from symmer_tpu import PauliwordOp as JOp
from symmer_tpu.kernels import pack as jpack
from symmer_tpu.kernels.jx_gf2 import rref_packed_device

from symmer_torch import config as tconfig
from symmer_torch.kernels import cuda, gf2, torch_gf2
from symmer_torch.native import gf2core
from symmer_torch.operators import from_numpy_planes


@pytest.fixture(autouse=True)
def restore_config():
    old = (tconfig.backend, tconfig.device)
    yield
    tconfig.backend, tconfig.device = old


def stack(seed, R, W, kind):
    """uint64[R, W]: random rows, then made rank deficient by kind."""
    r = np.random.default_rng(seed)
    M = r.integers(0, 1 << 63, size=(R, W), dtype=np.int64).view(np.uint64)
    M[:, -1] &= np.uint64((1 << 40) - 1)  # a ragged last word
    if kind == "repeats":
        M[R // 3:] = M[:R - R // 3]
    elif kind == "zeros":
        M[r.random(R) < 0.4] = 0
    elif kind == "sums":  # later rows are XORs of a few earlier ones
        for i in range(64, R):
            M[i] = M[r.integers(0, 64)] ^ M[r.integers(0, 64)]
    elif kind == "sparse":
        M &= r.integers(0, 1 << 63, size=(R, W), dtype=np.int64).view(np.uint64)
        M &= r.integers(0, 1 << 63, size=(R, W), dtype=np.int64).view(np.uint64)
    return M


def host(M):
    out = M.copy()
    gf2core.rref_inplace(out)
    return out


def reference_device(M):
    out = np.asarray(rref_packed_device(jpack.to_u32(M)))
    return jpack.from_u32(out)[:, : M.shape[1]]


def plain(M):
    return torch_gf2.rref(torch.from_numpy(M.view(np.int64).copy())).numpy().view(np.uint64)


CASES = [(2048, 1, "random"), (2048, 2, "repeats"), (2048, 1, "zeros"), (4096, 2, "sums"),
         (4096, 1, "sparse"), (2048, 3, "zeros")]


@pytest.mark.parametrize("R,W,kind", CASES)
def test_plain_rref_equals_references(R, W, kind):
    M = stack(R + W, R, W, kind)
    got = plain(M)
    assert np.array_equal(got, host(M))
    assert np.array_equal(got, reference_device(M))


def test_plain_rref_full_rank_and_empty():
    M = stack(3, 96, 2, "random")  # 96 rows of 104 bits: full row rank
    assert np.array_equal(plain(M), host(M))
    assert np.count_nonzero(plain(M).any(axis=1)) == 96
    Z = np.zeros((2048, 2), np.uint64)
    assert np.array_equal(plain(Z), Z)
    assert plain(np.zeros((0, 3), np.uint64)).shape == (0, 3)


@pytest.mark.parametrize("R,W", [(2048, 1), (2047, 40), (2048, 40)])
def test_rref_route(monkeypatch, R, W):
    """backend 'device': 2,048 rows or more reach cuda.gf2_rref (the plain
    version on the CPU device); fewer stay on the host."""
    calls = []
    real = cuda.gf2_rref
    monkeypatch.setattr(cuda, "gf2_rref", lambda t: calls.append(t.shape) or real(t))
    tconfig.backend, tconfig.device = "device", "cpu"
    M = stack(R, R, W, "sums")
    got = gf2.rref_packed(M)
    assert calls == ([(R, W)] if R >= 2048 else [])
    assert np.array_equal(got, host(M))
    assert not np.array_equal(got, M)  # not in place unless asked
    tconfig.backend = "host"
    calls.clear()
    assert np.array_equal(gf2.rref_packed(M), host(M)) and calls == []


def test_rref_route_auto_follows_the_work():
    tconfig.backend, tconfig.device = "auto", "cpu"
    M = stack(0, 2048, 1, "sums")
    assert not tconfig.use_device_io(M.size)  # 2,048 words: the host path
    assert np.array_equal(gf2.rref_packed(M), host(M))
    M = stack(1, 2048, 32, "sums")
    assert tconfig.use_device_io(M.size)       # 65,536 words: the device path
    assert np.array_equal(gf2.rref_packed(M, inplace=True), host(stack(1, 2048, 32, "sums")))


def test_rref_route_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tconfig.backend, tconfig.device = "device", "cuda"
    with pytest.raises(RuntimeError, match="is_available"):
        gf2.rref_packed(stack(0, 2048, 1, "random"))


def test_generators_of_a_large_operator_match():
    """PauliwordOp.generators on 2,400 terms over 40 qubits (the joint stack
    is 2,400 rows of 80 bits, rank 80) through the device route equals
    symmer_tpu's."""
    np.random.seed(4)
    op = JOp.random(40, 2400, density=0.3).cleanup()
    assert op.n_terms >= 2048
    tconfig.backend, tconfig.device = "device", "cpu"
    got = from_numpy_planes(op.x_pack, op.z_pack, op.coeff_vec, op.n_qubits).generators
    want = op.generators
    assert np.array_equal(got.x_pack, want.x_pack) and np.array_equal(got.z_pack, want.z_pack)
