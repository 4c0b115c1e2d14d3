"""The hand-written CUDA kernels against their plain torch versions.

These tests need a CUDA card and skip without one.  tests/conftest.py
configures JAX, which the machine with the card need not have, so run them
from the repository root with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

anticommutes must equal its plain version exactly and clifford_scan bit for
bit, at ragged shapes, word edges, both anticommutes regimes (tall-skinny,
binary tensor-core product) and both clifford_scan variants (rows in
registers up to 16 words, streamed beyond).
"""
import numpy as np
import pytest
import torch

from symmer_torch.kernels import cuda, pack, torch_core

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
    assert cuda.launches == {"anticommutes": 0, "clifford_scan": 0}


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
