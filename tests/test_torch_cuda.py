"""The hand-written CUDA kernels against their plain torch versions.

These tests need a CUDA card and skip without one.  tests/conftest.py
configures JAX, which the machine with the card need not have, so run them
from the repository root with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

anticommutes must equal its plain version exactly and clifford_scan bit for
bit, at ragged shapes, word edges and both clifford_scan variants (rows in
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
