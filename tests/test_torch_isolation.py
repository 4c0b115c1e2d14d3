"""symmer_torch stands alone: no jax, no symmer_tpu, no silent CPU fallback."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import symmer_torch
from symmer_torch import config
from symmer_torch.kernels import cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_pulls_in_neither_jax_nor_symmer_tpu():
    code = (
        "import sys, symmer_torch\n"
        "from symmer_torch import PauliwordOp, QubitTapering, DeviceOperator, config\n"
        "import symmer_torch.kernels.dispatch, symmer_torch.kernels.cuda\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'symmer_tpu'))\n"
        "print(repr(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    assert out == "[]"


def test_device_backend_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    old = (config.backend, config.device)
    config.backend, config.device = "device", "cuda"
    try:
        op = symmer_torch.PauliwordOp.from_list(["XZ", "ZX", "XZ"], [1, 2, 3])
        with pytest.raises(RuntimeError, match="is_available"):
            op.cleanup()
        with pytest.raises(RuntimeError, match="is_available"):
            op.to_device()
        config.backend = "host"  # the host path needs no device
        assert op.cleanup().n_terms == 2
    finally:
        config.backend, config.device = old


def test_kernel_wrappers_refuse_other_devices():
    t = torch.zeros((3, 2), dtype=torch.int64, device="meta")
    r = torch.zeros(3, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda.anticommutes(t, t, t, t)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda.clifford_scan(t, t, r, r, t, t, torch.zeros(3, dtype=torch.int64, device="meta"))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("NVCC", str(tmp_path / "no-nvcc"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cuda.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda.build()


def test_launch_counts_reset():
    cuda.launches["anticommutes"] = 3
    cuda.reset_launches()
    assert set(cuda.launches) == {"anticommutes", "clifford_scan"}
    assert all(n == 0 for n in cuda.launches.values())
    # CPU tensors take the plain version: nothing is launched or counted
    x = torch.from_numpy(np.array([[1], [2]], np.int64))
    cuda.anticommutes(x, x, x, x)
    assert cuda.launches["anticommutes"] == 0
