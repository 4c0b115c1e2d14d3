"""symmer_torch stands alone: no jax, no symmer_tpu, no silent CPU fallback."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import symmer_torch
from symmer_torch import config
from symmer_torch.kernels import cuda, torch_vqe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_pulls_in_neither_jax_nor_symmer_tpu():
    code = (
        "import sys, symmer_torch\n"
        "from symmer_torch import PauliwordOp, QubitTapering, DeviceOperator, config\n"
        "from symmer_torch import ContextualSubspace, QubitSubspaceManager\n"
        "from symmer_torch.operators import AntiCommutingOp, NoncontextualOp, NoncontextualSolver\n"
        "import symmer_torch.kernels.dispatch, symmer_torch.kernels.cuda\n"
        "import symmer_torch.kernels.torch_state, symmer_torch.kernels.torch_noncon\n"
        "import symmer_torch.utils, symmer_torch.projection.utils\n"
        "import symmer_torch.kernels.lanczos, symmer_torch.kernels.torch_lanczos\n"
        "import symmer_torch.approximate\n"
        "import symmer_torch.evolution, symmer_torch.evolution.device_vqe\n"
        "import symmer_torch.command_line, symmer_torch.io, symmer_torch.parallel\n"
        "import symmer_torch.kernels.torch_vqe, symmer_torch.kernels.torch_gf2\n"
        "import symmer_torch.parallel.mesh, symmer_torch.parallel.distributed\n"
        "import symmer_torch.parallel.sharded, symmer_torch.kernels.rotations\n"
        "from symmer_torch import use_mesh, distributed_init\n"
        "from symmer_torch import process\n"
        "from symmer_torch.profiling import trace\n"
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
    with pytest.raises(ValueError, match="unsupported device"):
        cuda.expval(t, t, r, r, t, r, r)
    i = torch.zeros(3, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda.brute_force_minimise(i, r, i, 2, 1)
    c = torch.zeros((1, 4), dtype=torch.complex128, device="meta")
    i32 = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda.group_matvec(i[:1], i32, i32[:1], c[0, :1], c)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda.lanczos_step(c[0], c[0], c[0], c[0], r, r, 0)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda.lanczos_replay(c[0], c[0], c[0], r, r, 0, r[:, None], c)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda.lanczos_ritz(c, r[:, None], 1)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda.build_group_diagonals(i, i, r.to(torch.complex128), 1, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda.vqe_rotate(c[0], 0, 0, 1.0, 0.0, 1.0, 0.0)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda.vqe_runs(c[0], None, r[:, None])
    with pytest.raises(ValueError, match="unsupported device"):
        cuda.vqe_adjoint(c[0], c[0], None, r[:, None])
    with pytest.raises(ValueError, match="unsupported device"):
        cuda.pauli_overlaps(c[0], c[0], i, i, r[:, None].expand(3, 2).contiguous(), (i, i, i))
    with pytest.raises(ValueError, match="unsupported device"):
        cuda.gf2_rref(t)
    bufs = (t, t.clone(), r, r.clone())
    with pytest.raises(ValueError, match="unsupported device"):
        cuda.route_rows(t, t, r, r, i, 0, 0, bufs, bufs)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda.row_signature(t, t)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda.rotation_rows(t, t, r, r, t[0], t[1], 0.6, 0.8)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda.project_rows(t, t, r, r, t.bool(), t[0], t[1], t[0])
    with pytest.raises(ValueError, match="unsupported device"):
        cuda.sort_keys(t[:, 0])
    with pytest.raises(ValueError, match="unsupported device"):
        cuda.merge_groups(i, t[:, 0], t[:, 0], t[:, 0], r, r, None, (t, t))
    with pytest.raises(ValueError, match="unsupported device"):
        cuda.merge_small(t[:, 0], t[:, 0], r, r, None, (t, t))
    with pytest.raises(ValueError, match="unsupported device"):
        cuda.cleanup_small(t, t, r, r, None)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda.product_small(t, t, r, r, t, t, r, r, None)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("NVCC", str(tmp_path / "no-nvcc"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cuda.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda.build()


def test_launch_counts_reset():
    cuda.launches["anticommutes"] = 3
    cuda.reset_launches()
    assert set(cuda.launches) == {
        "anticommutes", "clifford_scan", "expval", "brute_force_minimise",
        "group_matvec", "build_group_diagonals", "lanczos_step", "lanczos_replay",
        "lanczos_ritz", "vqe_rotate", "vqe_adjoint", "pauli_overlaps", "gf2_rref", "route_rows",
        "row_signature", "pair_products", "merge_groups", "rotation_rows", "project_rows",
        "sort_keys", "merge_small", "sign_merge_small"}
    assert set(cuda.calls) == set(cuda.launches)
    assert all(n == 0 for n in cuda.launches.values())
    # CPU tensors take the plain version: nothing is launched or counted
    x = torch.from_numpy(np.array([[1], [2]], np.int64))
    cuda.anticommutes(x, x, x, x)
    r = torch.ones(2, dtype=torch.float64)
    cuda.expval(x, x, r, r, x, r, r)
    cuda.brute_force_minimise(x[:, 0].contiguous(), r, torch.tensor([0, 2]), 3, 0)
    c = torch.ones((1, 4), dtype=torch.complex128)
    cuda.group_matvec(torch.tensor([1]), torch.tensor([0, 1], dtype=torch.int32),
                      torch.tensor([2], dtype=torch.int32), c[0, :1].clone(), c)
    ab = torch.zeros(2, dtype=torch.float64)
    cuda.lanczos_step(c[0].clone(), c[0].clone(), c[0], c[0].clone(), ab, ab.clone(), 0)
    cuda.lanczos_replay(c[0].clone(), c[0].clone(), c[0], ab, ab, 0, ab[:, None].clone(), c.clone())
    cuda.lanczos_ritz(c, ab[:1, None].clone(), 1)
    cuda.build_group_diagonals(torch.tensor([0]), torch.tensor([3]), c[0, :1].clone(), 1, 2)
    cuda.vqe_rotate(c[0], 1, 2, 0.0, -1.0, 0.6, 0.8)
    cuda.pauli_overlaps(c[0], c[0], torch.tensor([1]), torch.tensor([3]),
                        torch.tensor([[1.0, 0.0]]), cuda.overlap_groups([1], 4, "cpu"))
    plan = torch_vqe.plan_runs([1, 3], [2, 0], [1.0, 1.0], 2).on("cpu")
    cs = torch.tensor([[0.6, 0.8], [0.8, 0.6]], dtype=torch.float64)
    cuda.vqe_runs(c[0], plan, cs)
    cuda.vqe_adjoint(c[0], c[0].clone(), plan, cs)
    cuda.gf2_rref(x.clone())
    bufs = [(torch.empty_like(x), torch.empty_like(x), r.clone(), r.clone()) for _ in range(2)]
    cuda.route_rows(x, x, r, r, x[:, 0].contiguous(), 0, 1, *bufs)
    cuda.row_signature(x, x)
    ka, kb, pr, pi = cuda.pair_products(x, x, r, r, x, x, r, r)
    cuda.merge_groups(*cuda.sort_keys(ka), ka, kb, pr, pi, None, (x, x, x, x))
    ka, kb, pr, pi, live = cuda.rotation_rows(x, x, r, r, x[0], x[1], 0.6, 0.8)
    cuda.merge_groups(*cuda.sort_keys(ka), ka, kb, pr, pi, None, (x, x, x[0], x[1]), live)
    ka, kb, pr, pi, live = cuda.project_rows(x, x, r, r, x.bool(), x[0], x[1], x[0])
    cuda.merge_groups(*cuda.sort_keys(ka), ka, kb, pr, pi, None, (x, x, x[0]), live)
    cuda.merge_small(ka, kb, pr, pi, None, (x, x, x[0]), live)
    cuda.cleanup_small(x, x, r, r, None)
    cuda.product_small(x, x, r, r, x, x, r, r, None)
    assert all(n == 0 for n in cuda.launches.values())
    assert all(n == 0 for n in cuda.calls.values())
