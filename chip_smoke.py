#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (symmer_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases (each prints one line; any failure raises and exits non-zero):
  0. device: nvidia-smi name and power limit, torch's device name;
  1. build: compile the CUDA kernels from symmer_torch/csrc with nvcc;
  2. kernels against their plain torch versions on the card, with times;
  3. chemistry: LiH and H2 tapered on the card (resident taper), ground
     energies against their pins to 1e-10;
  4. flagship: the 1000-qubit x 200,000-term, 4-symmetry synthetic taper,
     resident on the card against the port's host path;
  5. algebra core: squaring, a non-Clifford rotation and a DeviceOperator
     chain on the card against the host path;
  6. coverage: both kernels were launched by phases 3-5.

The line before the last is a JSON object with each kernel's launches,
error and times; the last line is {"ok": true, "device": {...}}.
Imports neither jax nor symmer_tpu.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
LIH_FILE = os.path.join(REPO, "tests", "data", "hamiltonians", "LiH_STO-3G_SINGLET_JW.json")
LIH_TAPERED_GS = -7.8827622309719985       # tests/test_projection/test_molecule_parity.py:56
H2_FCI = -1.1368382276023516               # tests/conftest.py:73
H2_JW = {
    "IIII": -0.05933866442819677, "IIIZ": -0.23676939575319134,
    "IIZI": -0.23676939575319134, "IIZZ": 0.17571274411978302,
    "IZII": 0.17579122569046912, "IZIZ": 0.12223870791335416,
    "IZZI": 0.16715312911492025, "ZIII": 0.17579122569046912,
    "ZIIZ": 0.16715312911492025, "ZIZI": 0.12223870791335416,
    "ZZII": 0.17002500620877006, "XXYY": -0.044914421201566114,
    "XYYX": 0.044914421201566114, "YXXY": 0.044914421201566114,
    "YYXX": -0.044914421201566114,
}
ENERGY_TOL = 1e-10
COEFF_RTOL = 1e-12

# full sizes of the run on the card
FULL = dict(
    ac_shapes=[(300, 70, 100), (10, 600, 40), (200_000, 4, 1000), (4096, 4096, 1000)],
    ac_main=(200_000, 4, 1000),   # the projection filter's shape: reported in the JSON
    scan=(200_000, 1000, 64),
    flagship=(1000, 200_000, 4, 1),
    square=(1000, 500),
    rotation=(1000, 100_000),
    chain=(1000, 2000, 200),
)


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def device_ms(fn, device, reps: int = 10) -> float:
    """Mean milliseconds of fn() after a warm-up: CUDA events on the card."""
    import torch

    fn()
    sync(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def best_of(fn, device, n: int = 3):
    """(best wall ms of n warm runs, last result); one warm-up run first."""
    out = fn()
    sync(device)
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best, out


def rand_planes(rng, rows: int, n_qubits: int, density: float = 0.5) -> np.ndarray:
    """uint64[rows, ceil(n/64)] planes with each qubit bit set w.p. density."""
    from symmer_torch.kernels import pack

    return pack.pack_bits(rng.random((rows, n_qubits)) < density, n_qubits)


def synthetic_taper_operator(n_qubits, n_terms, n_sym, seed):
    """Random operator with n_sym planted Z2 symmetries: the generator of
    bench.py:647-664 (qubits split into n_sym blocks; every term's X support
    has even overlap with each block, so each block's all-Z string commutes
    with the whole operator)."""
    from symmer_torch import PauliwordOp

    rng = np.random.default_rng(seed)
    block = n_qubits // n_sym
    xb = rng.integers(0, 2, (n_terms, n_qubits)).astype(bool)
    zb = rng.integers(0, 2, (n_terms, n_qubits)).astype(bool)
    for k in range(n_sym):
        parity = xb[:, k * block : (k + 1) * block].sum(axis=1) & 1
        xb[parity == 1, k * block] ^= True
    coeffs = rng.normal(size=n_terms) + 1j * rng.normal(size=n_terms)
    return PauliwordOp(np.hstack([xb, zb]), coeffs).cleanup()


def random_operator(rng, n_qubits, n_terms, density=0.3, n_diagonal=0):
    """Random operator; its first n_diagonal terms are I/Z-only."""
    from symmer_torch import PauliwordOp

    x = rand_planes(rng, n_terms, n_qubits, density)
    x[:n_diagonal] = 0
    return PauliwordOp.from_planes(
        x, rand_planes(rng, n_terms, n_qubits, density),
        rng.normal(size=n_terms) + 1j * rng.normal(size=n_terms), n_qubits,
    ).cleanup()


def single_pauli(rng, n_qubits, density=0.1):
    from symmer_torch import PauliwordOp

    return PauliwordOp.from_planes(
        rand_planes(rng, 1, n_qubits, density), rand_planes(rng, 1, n_qubits, density),
        [1.0], n_qubits,
    )


def compare_ops(a, b) -> float:
    """Assert equal term sets; return the largest relative coefficient error."""
    assert a.n_qubits == b.n_qubits, (a.n_qubits, b.n_qubits)
    assert a.n_terms == b.n_terms, f"term counts differ: {a.n_terms} vs {b.n_terms}"

    def ordered(op):
        rows = np.hstack([op.x_pack, op.z_pack])
        order = np.lexsort(rows.T[::-1])
        return rows[order], op.coeff_vec[order]

    ra, ca = ordered(a)
    rb, cb = ordered(b)
    assert np.array_equal(ra, rb), "term sets differ"
    scale = np.maximum(np.maximum(np.abs(ca), np.abs(cb)), np.finfo(float).tiny)
    err = float(np.max(np.abs(ca - cb) / scale)) if len(ca) else 0.0
    assert err <= COEFF_RTOL, f"coefficients differ by {err:.3e} relative"
    return err


def ground_energy(op) -> float:
    return float(np.linalg.eigvalsh(op.to_sparse_matrix.toarray())[0])


# -- phases -------------------------------------------------------------------

def phase_kernels(device, sizes, rng):
    """Phase 2: each kernel against its plain torch version on `device`."""
    import torch

    from symmer_torch.kernels import cuda, torch_core

    to = lambda a: torch.tensor(np.ascontiguousarray(a).view(np.int64), device=device)
    report = {}
    ac_err, ac_times = 0, {}
    for m1, m2, nq in sizes["ac_shapes"]:
        x1, z1 = to(rand_planes(rng, m1, nq)), to(rand_planes(rng, m1, nq))
        x2, z2 = to(rand_planes(rng, m2, nq)), to(rand_planes(rng, m2, nq))
        got = cuda.anticommutes(x1, z1, x2, z2)
        want = torch_core.anticommutes(x1, z1, x2, z2)
        sync(device)
        err = int((got.to(torch.int16) - want.to(torch.int16)).abs().max())
        assert torch.equal(got, want), f"anticommutes differs at {(m1, m2, nq)}"
        ac_err = max(ac_err, err)
        t_k = device_ms(lambda: cuda.anticommutes(x1, z1, x2, z2), device)
        t_p = device_ms(lambda: torch_core.anticommutes(x1, z1, x2, z2), device, reps=3)
        ac_times[(m1, m2, nq)] = (t_k, t_p)
        say("2 kernels", kernel="anticommutes", shape=f"{m1}x{m2}x{nq}q",
            equal=True, ms=f"{t_k:.4f}", plain_ms=f"{t_p:.4f}")
    main_shape = sizes["ac_main"]
    report["anticommutes"] = dict(max_abs_err=ac_err, ms=ac_times[main_shape][0],
                                  plain_ms=ac_times[main_shape][1],
                                  shape=f"{main_shape[0]}x{main_shape[1]}x{main_shape[2]}q")

    T, nq, D = sizes["scan"]
    x, z = to(rand_planes(rng, T, nq)), to(rand_planes(rng, T, nq))
    cr = torch.tensor(rng.normal(size=T), device=device)
    ci = torch.tensor(rng.normal(size=T), device=device)
    rx, rz = to(rand_planes(rng, D, nq, 0.05)), to(rand_planes(rng, D, nq, 0.05))
    rm = torch.tensor(rng.integers(-4, 5, D), dtype=torch.int64, device=device)
    got = cuda.clifford_scan(x, z, cr, ci, rx, rz, rm)
    want = torch_core.clifford_scan(x, z, cr, ci, rx, rz, rm)
    sync(device)
    for name, g, w in zip(("x", "z", "cr", "ci"), got, want):
        g_bits = g.view(torch.int64) if g.dtype == torch.float64 else g
        w_bits = w.view(torch.int64) if w.dtype == torch.float64 else w
        assert torch.equal(g_bits, w_bits), f"clifford_scan {name} differs bitwise"
    scan_err = max(float((got[2] - want[2]).abs().max()), float((got[3] - want[3]).abs().max()))
    changed = int((got[0] != x).any(dim=1).sum())
    t_k = device_ms(lambda: cuda.clifford_scan(x, z, cr, ci, rx, rz, rm), device)
    t_p = device_ms(lambda: torch_core.clifford_scan(x, z, cr, ci, rx, rz, rm), device, reps=3)
    say("2 kernels", kernel="clifford_scan", shape=f"{T}x{nq}q_D{D}", bitwise_equal=True,
        rows_changed=changed, ms=f"{t_k:.4f}", plain_ms=f"{t_p:.4f}")
    report["clifford_scan"] = dict(max_abs_err=scan_err, ms=t_k, plain_ms=t_p,
                                   shape=f"{T}x{nq}q_D{D}")
    return report


def phase_chemistry(device):
    """Phase 3: LiH and H2 resident tapers against their pinned energies."""
    from symmer_torch import PauliwordOp, QubitTapering

    with open(LIH_FILE) as f:
        data = json.load(f)
    H = PauliwordOp.from_dictionary(data["hamiltonian"])
    t0 = time.perf_counter()
    tapered = QubitTapering(H).taper_it(
        ref_state=np.asarray(data["data"]["hf_array"]), aux_operator=H.to_device()
    ).to_host()
    sync(device)
    t_lih = (time.perf_counter() - t0) * 1e3
    e_lih = ground_energy(tapered)
    assert abs(e_lih - LIH_TAPERED_GS) < ENERGY_TOL, f"LiH {e_lih!r} vs {LIH_TAPERED_GS!r}"
    say("3 chemistry", system="LiH_STO-3G", qubits=f"{H.n_qubits}->{tapered.n_qubits}",
        terms=tapered.n_terms, energy=repr(e_lih), err=f"{abs(e_lih - LIH_TAPERED_GS):.2e}",
        wall_ms=f"{t_lih:.1f}")

    H2 = PauliwordOp.from_dictionary(H2_JW)
    tapered = QubitTapering(H2).taper_it(
        ref_state=np.array([1, 1, 0, 0]), aux_operator=H2.to_device()
    ).to_host()
    e_h2 = ground_energy(tapered)
    assert abs(e_h2 - H2_FCI) < ENERGY_TOL, f"H2 {e_h2!r} vs FCI {H2_FCI!r}"
    say("3 chemistry", system="H2_STO-3G", qubits=f"{H2.n_qubits}->{tapered.n_qubits}",
        energy=repr(e_h2), err=f"{abs(e_h2 - H2_FCI):.2e}")


def phase_flagship(device, sizes, config):
    """Phase 4: the synthetic taper, resident on the card vs the host path."""
    from symmer_torch import QubitTapering

    nq, nt, ns, seed = sizes["flagship"]
    t0 = time.perf_counter()
    H = synthetic_taper_operator(nq, nt, ns, seed)
    qt = QubitTapering(H)
    ref = np.zeros(nq, dtype=int)
    H_dev = H.to_device()
    sync(device)
    say("4 flagship", operator=f"{nq}q_x_{H.n_terms}terms", symmetries=qt.n_taper,
        setup_s=f"{time.perf_counter() - t0:.2f}")
    t_res, out = best_of(lambda: qt.taper_it(ref_state=ref, aux_operator=H_dev), device)
    resident = out.to_host()
    config.backend = "host"
    try:
        qt_host = QubitTapering(H)
        t_host, host = best_of(lambda: qt_host.taper_it(ref_state=ref), device)
    finally:
        config.backend = "device"
    err = compare_ops(resident, host)
    say("4 flagship", tapered=f"{resident.n_qubits}q_x_{resident.n_terms}terms",
        same_term_set=True, max_rel_err=f"{err:.2e}",
        resident_best_ms=f"{t_res:.2f}", host_best_ms=f"{t_host:.2f}")
    return dict(resident_ms=t_res, host_ms=t_host)


def phase_algebra(device, sizes, config, rng):
    """Phase 5: squaring, non-Clifford rotation, DeviceOperator chain."""
    def both(fn):
        t_dev, dev_out = best_of(fn, device)
        config.backend = "host"
        try:
            t_host, host_out = best_of(fn, device)
        finally:
            config.backend = "device"
        return t_dev, dev_out, t_host, host_out

    nq, nt = sizes["square"]
    A = random_operator(rng, nq, nt)
    t_dev, dev_out, t_host, host_out = both(lambda: A * A)
    err = compare_ops(dev_out, host_out)
    say("5 algebra", op=f"square_{nq}q_x_{A.n_terms}", out_terms=dev_out.n_terms,
        max_rel_err=f"{err:.2e}", device_best_ms=f"{t_dev:.2f}", host_best_ms=f"{t_host:.2f}")

    nq, nt = sizes["rotation"]
    B = random_operator(rng, nq, nt)
    r = single_pauli(rng, nq, 0.3)
    t_dev, dev_out, t_host, host_out = both(lambda: B.perform_rotations([(r, 0.3)]))
    err = compare_ops(dev_out, host_out)
    say("5 algebra", op=f"rotation_{nq}q_x_{B.n_terms}", out_terms=dev_out.n_terms,
        max_rel_err=f"{err:.2e}", device_best_ms=f"{t_dev:.2f}", host_best_ms=f"{t_host:.2f}")

    nq, n1, n2 = sizes["chain"]
    C1 = random_operator(rng, nq, n1, 0.02, n_diagonal=n1 // 2)
    C2 = random_operator(rng, nq, n2, 0.02, n_diagonal=n2 // 2)
    rots = [(single_pauli(rng, nq, 0.02), a) for a in (0.3, None, np.pi, 0.7, -np.pi / 2)]
    t0 = time.perf_counter()
    chain = C1.to_device().cleanup().multiply(C2.to_device()).perform_rotations(rots)
    e_dev = chain.expval_iz()
    sync(device)
    t_chain = (time.perf_counter() - t0) * 1e3
    config.backend = "host"
    try:
        host_chain = (C1.cleanup() * C2).perform_rotations(rots)
    finally:
        config.backend = "device"
    err = compare_ops(chain.to_host(), host_chain)
    diag = ~np.any(host_chain.x_pack != 0, axis=1)
    e_host = complex(np.sum(host_chain.coeff_vec[diag]))
    assert diag.any() and abs(e_dev - e_host) <= 1e-12 * max(1.0, abs(e_host)), (e_dev, e_host)
    say("5 algebra", op=f"chain_{nq}q_{C1.n_terms}x{C2.n_terms}_rot{len(rots)}",
        out_terms=chain.n_terms, max_rel_err=f"{err:.2e}", expval_iz=repr(e_dev),
        wall_ms=f"{t_chain:.2f}")


def run(device, sizes, config):
    """Phases 2-6 on `device`; returns (kernel report, launch counts)."""
    from symmer_torch.kernels import cuda
    from symmer_torch.profiling import kernel_stats

    rng = np.random.default_rng(0)
    report = phase_kernels(device, sizes, rng)
    # main path: counts from here on are the phases 3-5 launches only
    cuda.reset_launches()
    kernel_stats.reset()
    config.backend = "device"
    config.device = device
    phase_chemistry(device)
    phase_flagship(device, sizes, config)
    phase_algebra(device, sizes, config, rng)
    launches = dict(cuda.launches)
    say("6 coverage", **{f"launches_{k}": v for k, v in launches.items()})
    print(kernel_stats.summary(), flush=True)
    return report, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from symmer_torch import config
    from symmer_torch.kernels import cuda

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    say("0 device", nvidia_smi=repr(smi), torch=repr(name),
        torch_version=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    lib = cuda.build()
    cuda._lib()
    say("1 build", seconds=f"{time.perf_counter() - t0:.2f}", library=os.path.relpath(lib, REPO))
    for line in cuda.build_log.splitlines():
        if "Used" in line or "Function properties" in line:
            print("  " + line.strip())

    report, launches = run(device, FULL, config)
    missing = [k for k, n in launches.items() if n == 0]
    assert not missing, f"kernels not launched on the main path: {missing}"

    sources = {
        "anticommutes": ("symmer_torch/csrc/anticommutes.cu",
                         "symmer_tpu/kernels/pallas_gf2.py:44"),
        "clifford_scan": ("symmer_torch/csrc/clifford_scan.cu",
                          "symmer_tpu/kernels/jx_core.py:591"),
    }
    kernels = [
        dict(name=k, route="cuda", source=sources[k][0], replaces=sources[k][1],
             launches=launches[k], max_abs_err=report[k]["max_abs_err"],
             ms=report[k]["ms"], plain_ms=report[k]["plain_ms"])
        for k in ("anticommutes", "clifford_scan")
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
