#!/usr/bin/env python3
"""Stage split of the resident taper on one CUDA card.

    python3 tools/taper_stages.py [--runs N] [--tree TREE]

Runs chip_smoke.py's flagship taper (the 1000-qubit x 200,000-term,
4-symmetry synthetic operator, resident on the card) N times after one
warm-up, with a timer around each stage that taper_it calls: the reference
state, the sector update, the stabilizer rotation, the resident projection
(DeviceOperator.clifford_rotate_project), the reference-state projection
(project_state), and, outside taper_it, the download (to_host).  Each timer
synchronises the card before it starts and before it stops, so a stage's
time includes the card work it enqueued; the timers' own syncs make the
walls a little longer than an untimed taper_it.  Prints one line per run and
the median of each stage, and which side (host or device) the state
projection's apply_state calls took.  TREE (default: this checkout) is the
checkout whose symmer_torch is imported, e.g. a `git archive` of an older
commit under build/.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--tree", default=REPO)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("taper_stages: no CUDA device")
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from symmer_torch import QuantumState, QubitTapering, config
    from symmer_torch.kernels import cuda
    from symmer_torch.operators import DeviceOperator, IndependentOp
    from symmer_torch.profiling import kernel_stats

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"[package] {os.path.dirname(sys.modules['symmer_torch'].__file__)}", flush=True)
    cuda._lib()
    device = torch.device("cuda", 0)
    config.device, config.backend = device, "device"
    nq, nt, ns, seed = smoke.FULL["flagship"]
    H = smoke.synthetic_taper_operator(nq, nt, ns, seed)
    qt = QubitTapering(H)
    H_dev = H.to_device()
    ref = np.zeros(nq, dtype=int)
    times: dict = {}
    depth = [0]

    @contextlib.contextmanager
    def stage(name):
        """Time the outermost timed call only (project_state builds states
        and rotations of its own)."""
        if depth[0]:
            yield
            return
        depth[0] += 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            torch.cuda.synchronize()
            times[name] = times.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            depth[0] -= 1

    def timed(cls, attr, name):
        fn = getattr(cls, attr)

        def wrapper(*a, **k):
            with stage(name):
                return fn(*a, **k)

        setattr(cls, attr, wrapper)

    timed(QuantumState, "__init__", "QuantumState(ref)")
    timed(IndependentOp, "update_sector", "update_sector")
    timed(IndependentOp, "rotate_onto_single_qubit_paulis", "rotate_onto_single_qubit_paulis")
    timed(DeviceOperator, "clifford_rotate_project", "clifford_rotate_project")
    timed(QubitTapering, "project_state", "project_state")
    qt.taper_it(ref_state=ref, aux_operator=H_dev)  # warm-up
    rows = []
    for run in range(args.runs):
        times.clear()
        kernel_stats.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = qt.taper_it(ref_state=ref, aux_operator=H_dev)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        with stage("to_host (not in taper_it)"):
            out.to_host()
        row = dict(times, taper_it_wall=wall)
        rows.append(row)
        sides = {k: (kernel_stats.device_calls.get(k, 0), kernel_stats.host_calls.get(k, 0))
                 for k in ("apply_state", "multiply", "cleanup")}
        print(f"[run {run}] " + " ".join(f"{k}={v:.3f}" for k, v in row.items())
              + f" device/host calls={sides}", flush=True)
    for k in rows[0]:
        print(f"[median] {k}={statistics.median(r[k] for r in rows):.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
