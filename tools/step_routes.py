#!/usr/bin/env python3
"""Time the Lanczos step (csrc/lanczos_step.cu) on each route and cluster size.

    python3 tools/step_routes.py [--sizes 8 12 14 15 16 17 18] [--reps 20]
    python3 tools/step_routes.py --tree build/parent [--sizes 14 15 17]

For each 2^n rows: pass 1's step on the grid route (one cooperative launch)
and on the cluster route with each cluster size that holds the rows (1 .. 16
blocks), every launch bit for bit the plain version first (all but hv, the
step's scratch); then the median card time of 20 launches with the L2 cold
and warm (chip_smoke.py's launch_times), beside the bytes bound.  The route
that lanczos_step_route picks is marked.  How the size rule of
kernels/cuda.py was chosen.

--tree times the step of another checkout's symmer_torch (an older commit
unpacked with `git archive` into a gitignored directory) the way its
drivers call it, to compare the two on one card: run it in turns with this
checkout (A B B A).  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import importlib.util
import inspect
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[8, 12, 14, 15, 16, 17, 18])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--tree", default=REPO, help="the checkout whose symmer_torch is timed")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("step_routes: no CUDA device")
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from symmer_torch.kernels import cuda, torch_lanczos

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    print(f"package: {os.path.dirname(os.path.dirname(cuda.__file__))}", flush=True)
    dev = torch.device("cuda", 0)
    # an older tree's step takes no v_next (one cooperative launch, v_next over v_prev)
    routed = "v_next" in inspect.signature(cuda.lanczos_step).parameters
    blocks, rows = cuda.step_cluster() if routed else (0, 0)
    if routed:
        print(f"cluster: {blocks} blocks, up to {rows} rows", flush=True)

    def step(fn, ops, **kw):
        hv, v_prev, v_cur, alphas, betas = ops
        if routed:
            fn(hv, v_prev, v_cur, v_prev, alphas, betas, 3, **kw)
        else:
            fn(hv, v_prev, v_cur, alphas, betas, 3)

    rng = np.random.default_rng(0)
    bits = lambda t: torch.view_as_real(t).view(torch.int64) if t.is_complex() else t.view(torch.int64)
    for n in args.sizes:
        dim = 1 << n
        vec = lambda: torch.tensor(rng.normal(size=dim) + 1j * rng.normal(size=dim), device=dev)
        ops = (vec(), vec(), vec(), torch.zeros(8, dtype=torch.float64, device=dev),
               torch.tensor(rng.random(8) + 0.5, device=dev))
        plain = tuple(t.clone() for t in ops)
        step(torch_lanczos.lanczos_step, plain)
        cases = [("grid", 0)] + [("cluster", b) for b in (1, 2, 4, 8, 16)
                                 if b <= blocks and dim <= b * (rows // blocks)]
        bound = smoke.step_bound(dim)[0]
        for route, b in cases if routed else [("cooperative", 0)]:
            kw = dict(route=route, blocks=b) if routed else {}
            got = tuple(t.clone() for t in ops)
            step(cuda.lanczos_step, got, **kw)
            torch.cuda.synchronize()
            assert all(torch.equal(bits(x), bits(y)) for x, y in zip(got[1:], plain[1:])), (
                n, route, b)  # all but hv, the step's scratch
            work = tuple(t.clone() for t in ops)
            cold, warm, spread = smoke.cold_warm(lambda: step(cuda.lanczos_step, work, **kw),
                                                 dev, args.reps)
            picked = not routed or (route == cuda.lanczos_step_route(dim) and b in (0, blocks))
            smoke.say("step", rows=f"2^{n}", route=route, blocks=b or "-", picked=picked,
                      ms_l2_cold=f"{cold:.5f}", ms_l2_cold_range=spread, ms_l2_warm=f"{warm:.5f}",
                      bound_ms=f"{bound:.5f}", share_cold=f"{bound / cold:.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
