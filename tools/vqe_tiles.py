#!/usr/bin/env python3
"""The VQE engine's forward and adjoint sweep at each tile width d_max.

    python3 tools/vqe_tiles.py [--bits 8 9 10 11 12] [--reps 20]

For tapered MgH2 (17 q, its 1,316 tapered UCCSD generators; the VQE
flow's shape in chip_smoke.py phase 9) and tapered N2 (15 q, 696), cuts
the generators into runs over coset tiles of 2^d rows
(torch_vqe.plan_runs) for each d and prints the runs and stretches, then
the card time of the fused forward (cuda.vqe_runs) and of the adjoint
sweep (cuda.vqe_adjoint): the median of --reps calls with the L2 cold
(chip_smoke.cold_warm) and warm.  The forward is checked bit for bit
against the first width's (each width applies the same rotations to each
row in the same order).  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bits", type=int, nargs="+", default=[8, 9, 10, 11, 12])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("vqe_tiles: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from symmer_torch import config
    from symmer_torch.evolution import device_vqe
    from symmer_torch.kernels import cuda, torch_vqe

    device = torch.device("cuda", 0)
    config.device = device
    print(chip_smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    bits = lambda t: torch.view_as_real(t).view(torch.int64)
    rng = np.random.default_rng(5)
    for name in ("MgH2_STO-3G_SINGLET_JW.json", "N2_STO-3G_SINGLET_JW.json"):
        H, cc, _, _ = chip_smoke.tapered_with_uccsd(name)
        gx, gz, gph = device_vqe.term_arrays(cc)
        keep = (gx != 0) | (gz != 0)
        gx, gz, gph = gx[keep], gz[keep], gph[keep]
        n, P = H.n_qubits, gx.shape[0]
        t = 0.05 * rng.normal(size=P)
        cs = torch.tensor(np.stack([np.cos(t), np.sin(t)], 1), device=device)
        v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
        psi0 = torch.tensor(v / np.linalg.norm(v), device=device)
        lam0 = torch.tensor(rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n), device=device)
        out = torch.empty_like(psi0)
        psi, lam = psi0.clone(), lam0.clone()
        first = None
        for d in args.bits:
            plan = torch_vqe.plan_runs(gx, gz, gph, n, tile_bits=d)
            dplan = plan.on(device)
            fwd = cuda.vqe_runs(psi0, dplan, cs)
            first = fwd if first is None else first
            assert torch.equal(bits(fwd), bits(first)), f"the forward at d = {d} differs"
            f_cold, f_warm, f_range = chip_smoke.cold_warm(
                lambda: cuda.vqe_runs(psi0, dplan, cs, out=out), device, args.reps)
            # in place on scratch copies: unitary, so the values stay bounded
            s_cold, s_warm, s_range = chip_smoke.cold_warm(
                lambda: cuda.vqe_adjoint(psi, lam, dplan, cs), device, args.reps)
            chip_smoke.say("vqe_tiles", system=f"tapered_{name.split('_')[0]}_{n}q_{P}gens",
                           d_max=d, runs=plan.n_runs, stretches=plan.stretch_mask.size,
                           forward_ms_l2_cold=f"{f_cold:.5f}", forward_cold_range=f_range,
                           forward_ms_l2_warm=f"{f_warm:.5f}",
                           sweep_ms_l2_cold=f"{s_cold:.5f}", sweep_cold_range=s_range,
                           sweep_ms_l2_warm=f"{s_warm:.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
