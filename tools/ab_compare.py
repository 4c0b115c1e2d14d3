#!/usr/bin/env python3
"""Compare checkouts of symmer_torch on one card, in turns, with chip_smoke.py's phases.

    python3 tools/ab_compare.py kernels TREE [TREE ...]
    python3 tools/ab_compare.py state TREE [TREE ...]
    python3 tools/ab_compare.py flagship --rounds N TREE [TREE ...]
    python3 tools/ab_compare.py eigen --rounds N TREE [TREE ...]
    python3 tools/ab_compare.py rref TREE [TREE ...]
    python3 tools/ab_compare.py cleanup TREE [TREE ...]
    python3 tools/ab_compare.py sort TREE [TREE ...]
    python3 tools/ab_compare.py merge TREE [TREE ...]
    python3 tools/ab_compare.py csvqe --rounds N TREE [TREE ...]
    python3 tools/ab_compare.py algebra --rounds N TREE [TREE ...]
    python3 tools/ab_compare.py mesh --rounds N TREE [TREE ...]

Each TREE is a checkout of the repository: `.`, or an older commit unpacked
with `git archive` into a gitignored directory such as `build/parent`.  Every
run is a process of its own that imports symmer_torch from its TREE
(building that tree's kernels into TREE/build/symmer_torch) and runs a phase
of this checkout's chip_smoke.py on it, so every tree is measured by the
same code:

  kernels   phase 2, once per TREE in the order given (list them as
            A B B A): each kernel against its plain version, its L2-cold
            and L2-warm times, its bound and its yardstick;
  state     the part of phase 2 that runs K10 and K12 (and
            is_noncontextual), at the phase-2 shapes and at the shapes the
            main path launches them at;
  flagship  phase 4, N rounds: the resident 1000-qubit x 200k-term taper
            against the host path, every TREE once a round, the order
            rotated by one from round to round; ends with one JSON line per
            TREE holding its best-of-3 walls and their median;
  eigen     phase 7's counted flows (the eigensolvers and
            QubitSubspaceManager(H2O)), N rounds rotated as for flagship;
            ends with one JSON line per TREE holding each flow's card walls
            and their median;
  rref      phase 9's K11 checks, once per TREE in the order given: gf2_rref
            at every K11 shape against its plain version and the host, its
            passes (where the tree's wrapper reports them) and launches a
            call, L2-cold and warm times;
  sort      chip_smoke.sort_times, once per TREE in the order given: the
            cleanup's sort (cuda.sort_keys, K17) at every phase-2 K17 shape,
            L2-cold and warm, bit for bit torch.sort, beside
            torch.sort(stable=True) on the same keys;
  cleanup   chip_smoke.cleanup_costs, once per TREE in the order given: a
            device cleanup_sorted of 200,000 x 16 words, mul_pairs_cleanup
            of phase 5's square and of the CS-VQE flows' largest product,
            rotate_nonclifford_cleanup and clifford_project_cleanup, each
            call's torch ops, kernel launches, host synchronisations, peak
            allocated memory and wall;
  merge     chip_smoke.pass_a_times, once per TREE in the order given: the
            cleanup merge's (K3's) pass A alone, L2-cold and warm, after
            the tree's own sort (K17's sorted keys, or _lexsort's
            permutation in a tree without K17), at each K3 shape of phase 2
            beside its longest group;
  csvqe     phase 6 without its pinned 3-qubit flows, N rounds rotated as
            for flagship: the N2 and MgH2 flows to 8 qubits (device best of
            3 against the host path, products a flow and their launches and
            host synchronisations a call), the flow without a reference
            state and the tapered expectation values; ends with one JSON
            line per TREE holding each flow's device walls and their median;
  algebra   phase 5, N rounds rotated as for flagship: the square, the
            100,000-term non-Clifford rotation and the DeviceOperator chain
            against the host path, each with its peak allocated memory;
            ends with one JSON line per TREE holding each operation's
            device walls and their median;
  mesh      chip_smoke.mesh_cleanup_walls, N rounds rotated as for
            flagship: phase 10's cleanup of 200,000 rows on one device and
            on four shards of the card, best of 3 each; ends with one JSON
            line per TREE holding both walls and their medians.

Each run's phase lines follow a `== TREE` line; the card's name and power
limit come first.  Needs one CUDA card; any failed run stops the comparison.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_phase(phase: str, tree: str) -> None:
    """In the child: `phase` of REPO's chip_smoke.py on TREE's symmer_torch."""
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ab_compare: no CUDA device")
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import symmer_torch
    from symmer_torch import config
    from symmer_torch.kernels import cuda

    print(f"[package] {os.path.dirname(symmer_torch.__file__)}", flush=True)
    device = torch.device("cuda", 0)
    cuda._lib()  # build first: the build is not part of any timing
    rng = np.random.default_rng(0)
    config.device = device
    if phase == "kernels":
        smoke.phase_kernels(device, smoke.FULL, rng)
    if phase in ("kernels", "state"):
        smoke.phase_state_kernels(device, smoke.FULL, rng)
    elif phase == "eigen":
        config.backend = "device"
        smoke.phase_eigensolvers(device, smoke.FULL, config)
    elif phase == "rref":
        smoke.phase_rref_kernels(device, smoke.FULL)
    elif phase == "cleanup":
        smoke.cleanup_costs(device, smoke.FULL)
    elif phase == "sort":
        smoke.sort_times(device, smoke.FULL)
    elif phase == "merge":
        smoke.pass_a_times(device, smoke.FULL)
    elif phase == "csvqe":
        config.backend = "device"
        smoke.phase_csvqe(device, dict(smoke.FULL, cs_pinned=[]), config)
    elif phase == "algebra":
        config.backend = "device"
        smoke.phase_algebra(device, smoke.FULL, config, rng)
    elif phase == "mesh":
        config.backend = "device"
        smoke.mesh_cleanup_walls(device, smoke.FULL)
    else:
        config.backend = "device"
        smoke.phase_flagship(device, smoke.FULL, config)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("phase", choices=("kernels", "state", "flagship", "eigen", "rref", "cleanup",
                                      "sort", "merge", "csvqe", "algebra", "mesh"))
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--rounds", type=int, default=1,
                    help="flagship, eigen, csvqe, algebra, mesh: rounds over the trees")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        run_phase(args.phase, args.trees[0])
        return 0

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    walls = {tree: [] for tree in args.trees}
    flows = {tree: {} for tree in args.trees}
    rotate = args.phase in ("flagship", "eigen", "csvqe", "algebra", "mesh")
    rounds = args.rounds if rotate else 1
    for rnd in range(rounds):
        order = args.trees
        if rotate:
            shift = rnd % len(order)
            order = order[shift:] + order[:shift]
        for tree in order:
            res = subprocess.run([sys.executable, os.path.abspath(__file__), args.phase, tree,
                                  "--child"], capture_output=True, text=True, timeout=900)
            print(f"== {tree} rc={res.returncode}", flush=True)
            print("\n".join(l for l in res.stdout.splitlines() if l.startswith("[")), flush=True)
            if res.returncode != 0:
                print(res.stderr[-4000:], file=sys.stderr)
                return 1
            m = re.search(r"resident_best_ms=([0-9.]+)", res.stdout)
            if m:
                walls[tree].append(float(m.group(1)))
            for line in res.stdout.splitlines():
                wall = re.search(r" (?:device_best_ms|wall_ms|card_wall_ms)=([0-9.]+)", line)
                if (line.startswith("[7") and "flow=" in line
                        or line.startswith(("[6", "[5")) and "device_best_ms=" in line
                        or line.startswith("[5") and "wall_ms=" in line) and wall:
                    key = " ".join(re.findall(r"(?:flow|method|system|op)=\S+", line))
                    flows[tree].setdefault(key, []).append(float(wall.group(1)))
                if line.startswith("[10") and "mesh_best_ms=" in line:
                    op = re.search(r"op=\S+", line).group(0)
                    for route in ("one_device", "mesh"):
                        t = float(re.search(rf" {route}_best_ms=([0-9.]+)", line).group(1))
                        flows[tree].setdefault(f"{op} {route}", []).append(t)
    if args.phase == "flagship":
        for tree, w in walls.items():
            print(json.dumps({"tree": tree, "resident_best_ms": w,
                              "median_ms": statistics.median(w)}))
    if args.phase in ("eigen", "csvqe", "algebra", "mesh"):
        for tree, by_flow in flows.items():
            print(json.dumps({"tree": tree, "card_wall_ms": by_flow, "median_ms": {
                k: statistics.median(w) for k, w in by_flow.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
