#!/usr/bin/env python3
"""Time the fused route of K3's one-block route against the two launches it
replaces, across sizes: how cuda.FUSED_WORDS (merge_small.cu's kFusedWords)
and kSignRounds were chosen.

    python3 tools/fused_budget.py [--reps N] [--widths 1 2 4 8 16]

For a cleanup of T stored rows and a product of T x 1 pairs (the CS-VQE
flows' shape), of W words, T from 1 to 4,096 (T W from 1 to 65,536): each
shape's outputs first bit for bit alike on both routes (the wrappers
cuda.cleanup_small / product_small against row_signature / pair_products,
then merge_small), then, as bare C calls (chip_smoke.fused_call,
two_launch_call), the L2-cold median of N calls (and the warm one) of the
fused route as the package builds it (the cluster signs where block 0's
lane groups would take more than kSignRounds rounds), the same with one
block signing at every size and with the cluster signing at every size
(copies of merge_small.cu with kSignRounds rewritten, built with nvcc
into build/fused_budget/, gitignored), and of the two launches (K2 or K4,
then merge_small) with each launch alone.  Prints one line a shape, then for
each source and width the largest T W at which the fused route as built is
still faster than the two launches.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "fused_budget")
SLOTS = [1, 4, 16, 32, 64, 67, 256, 512, 768, 1024, 2048, 2229, 4096]
# kSignRounds of the variants: one block signs at every size, the cluster at every size
VARIANTS = {"one_block": 1 << 30, "cluster": 0}


def variant_libs():
    """{name: ctypes library} of merge_small.cu built alone with each
    VARIANTS kSignRounds (one nvcc each, both started together)."""
    from symmer_torch.kernels import cuda

    os.makedirs(OUT, exist_ok=True)
    src = open(os.path.join(cuda.CSRC, "merge_small.cu")).read()
    jobs = {}
    for name, rounds in VARIANTS.items():
        text, n = re.subn(r"constexpr int kSignRounds = \d+;",
                          f"constexpr int kSignRounds = {rounds};", src)
        assert n == 1, "merge_small.cu defines no kSignRounds"
        path = os.path.join(OUT, f"merge_small_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(OUT, f"merge_small_{name}.so")
        jobs[name] = (lib, subprocess.Popen(
            [cuda._nvcc(), *cuda.COMPILE_FLAGS, "-shared", "-I", cuda.CSRC, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        _, err = proc.communicate()
        assert proc.returncode == 0, err
        libs[name] = ctypes.CDLL(lib)
        libs[name].symmer_sign_merge_small.argtypes = \
            cuda._lib().symmer_sign_merge_small.argtypes
    return libs


def operands(kind, T, W, device, rng):
    """A cleanup's (x, z, cr, ci) of T distinct rows, or a T x 1 product's
    operands (T distinct rows times one): the main path's small calls (the
    CS-VQE flows' products, tapered N2's cleanup) have no repeated row, so
    K3 takes its scan and its part of the time is least."""
    import numpy as np
    import torch

    to = lambda a: torch.tensor(a, device=device)
    rows = rng.integers(-2**62, 2**62, (T, 2, W))
    c = rng.normal(size=(2, T))
    x, z, cr, ci = (to(np.ascontiguousarray(a)) for a in (rows[:, 0], rows[:, 1], c[0], c[1]))
    if kind == "cleanup":
        return x, z, cr, ci
    other = rng.integers(-2**62, 2**62, (2, 1, W))
    c2 = rng.normal(size=(2, 1))
    return x, z, cr, ci, to(other[0]), to(other[1]), to(c2[0]), to(c2[1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--widths", type=int, nargs="+", default=[1, 2, 4, 8, 16])
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("fused_budget: no CUDA device")
    import chip_smoke as smoke
    from symmer_torch.kernels import cuda

    device = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    cuda.build()
    lines = cuda.build_log.splitlines()
    for k, line in enumerate(lines):  # merge_small.cu's kernels: registers and spills
        if "Function properties for" in line and "merge_small_kernel" in line:
            print("  " + line.split("merge_small_kernel")[1][:8], *(x.strip() for x in
                  lines[k + 1:k + 3]))
    libs = variant_libs()
    rng = np.random.default_rng(0)
    faster = {}
    for kind in ("cleanup", "product"):
        for W in args.widths:
            for T in SLOTS:
                ops = operands(kind, T, W, device, rng)
                th = 1e-15
                if kind == "cleanup":
                    got = cuda.cleanup_small(*ops, th)
                    ref = cuda.merge_small(*cuda.row_signature(ops[0], ops[1]), ops[2], ops[3],
                                           th, ops[:2])
                else:
                    got = cuda.product_small(*ops, th)
                    ref = cuda.merge_small(*cuda.pair_products(*ops), th,
                                           (ops[0], ops[1], ops[4], ops[5]))
                torch.cuda.synchronize()
                assert all(smoke.same_bits(g, r) for g, r in zip(got, ref)), \
                    f"the fused route differs from the two launches: {kind} {T} x {W}"
                fused = smoke.fused_call(kind, ops, th, device)
                both, key_call, merge = smoke.two_launch_call(kind, ops, th, device)
                times = {"fused": fused, "two_launches": both, "key_kernel": key_call,
                         "merge_small": merge}
                times.update({name: smoke.fused_call(kind, ops, th, device, lib)
                              for name, lib in libs.items()})
                ms = {name: smoke.launch_ms(fn, device, cold=True, reps=args.reps)
                      for name, fn in times.items()}
                for name in ("fused", "two_launches", "one_block", "cluster"):
                    ms[f"{name}_warm"] = smoke.launch_ms(times[name], device, cold=False,
                                                         reps=args.reps)
                if ms["fused"] < ms["two_launches"]:
                    faster[(kind, W)] = max(faster.get((kind, W), 0), T * W)
                smoke.say("budget", source=kind, W=W, T=T, words=T * W, survivors=got[0].shape[0],
                          cluster_signs=smoke.sign_blocks(T, W) > 1,
                          **{f"{k}_ms": f"{v:.5f}" for k, v in ms.items()},
                          fused_over_two=f"{ms['fused'] / ms['two_launches']:.3f}")
                del ops, got, ref
    for (kind, W), words in sorted(faster.items()):
        smoke.say("budget", source=kind, W=W, fused_faster_up_to_words=words)
    return 0


if __name__ == "__main__":
    sys.exit(main())
