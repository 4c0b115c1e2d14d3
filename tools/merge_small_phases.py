#!/usr/bin/env python3
"""Card cycles of each step of K3's one-block route (csrc/merge_small.cu).

    python3 tools/merge_small_phases.py [--reps N]

Writes a copy of merge_small.cu with a clock64() stamp by thread 0 of block 0
before each step (build/merge_small_phases/, gitignored), builds it with nvcc
into a library of its own, and calls it at chip_smoke.py's small_shapes (the
CS-VQE flows' products, LiH's projection, tapered N2's cleanup, 4,096 x 16
words, one group of 4,096 slots, 4,096 cancelling slots, a 1,000-term
rotation) and, for the fused route (symmer_sign_merge_small), at its
fused_shapes, L2 warm: the median over N calls of each step's cycles (load:
the keys' loads, or the fused route's signing with the cluster's barriers;
group: the hash table, order: the scan or the sort, ends, sums, scan,
write, rows: the cluster's row copies and its barriers).  A stamp is thread
0's clock: a step that waits at a barrier for slower warps shows that wait.
The kernel the port builds is not changed.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "merge_small_phases")
# (text in merge_small.cu, the step that starts there)
STEPS = [("  if constexpr (kStep0 != kLoad) {\n", "load"), ("    // 1. each live slot", "group"),
         ("    if (!repeats) {", "order"), ("    // 4. each group's end", "ends"),
         ("    // 5. each group's sum", "sums"), ("    // 6. the survivors' places", "scan"),
         ("    // 7. each survivor's sums", "write"),
         ("  // block 0's survivors are in its shared memory", "rows")]
END = "  if (!one) cluster.sync();  // block 0's shared memory outlives the other blocks' reads\n"


def stamped_source() -> str:
    src = open(os.path.join(REPO, "symmer_torch", "csrc", "merge_small.cu")).read()
    stamp = "if (threadIdx.x == 0 && blockIdx.x == 0) g_stamp[{}] = clock64();\n"
    for k, (text, _) in enumerate(STEPS):
        assert src.count(text) == 1, text
        src = src.replace(text, stamp.format(k) + text)
    assert src.count(END) == 1
    src = src.replace(END, END + stamp.format(len(STEPS)))
    src = src.replace("namespace cg = cooperative_groups;\n",
                      "namespace cg = cooperative_groups;\n__device__ long long g_stamp[16];\n", 1)
    return src + ('extern "C" int merge_small_stamps(void* host) {\n'
                  '  return (int)cudaMemcpyFromSymbol(host, g_stamp, sizeof(long long) * 16);\n}\n')


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("merge_small_phases: no CUDA device")
    import chip_smoke as smoke
    from symmer_torch.kernels import cuda

    os.makedirs(OUT, exist_ok=True)
    src, lib_path = os.path.join(OUT, "merge_small_stamped.cu"), os.path.join(OUT, "stamped.so")
    with open(src, "w") as f:
        f.write(stamped_source())
    subprocess.run([cuda._nvcc(), *cuda.COMPILE_FLAGS, "-shared", "-I", cuda.CSRC, "-o",
                    lib_path, src],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    lib.symmer_merge_small.argtypes = cuda._lib().symmer_merge_small.argtypes
    lib.symmer_sign_merge_small.argtypes = cuda._lib().symmer_sign_merge_small.argtypes
    device = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    calls = [(label, smoke.merge_small_call(*args, device, lib=lib))
             for label, args, _ in smoke.small_inputs(device, smoke.FULL)]
    calls += [(f"fused_{label}", smoke.fused_call(kind, ops, th, device, lib))
              for label, kind, ops, th, _ in smoke.fused_inputs(device, smoke.FULL)]
    for label, call in calls:
        runs = []
        for _ in range(args.reps + 1):
            call()
            torch.cuda.synchronize()
            h = (ctypes.c_longlong * 16)()
            assert lib.merge_small_stamps(h) == 0
            runs.append(np.diff(np.array(h[:len(STEPS) + 1])))
        steps = np.median(np.array(runs[1:]), axis=0)
        print(f"{label} total_cycles={steps.sum():.0f} " + " ".join(
            f"{name}={c:.0f}" for (_, name), c in zip(STEPS, steps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
