#!/usr/bin/env python3
"""Rate of the binary and the int8 mma.sync tensor-core products on one card.

    python3 tools/mma_rate.py    # from the repository root; needs one card and nvcc

NVIDIA's data sheet gives no rate for the binary product (m16n8k256 .b1
and.popc) that symmer_torch/csrc/anticommutes.cu runs in its square regime.
This builds tools/mma_rate.cu with nvcc into build/tools/, launches its
register-only probe (two blocks of 8 warps per SM, each warp 4096 rounds of
8 independent products), times each launch with CUDA events and prints,
beside the card's name and power limit, the median rate of 5 launches in
element ops/s (2 per multiply-add of one element) for the .b1 and the .s8
(m16n8k32) product.  chip_smoke.py's bound for the binary product
(B1_MMA_OPS_PER_S) is this measurement.
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(os.path.dirname(HERE), "build", "tools")
ITERS, CHAINS, REPS = 4096, 8, 5


def build() -> ctypes.CDLL:
    os.makedirs(BUILD, exist_ok=True)
    lib = os.path.join(BUILD, "libmma_rate.so")
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", lib, os.path.join(HERE, "mma_rate.cu")],
                   check=True)
    cdll = ctypes.CDLL(lib)
    cdll.mma_rate_launch.argtypes = [ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_void_p, ctypes.c_void_p]
    cdll.mma_rate_launch.restype = ctypes.c_int
    return cdll


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mma_rate: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    lib = build()
    dev = torch.device("cuda", 0)
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    blocks = 2 * torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    rates = {}
    for name, binary, k in (("b1_m16n8k256", 1, 256), ("s8_m16n8k32", 0, 32)):
        launch = lambda: lib.mma_rate_launch(binary, ITERS, blocks, sink.data_ptr(), stream)
        assert launch() == 0, f"{name}: launch failed"
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            assert launch() == 0, f"{name}: launch failed"
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1) * 1e-3)
        ops = blocks * 8 * ITERS * CHAINS * 2 * 16 * 8 * k  # warps x products x 2 m n k
        rates[name] = ops / float(np.median(times))
    print(smi)
    print(json.dumps({**{f"{k}_ops_per_s": v for k, v in rates.items()},
                      "b1_over_s8": rates["b1_m16n8k256"] / rates["s8_m16n8k32"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
