#!/usr/bin/env python3
"""Where K11's blocked kernel spends its time, by block 0's clock, on one card.

    python3 tools/k11_split.py

Builds csrc/gf2_rref.cu alone with -DSYMMER_GF2_RREF_SPLIT into
build/k11_split/ (block 0 reads %globaltimer around each step of every
pass and adds the spans to the scratch buffer's control words; see the
source's header).  Then, at each K11 shape of chip_smoke.py's phase 9
(FULL["evo_rref"]), it runs that build four times (checked bit for bit
against the plain version) and prints, for the fastest run, the total (CUDA
events) and block 0's split in microseconds: the live flags and first grid
barrier (init), the panels, the wait at the barrier after each panel
(sync1), block 0's share of the updates, its wait at the barrier after
them (sync2), and inside the panels the chunks' scan, load and reduction
(prep), the walk, and the pivots' building with the earlier pivots'
reduction (build).  The clock reads add a few microseconds a pass; the
uninstrumented times are chip_smoke.py's.  Needs one CUDA card.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_split(cuda) -> ctypes.CDLL:
    """gf2_rref.cu with the clock split, as its own library."""
    out = os.path.join(REPO, "build", "k11_split")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libgf2_rref_split.so")
    cmd = [cuda._nvcc(), *cuda.COMPILE_FLAGS, "-DSYMMER_GF2_RREF_SPLIT", "-shared", "-o", so,
           os.path.join(cuda.CSRC, "gf2_rref.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"k11_split: nvcc failed:\n{res.stderr}")
    lib = ctypes.CDLL(so)
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.symmer_gf2_rref_scratch.argtypes = [i64, i64]
    lib.symmer_gf2_rref_scratch.restype = i64
    lib.symmer_gf2_rref.argtypes = [p, i64, i64, p, p]
    lib.symmer_gf2_rref.restype = ctypes.c_int
    return lib


def main() -> int:
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k11_split: no CUDA device")
    import chip_smoke as smoke
    from symmer_torch.kernels import cuda, torch_gf2

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    lib = build_split(cuda)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    us = lambda ns: f"{ns / 1e3:.1f}"
    for entry in smoke.FULL["evo_rref"]:
        label, M = smoke.rref_stack(entry, smoke.FULL)
        R, W = M.shape
        M0 = torch.tensor(M.view(np.int64), device=dev)
        want = torch_gf2.rref(M0.clone())
        scratch = torch.empty((lib.symmer_gf2_rref_scratch(R, W) + 7) // 8, dtype=torch.int64,
                              device=dev)
        best = None
        for _ in range(4):
            x = M0.clone()
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            err = lib.symmer_gf2_rref(x.data_ptr(), R, W, scratch.data_ptr(), stream)
            e1.record()
            torch.cuda.synchronize()
            if err:
                raise SystemExit(f"k11_split: launch failed at {label}: cudaError {err}")
            assert torch.equal(x, want), f"k11_split: wrong result at {label}"
            ms = e0.elapsed_time(e1)
            if best is None or ms < best[0]:
                best = (ms, scratch[:16].cpu().numpy())
        ms, c = best
        print(f"[k11 split] shape={label} total_ms={ms:.3f} passes={c[2]} init_us={us(c[3])} "
              f"panel_us={us(c[4])} sync1_us={us(c[5])} update_us={us(c[6])} sync2_us={us(c[7])} "
              f"chunks={c[10]} prep_us={us(c[8])} walk_us={us(c[9])} build_us={us(c[11])}",
              flush=True)
        del M0, want, scratch
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
