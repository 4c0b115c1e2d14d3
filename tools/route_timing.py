#!/usr/bin/env python3
"""Where K16's (route_rows') time goes: its launch timed several ways.

    python3 tools/route_timing.py [--tree TREE ...] [--reps 20]

At the flagship's shard shape (the first quarter of the 1000-qubit x
200,000-term operator's rows, keyed by their signatures, bit 0 of the key,
as round 0 of shard 0 routes them; chip_smoke.py's phase_mesh_kernels), for
each TREE (default: this checkout; an older commit unpacked with `git
archive` into a gitignored directory, e.g. build/parent, runs its own
symmer_torch in a process of its own), the median card time of one call:

  cold        the wrapper, after a 128 MB buffer is written and another read
              (chip_smoke.py's launch_times: the L2 holds neither the inputs
              nor dirty lines);
  warm        the wrapper, nothing between the calls (the inputs and the
              last call's outputs, dirty, stay in the L2);
  warm_clean  the wrapper, after the flush and then one read of each input:
              the inputs in the L2, the last call's outputs written back;
  raw_cold, raw_warm
              the kernel's C entry point alone, with its outputs and scratch
              made once: no wrapper, no torch.zeros(2) fill of the counts;
  warm_1ms    the wrapper, warm, behind a 1 ms sleep instead of 0.1 ms: the
              host has ten times as long to enqueue the call;
  fill        a torch.zeros(2) alone (the parent's wrapper fills its counts
              so before the launch);
  host_us     the wrapper's host time a call (perf_counter over 200 calls,
              nothing synchronised between them).

Each timed call sits behind a sleep kernel (chip_smoke.SLEEP_CYCLES, ~0.1 ms
at 1.98 GHz unless noted) so that the events time the card's work, not the
host's; a call whose host time outlasts the sleep ahead of it shows the
excess as card time.  Every tree's outputs are checked bit for bit against
its plain version first.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.lru_cache(maxsize=None)
def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def timed(fn, dev, reps, before=None, sleep=None):
    """Median card ms of fn() between an event pair, each behind `before()`
    and a sleep kernel of `sleep` cycles."""
    import numpy as np
    import torch

    smoke = load_smoke()
    sleep = smoke.SLEEP_CYCLES if sleep is None else sleep
    fn()
    torch.cuda.synchronize(dev)
    events = []
    for _ in range(reps):
        if before is not None:
            before()
        torch.cuda._sleep(sleep)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize(dev)
    return float(np.median([a.elapsed_time(b) for a, b in events]))


def run_tree(tree: str, reps: int) -> dict:
    """In the child: time TREE's route_rows; returns the times."""
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from symmer_torch.kernels import cuda, torch_core

    smoke = load_smoke()
    dev = torch.device("cuda", 0)
    H = smoke.synthetic_taper_operator(*smoke.FULL["flagship"])
    n = -(-H.n_terms // smoke.FULL["mesh_shards"])
    to = lambda v: torch.tensor(np.ascontiguousarray(v).view(np.int64), device=dev)
    f = lambda v: torch.tensor(np.ascontiguousarray(v, dtype=np.float64), device=dev)
    x, z = to(H.x_pack[:n]), to(H.z_pack[:n])
    cr, ci = f(H.coeff_vec[:n].real), f(H.coeff_vec[:n].imag)
    key, _ = torch_core.row_signature(x, z)
    W = x.shape[1]
    bufs = lambda: [tuple(torch.empty_like(t) for t in (x, z, cr, ci)) for _ in range(2)]
    got, plain = bufs(), bufs()
    counts = cuda.route_rows(x, z, cr, ci, key, 0, 0, *got)
    want = torch_core.route_rows(x, z, cr, ci, key, 0, 0, *plain)
    torch.cuda.synchronize(dev)
    assert counts.tolist() == want.tolist(), (counts.tolist(), want.tolist())
    for side, m in zip(range(2), counts.tolist()):
        for a, b in zip(got[side], plain[side]):
            assert smoke.same_bits(a[:m], b[:m]), f"{tree}: route_rows differs from plain"
    before = cuda.launches["route_rows"]
    cuda.route_rows(x, z, cr, ci, key, 0, 0, *got)
    per_call = cuda.launches["route_rows"] - before

    # the C entry point alone: outputs and scratch made once
    lib, stream = cuda._lib(), cuda._stream(dev)
    out_counts = torch.empty(2, dtype=torch.int64, device=dev)
    ptrs = [t.data_ptr() for t in (x, z, cr, ci, key)]
    outs = [t.data_ptr() for side in got for t in side]
    # one launch, a look-back scratch per stream (named _route_status in
    # older trees)
    status = getattr(cuda, "_look_back_status", None) or getattr(cuda, "_route_status", None)
    if status is not None:
        tiles = lib.symmer_route_rows_tiles(n)

        def raw():
            scratch, epoch = status(dev, stream, tiles)
            lib.symmer_route_rows(*ptrs, n, W, 0, 0, epoch, scratch.data_ptr(), *outs,
                                  out_counts.data_ptr(), stream)
    else:  # the parent: a count launch and a scatter launch over block_keep
        tile = lib.symmer_route_rows_tile(n)
        block_keep = torch.empty(-(-n // tile), dtype=torch.int64, device=dev)

        def raw():
            lib.symmer_route_rows(*ptrs, n, W, 0, 0, tile, block_keep.data_ptr(), *outs,
                                  out_counts.data_ptr(), stream)
    raw()
    torch.cuda.synchronize(dev)
    assert out_counts.tolist() == want.tolist()

    flush = torch.empty(smoke.FLUSH_BYTES, dtype=torch.uint8, device=dev)
    clean = torch.ones(smoke.FLUSH_BYTES // 8, dtype=torch.int64, device=dev)

    def cold():
        flush.zero_()
        clean.max()

    def warm_clean():
        cold()
        for t in (x, z, cr, ci, key):
            t.max()

    call = lambda: cuda.route_rows(x, z, cr, ci, key, 0, 0, *got)
    res = dict(tree=tree, rows=n, words=W, kept=counts.tolist()[0], sent=counts.tolist()[1],
               launches_per_call=per_call)
    res["cold"] = timed(call, dev, reps, before=cold)
    res["warm"] = timed(call, dev, reps)
    res["warm_clean"] = timed(call, dev, reps, before=warm_clean)
    res["raw_cold"] = timed(raw, dev, reps, before=cold)
    res["raw_warm"] = timed(raw, dev, reps)
    res["warm_1ms"] = timed(call, dev, reps, sleep=10 * smoke.SLEEP_CYCLES)
    res["fill"] = timed(lambda: torch.zeros(2, dtype=torch.int64, device=dev), dev, reps)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(200):
        call()
    res["host_us"] = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize(dev)
    res["bound_ms"] = smoke.route_bound(n, W)[0]
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", nargs="+", default=[REPO])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(run_tree(args.child, args.reps)), flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for tree in args.tree:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree,
                              "--reps", str(args.reps)], capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        line = json.loads(res.stdout.strip().splitlines()[-1])
        print(" ".join(f"{k}={v:.5f}" if isinstance(v, float) else f"{k}={v}"
                       for k, v in line.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
