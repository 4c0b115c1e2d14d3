#!/usr/bin/env python3
"""Card time per launched kernel of the K10 (expval), K12 (brute-force
search) and K17 (sort_keys) wrappers, and K12's time at every split width.

    python3 tools/kernel_profile.py [--reps N] [--keys T ...]

Runs each wrapper at chip_smoke.py's phase-2 shapes (the main path's
included) under torch.profiler and prints, per shape, the device
microseconds per call of each kernel the wrapper launched (torch's sort
included).  K17 runs on random int64 keys (seed T) at each --keys count,
with torch.sort(stable=True) on the same keys beside it; for both, the
call's span on the card (CUDA events, L2 warm, median of N) less the
kernels' sum is the card's idle time between the launches.  Then K12's C
entry is called with its split width forced to each of the six widths up
to min(n_free, 11) at the 2^24 and 2^28 shapes, timed with CUDA events
(median of N launches, L2 warm).  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def profile(label, fn, reps):
    import chip_smoke as smoke

    rows = smoke.kernel_device_us(fn, reps)
    busy = sum(r[0] for r in rows)
    print(f"== {label}: {busy:.1f} us of card time per call", flush=True)
    for t, n, key in rows[:8]:
        print(f"   {t:10.1f} us  x{n}  {key}", flush=True)
    return busy


def split_sweep(smoke, cuda, torch_noncon, device, entry, reps):
    """K12's C entry at the six split widths up to min(n_free, 11)."""
    import numpy as np
    import torch

    g, b, off, nc, n_free, shape, _ = smoke.brute_inputs(device, entry)
    M, n_segs = g.shape[0], nc + 1
    lib = cuda._lib()
    times = []
    for n_lo in range(max(1, min(n_free, torch_noncon.MAX_SPLIT) - 5),
                      min(n_free, torch_noncon.MAX_SPLIT) + 1):
        iscr = torch.empty(M + 2 * ((n_segs << n_lo) + 1) + 1, dtype=torch.int32, device=device)
        fscr = torch.empty(M + cuda.MAX_BLOCKS + 1, dtype=torch.float64, device=device)
        kscr = torch.empty(cuda.MAX_BLOCKS + 1, dtype=torch.int64, device=device)

        def launch():
            err = lib.symmer_noncon_brute(
                g.data_ptr(), b.data_ptr(), off.data_ptr(), M, n_segs, n_free, n_lo,
                0, 1 << n_free, iscr.data_ptr(), fscr.data_ptr(), fscr[M:].data_ptr(),
                kscr.data_ptr(), cuda.MAX_BLOCKS, fscr[-1:].data_ptr(), kscr[-1:].data_ptr(), cuda._stream())
            if err:
                raise RuntimeError(f"CUDA error {err}")

        times.append((n_lo, float(np.median(smoke.launch_times(launch, device, False, reps)))))
    print(f"== split widths, {shape}: " + ", ".join(f"{n}: {t:.5f} ms" for n, t in times),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--keys", type=int, nargs="+",
                    default=[2229, 4096, 4097, 50_000, 200_000, 1_162_560])
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_profile: no CUDA device")
    import chip_smoke as smoke
    from symmer_torch.kernels import cuda, torch_noncon

    device = torch.device("cuda", 0)
    cuda._lib()
    rng = np.random.default_rng(0)
    for which, B in smoke.FULL["expval_shapes"]:
        x, z, cr, ci, s, ar, ai, shape = smoke.expval_inputs(device, smoke.FULL, which, B, rng)
        profile(f"expval {shape}", lambda: cuda.expval(x, z, cr, ci, s, ar, ai), args.reps)
        del x, z, cr, ci, s, ar, ai
    for entry in smoke.FULL["brute_shapes"]:
        g, b, off, nc, n_free, shape, _ = smoke.brute_inputs(device, entry)
        profile(f"brute_force_minimise {shape}",
                lambda: cuda.brute_force_minimise(g, b, off, n_free, nc), args.reps)
    for T in args.keys:
        ka = torch.tensor(np.random.default_rng(T).integers(-2**63, 2**63 - 1, T, endpoint=True),
                          device=device)
        for label, fn in (("sort_keys", lambda: cuda.sort_keys(ka)),
                          ("torch.sort", lambda: torch.sort(ka, stable=True))):
            busy = profile(f"{label} {T} keys", fn, args.reps)
            span = smoke.launch_ms(fn, device, cold=False, reps=args.reps) * 1e3
            print(f"   span {span:.2f} us, idle {span - busy:.2f} us", flush=True)
        del ka
    for entry in smoke.FULL["brute_shapes"][:2]:
        split_sweep(smoke, cuda, torch_noncon, device, entry, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
