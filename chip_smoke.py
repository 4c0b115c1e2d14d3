#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (symmer_torch) on one NVIDIA GPU.

    python3 chip_smoke.py    # from the repository root; needs one card

Phases (each prints one line; any failure raises and exits non-zero):
  0. device: nvidia-smi name and power limit, torch's device name;
  1. build: compile the CUDA kernels from symmer_torch/csrc with nvcc and
     print ptxas's registers / shared memory / spills per kernel;
  2. kernels against their plain torch versions on the card: K1 exactly, K5
     bit for bit, K10 (expval) within 1e-12 relative, K12 (brute-force
     search) with the same index and the energy within 1e-12 relative (or,
     at a near-tie, an index whose energy reaches the minimum), K10 and K12
     also bit for bit equal on a second launch, each at the phase-2 shapes
     and at the shapes the main path launches them at (tapered N2 against
     its HF state; its 14-generator search without a reference state);
     each shape's median time with L2 cold (a 128 MB buffer written and
     another read before each launch; K10 and K12 also the cold range) and
     warm, the bound (bytes or operations, from the shape and the work
     these inputs need), the share of the bound, and for K1 the time of
     torch._int_mm on the unpacked operands as a yardstick (library_ms; no
     torch call computes a Clifford scan, a state expectation value or the
     brute-force search); then is_noncontextual at 8,192 terms, K1 (the
     adjacency, with its plain version and torch._int_mm) and K9 timed
     apart, against the host adjacency path;
  3. chemistry: LiH and H2 tapered on the card (resident taper), ground
     energies against their pins to 1e-10;
  4. flagship: the 1000-qubit x 200,000-term, 4-symmetry synthetic taper,
     resident on the card against the port's host path;
  5. algebra core: squaring, a non-Clifford rotation and a DeviceOperator
     chain on the card against the host path;
  6. CS-VQE (backend "device"): Be, HF, H2O and BeH2 tapered, projected by
     ContextualSubspace to 3 qubits, energies against their pins to 1e-10;
     N2 (20 -> 15 -> 8 qubits) and MgH2 (22 -> 17 -> 8) with the tapered
     reference state and UCCSD operator, equal to the port's host path;
     tapered N2 with no reference state (the brute force over all 14
     symmetry generators on the card) reaching the host path's energy
     (anticommutes and the state actions below dispatch.DEVICE_FLOOR
     term-words run on the host: each 8-qubit flow prints its dispatches
     per run by side);
     DeviceOperator.expval of each tapered molecule against its tapered HF
     state;
  7. eigensolvers (the Lanczos slice, on the card, config.device "cuda"):
     the Lanczos kernels against their plain versions first (outside the
     counted run): the X-grouped matvec (group_matvec, recomputing the
     group diagonals from the terms) at tapered N2 (378 groups, 2^15 rows,
     b = 1 and 4), H2O (162 x 2^14) and tapered MgH2 (580 x 2^17) within
     1e-13 of ||out|| and bit-identical on a second launch; the scalar step
     (lanczos_step, pass 1, and lanczos_replay, pass 2, each counted under
     its own key) at the same row counts bit for bit its plain version and
     on a second launch; the table build (build_group_diagonals, off the
     drivers' path) at tapered N2 and H2O bit for bit; times cold and warm,
     bounds (the matvec's float64 operations, recounted in matvec_bound:
     one complex add per term and thread of 2^k rows, a k-stage
     Walsh-Hadamard transform and one complex multiply-add per group, row
     and column, the least over k; the steps' vector bytes), the matvec's
     time for one term at the same launch shape, cuSPARSE's CSR product on
     the table as the matvec's yardstick.  Then,
     counted: exact_gs_energy_device of tapered N2 against the port's host
     eigensolver (1e-10) with <psi|H|psi> equal to the energy; H2O's lowest
     four states (deflate) against host eigsh (1e-9); CH2's ground pair by
     the band recurrence; CH2 with n_particles = 8 against FCI (1e-8);
     QubitSubspaceManager(H2O) with no reference state on the Lanczos
     route, its exact energy against FCI (1e-10) and its 6-qubit
     Hamiltonian equal to the same flow on the CPU device; the counted run
     launches no table build;
  8. coverage: the four kernels of phases 3-6 were launched there, the
     matvec and the two step kernels in phase 7, the evolution slice's
     four in phase 9;
  9. the evolution slice (config.device "cuda"): first, outside the
     counted run, K15a: the single rotation (vqe_rotate, the one-generator
     case of the runs' entry point) at 2^17 and 2^22 rows, and the fused
     forward over coset tiles (vqe_runs) of tapered MgH2's 1,316
     generators at 2^17 bit for bit its plain version, 1,316 sequential
     rotations and a second launch; its adjoint sweep (vqe_adjoint) bit
     for bit its plain version and a second launch, each one cooperative
     launch with grid barriers between the runs;
     K15c (pauli_overlaps, X-grouped) at N = 1 at 2^17 and 2^22 and at
     tapered N2's UCCSD pool (696 Paulis in 91 X groups x 2^15) bit for
     bit its plain version and on a second launch; K11 (gf2_rref) on the
     1000-qubit flagship's joint planes at
     2,048, 20,000 and 200,000 rows and on tapered N2's, bit for bit its
     plain version and the host's gf2core.rref_inplace, timed against the
     host (the crossover); times cold and warm, bounds (bytes, or float64
     operations: 4 a row and rotation, the sweep's 4 a row for an overlap
     and 8 for its two un-rotations, the overlaps' 4 a row and X group and
     2 a row and Pauli; logic ops for K11).  Then, counted, with the
     launches and wrapper calls of one energy, one gradient and one pool
     gradient, and the walls of the process's first gradient and of a
     warm one: VQE_Driver(device_array) at
     tapered MgH2 (17 q, 3,540 terms, the 1,316 non-identity terms of its
     tapered UCCSD operator as generators): f and gradient against the
     plain route on the card (torch.autograd through torch_vqe.energy,
     1e-11 / 1e-10), the host energy of the downloaded state
     (dense.matvec_host, 1e-10) and the exact parameter-shift values of
     three parameters (1e-10); BFGS with 5 iterations, not below the
     Lanczos ground energy; ADAPT_VQE at tapered N2 with its tapered UCCSD
     pool, the first pool gradient against the host commutators (1e-10),
     3 cycles; the CLI's vqe (MgH2, 2 cycles) and contextual_subspace (N2
     to 8 q) as subprocesses with --device cuda; CircuitSymmerlator at
     1,000 qubits and 2,000 Clifford gates against the host path;
     PauliwordOp.generators of a 20,000-term flagship operator (K11's
     route) against the host path.

The line before the last is a JSON object with each kernel's launches,
error and times (twelve kernels); the last line is {"ok": true, "device":
{...}}.
Imports neither jax nor symmer_tpu.  tools/ab_compare.py runs phases 2 and 4
of this file on several checkouts in turns, to compare them on one card.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
HAM_DIR = os.path.join(REPO, "tests", "data", "hamiltonians")
LIH_FILE = os.path.join(HAM_DIR, "LiH_STO-3G_SINGLET_JW.json")
LIH_TAPERED_GS = -7.8827622309719985       # tests/test_projection/test_molecule_parity.py:56
H2_FCI = -1.1368382276023516               # tests/conftest.py:73
H2_JW = {
    "IIII": -0.05933866442819677, "IIIZ": -0.23676939575319134,
    "IIZI": -0.23676939575319134, "IIZZ": 0.17571274411978302,
    "IZII": 0.17579122569046912, "IZIZ": 0.12223870791335416,
    "IZZI": 0.16715312911492025, "ZIII": 0.17579122569046912,
    "ZIIZ": 0.16715312911492025, "ZIZI": 0.12223870791335416,
    "ZZII": 0.17002500620877006, "XXYY": -0.044914421201566114,
    "XYYX": 0.044914421201566114, "YXXY": 0.044914421201566114,
    "YYXX": -0.044914421201566114,
}
# tests/test_projection/test_molecule_parity.py:57-63
CSVQE_3Q_GS = {
    "Be_STO-3G_SINGLET_JW.json": -14.389536593826167,
    "HF_STO-3G_SINGLET_JW.json": -98.57548286236913,
    "H2O_STO-3G_SINGLET_JW.json": -74.96895047987964,
    "BeH2_STO-3G_SINGLET_JW.json": -15.567765366038305,
}
ENERGY_TOL = 1e-10
COEFF_RTOL = 1e-12

# published peaks of one H100 SXM (NVIDIA's data sheet; CUDA C Programming
# Guide throughput table for compute capability 9.0) at the 1.98 GHz boost clock
HBM_BYTES_PER_S = 3.35e12
# the binary tensor-core product (mma.sync m16n8k256 .b1 and.popc), which the
# data sheet does not list: element ops/s (2 per multiply-add of one bit) as
# tools/mma_rate.py measured it on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md)
B1_MMA_OPS_PER_S = 5.175e15
LOP3_OPS_PER_S = 64 * 132 * 1.98e9          # 32-bit logic ops: 64 per clock per SM
POPC_OPS_PER_S = 16 * 132 * 1.98e9          # 32-bit popcounts: 16 per clock per SM
FP64_OPS_PER_S = 64 * 132 * 1.98e9          # float64 adds: 64 per clock per SM
FLUSH_BYTES = 128 << 20                     # > the 50 MB L2 (cold launches)
SLEEP_CYCLES = 200_000                      # ~0.1 ms of card time ahead of each timed launch

# full sizes of the run on the card
FULL = dict(
    # anticommutes (M1, M2, qubits)
    # (the last: the tall-skinny kernel's widest op2, 16 rows)
    ac_shapes=[(300, 70, 100), (10, 600, 40), (200_000, 4, 1000), (4096, 4096, 1000),
               (200_000, 16, 1000)],
    ac_main=(200_000, 4, 1000),   # the projection filter's shape: reported in the JSON
    # clifford_scan (terms, qubits, rotations): the flagship's D = 4, a deep
    # run, and the BASELINE Clifford expectation-value shape (bench.py:355-375)
    scan_shapes=[(200_000, 1000, 4), (200_000, 1000, 64), (100, 1000, 2000)],
    scan_main=(200_000, 1000, 4),
    flagship=(1000, 200_000, 4, 1),
    # expval (operator, state rows): the flagship operator against a
    # 1,024-row state spanned by 10 of its terms' X parts; N2's Hamiltonian
    # against 65,536 distinct rows of its 2^20 basis; the main path's shape
    # (phase 6: DeviceOperator.expval), tapered N2 against its one-row
    # tapered HF state
    expval_shapes=[("flagship", 1024), ("N2_STO-3G_SINGLET_JW.json", 65_536),
                   ("N2_STO-3G_SINGLET_JW.json", "tapered_hf")],
    expval_main=("N2_STO-3G_SINGLET_JW.json", "tapered_hf"),
    # brute-force search (terms, free generators, cliques, compare with
    # plain), then the main path's shape (phase 6): tapered N2's
    # noncontextual part with no reference state
    brute_shapes=[(2048, 24, 3, True), (1024, 28, 3, False),
                  ("N2_STO-3G_SINGLET_JW.json", "noref")],
    brute_main=("N2_STO-3G_SINGLET_JW.json", "noref"),
    # is_noncontextual: NoncontextualOp.random(n_qubits, n_cliques)
    noncon=(12, 3),
    # CS-VQE: the pinned 3-qubit flows, the 8-qubit flows against the host
    # path, the molecule without a reference state
    cs_pinned=sorted(CSVQE_3Q_GS),
    cs_host=[("N2_STO-3G_SINGLET_JW.json", 8), ("MgH2_STO-3G_SINGLET_JW.json", 8)],
    cs_noref="N2_STO-3G_SINGLET_JW.json",
    # eigensolvers: K13's tables (molecule, tapered, column widths), the
    # main path's shape first; the builds checked; the phase-7 flows
    eig_matvec=[("N2_STO-3G_SINGLET_JW.json", True, (1, 4)),
                ("H2O_STO-3G_SINGLET_JW.json", False, (1,)),
                ("MgH2_STO-3G_SINGLET_JW.json", True, (1,))],
    eig_build=[("N2_STO-3G_SINGLET_JW.json", True), ("H2O_STO-3G_SINGLET_JW.json", False)],
    eig_gs="N2_STO-3G_SINGLET_JW.json",
    # the lowest states: the default method ('auto', deflated restarts),
    # and the band recurrence on a degenerate ground multiplet
    eig_lowest=[("H2O_STO-3G_SINGLET_JW.json", 4, "auto"),
                ("CH2_STO-3G_TRIPLET_JW.json", 2, "block")],
    eig_particles=("CH2_STO-3G_TRIPLET_JW.json", 8),
    eig_qsm=("H2O_STO-3G_SINGLET_JW.json", 6),
    square=(1000, 500),
    rotation=(1000, 100_000),
    chain=(1000, 2000, 200),
    # the evolution slice: K15a at tapered (2^17) and untapered (2^22)
    # MgH2's rows; K15c at N = 1 there and tapered N2's UCCSD pool; K11 on
    # the flagship's joint planes (the JSON line at evo_generators rows) and
    # tapered N2's; the phase-9 flows
    evo_rotate=[17, 22],
    evo_overlaps=[(17, 1), (22, 1), ("N2_STO-3G_SINGLET_JW.json", "pool")],
    evo_rref=[("flagship", 2048), ("flagship", 20_000), ("flagship", 200_000),
              ("N2_STO-3G_SINGLET_JW.json", None)],
    evo_generators=20_000,
    evo_vqe="MgH2_STO-3G_SINGLET_JW.json",
    evo_adapt="N2_STO-3G_SINGLET_JW.json",
    evo_cli=[("vqe", "MgH2_STO-3G_SINGLET_JW.json", 2),
             ("contextual_subspace", "N2_STO-3G_SINGLET_JW.json", 8)],
    # CircuitSymmerlator at the BASELINE Clifford shape: qubits, gates,
    # observable terms (BASELINE.md:10, bench.py:355-375)
    evo_circuit=(1000, 2000, 100),
)


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def sync(device) -> None:
    import torch

    torch.cuda.synchronize(device)


def device_ms(fn, device, reps: int = 10) -> float:
    """Mean milliseconds of fn() after a warm-up: CUDA events on the card."""
    import torch

    fn()
    sync(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def launch_ms(fn, device, cold: bool, reps: int = 20) -> float:
    """Median card time of one fn() call (launch_times)."""
    return float(np.median(launch_times(fn, device, cold, reps)))


def launch_times(fn, device, cold: bool, reps: int = 20):
    """Card times of `reps` fn() calls, each call between its own event pair.

    A ~0.1 ms sleep kernel goes ahead of every call, so the card is still busy
    while the host enqueues the call and the events time the card's work, not
    the host's.  cold: a 128 MB buffer
    is written and then another one read, which leaves the 50 MB L2 holding
    neither the inputs nor dirty lines; otherwise the inputs stay there from
    the last call as far as they fit."""
    import torch

    if cold:
        flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)
        clean = torch.ones(FLUSH_BYTES // 8, dtype=torch.int64, device=device)
    fn()
    sync(device)
    events = []
    for _ in range(reps):
        if cold:
            flush.zero_()
            clean.max()
        torch.cuda._sleep(SLEEP_CYCLES)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        events.append((e0, e1))
    sync(device)
    return [e0.elapsed_time(e1) for e0, e1 in events]


def anticommutes_bound(m1: int, m2: int, n_qubits: int):
    """(ms, 'bytes' or 'operations'): the least card time for K1's work.

    Bytes: the four planes read once, the uint8 matrix written once.
    Operations: the binary product [x1|z1] . [z2|x2]^T of the packed bits
    (2 * n_qubits deep) at the binary tensor-core rate."""
    W = -(-n_qubits // 64)
    t_bytes = (16 * W * (m1 + m2) + m1 * m2) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * m1 * m2 * 2 * n_qubits / B1_MMA_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scan_work(x, z, cr, ci, rx, rz, rm):
    """(term-rotation tests, anticommuting pi/2 / 3pi/2 steps) that these
    inputs need, counted by stepping the plain version one rotation at a time."""
    from symmer_torch.kernels import torch_core

    tests = flips = 0
    for d, m in enumerate(rm.tolist()):
        if m % 4 == 0:
            continue
        tests += x.shape[0]
        if m % 2:
            flips += int(torch_core.anticommutes_single(x, z, rx[d], rz[d]).sum())
        x, z, cr, ci = torch_core.clifford_scan(
            x, z, cr, ci, rx[d : d + 1], rz[d : d + 1], rm[d : d + 1])
    return tests, flips


def scan_bound(T: int, W: int, D: int, tests: int, flips: int):
    """(ms, 'bytes' or 'operations'): the least card time for K5's work.

    Bytes: planes and coefficients read once and written once, rotations read
    once.  Operations, in 32-bit halves of each word: the commutation test is
    4 AND/XOR per word; an anticommuting odd step adds 4 XOR (the product), 2
    AND and 2 popcounts (its y count), popcounts at their own quarter rate."""
    t_bytes = (2 * (16 * T * W + 16 * T) + D * (16 * W + 8)) / HBM_BYTES_PER_S * 1e3
    lop = 4 * W * tests + 6 * W * flips
    t_ops = max(lop / LOP3_OPS_PER_S, 2 * W * flips / POPC_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def matched_pairs(x, s):
    """(term pairs, group pairs, U) of K10: the (term, row) pairs and the
    (X group, row) pairs whose target s_b ^ x is a row of the deduplicated
    state s, and the number U of distinct X parts, counted exactly on the
    card (torch.unique over whole rows), from the smaller side: groups x
    rows, or ordered pairs of rows (each XOR s_b ^ s_b' matches the group
    with that X part)."""
    import torch

    def weight_of(keys, table, weights):
        """Per key row: the weight of the equal row of `table` (unique rows), or 0."""
        _, inv = torch.unique(torch.cat([table, keys]), dim=0, return_inverse=True)
        w = torch.zeros(int(inv.max()) + 1, dtype=torch.int64, device=keys.device)
        w[inv[: table.shape[0]]] = weights
        return w[inv[table.shape[0]:]]

    W = x.shape[1]
    B = s.shape[0]
    ux, counts = torch.unique(x, dim=0, return_counts=True)
    U = ux.shape[0]
    n_terms = n_groups = 0
    step = max(1, (1 << 22) // B)
    if B <= U:
        for b0 in range(0, B, step):
            d = (s[b0:b0 + step, None, :] ^ s[None, :, :]).reshape(-1, W)
            w = weight_of(d, ux, counts)
            n_terms += int(w.sum())
            n_groups += int((w > 0).sum())
    else:
        ones = torch.ones(B, dtype=torch.int64, device=s.device)
        for g0 in range(0, U, step):
            targets = (s[None, :, :] ^ ux[g0:g0 + step, None, :]).reshape(-1, W)
            hit = weight_of(targets, s, ones).reshape(-1, B)
            n_terms += int((hit.sum(1) * counts[g0:g0 + step]).sum())
            n_groups += int(hit.sum())
    return n_terms, n_groups, U


def expval_bound(T: int, B: int, W: int, U: int, matched: int, matched_groups: int):
    """(ms, 'bytes' or 'operations'): the least card time for K10's function
    on these inputs, whatever the design.

    Bytes: the operator (2 planes + 2 float64 per term) and the state (1
    plane + 2 float64 per row) read once, 16 bytes written.  Operations, in
    32-bit halves of each word.  Finding the matches takes one hash probe
    per (X group, row) pair or per unordered pair of rows, whichever is
    fewer (U distinct X parts); a probe is 4 logic ops (a linear hash of the
    target is the XOR of two precomputed hashes, then one compare), and the
    hashes read every word of every term and row once (2 W ops each).  Each
    of the `matched` (term, row) pairs then needs its sign, the parity of
    s_b' & z_t folded into one word (2 W three-input logic ops) and one
    popcount, and 2 float64 adds; each of the `matched_groups` (group, row)
    pairs one complex product a_b conj(a_b') and its sum (8 float64 ops)."""
    t_bytes = (T * (16 * W + 16) + B * (8 * W + 16) + 16) / HBM_BYTES_PER_S * 1e3
    probes = min(U * B, B * (B + 1) // 2)
    lop = 4 * probes + 2 * W * (T + B) + 2 * W * matched
    t_ops = max(lop / LOP3_OPS_PER_S, matched / POPC_OPS_PER_S,
                (8 * matched_groups + 2 * matched) / FP64_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def brute_bound(seg_sizes, n_free: int):
    """(ms, 'bytes' or 'operations'): the least card time for K12's function,
    whatever the design.

    A segment's sums over every assignment k take, in float64 adds, the
    least of: the direct sum, M_s N (N = 2^n_free); the Walsh-Hadamard
    transform of its terms' folded bases bucketed by free mask,
    n_free N + M_s; or the split transform, whose 2^n_lo-point transforms
    over the low bits of k start from buckets signed by the high bits,
    N (n_lo + M_s / 2^n_lo), at its best n_lo.  Then per assignment the
    energy (n_segs - 1 multiply-adds, a square root and a subtraction, one
    float64 op each).  Inputs (12 bytes a term) read once, 16 bytes
    written."""
    N = 1 << n_free
    fp64 = N * (len(seg_sizes) + 1)
    for m in seg_sizes:
        split = min(N * n_lo + m * (N >> n_lo) for n_lo in range(1, n_free + 1))
        fp64 += min(m * N, n_free * N + m, split)
    t_bytes = (12 * sum(seg_sizes) + 16) / HBM_BYTES_PER_S * 1e3
    t_ops = fp64 / FP64_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def int_mm_ms(x1, z1, x2, z2, n_qubits, want) -> float:
    """Cold ms of torch._int_mm on K1's unpacked operands: a yardstick the
    port never calls (the int8 product's parity is the anticommutation
    matrix; checked against `want`).  N is padded to a multiple of 8."""
    import torch

    pad = (-x2.shape[0]) % 8
    a = torch.cat([unpacked_bits(x1, n_qubits), unpacked_bits(z1, n_qubits)], dim=1)
    b = torch.cat([unpacked_bits(z2, n_qubits), unpacked_bits(x2, n_qubits)], dim=1)
    b = torch.cat([b, b.new_zeros((pad, b.shape[1]))]).contiguous()
    lib = torch._int_mm(a, b.t())
    assert torch.equal((lib[:, :x2.shape[0]] & 1).bool(), want), "int_mm yardstick differs"
    del lib
    return launch_ms(lambda: torch._int_mm(a, b.t()), x1.device, cold=True)


def unpacked_bits(planes, n_qubits: int):
    """int8[M, n_qubits] 0/1 bits of int64[M, W] planes (on their device)."""
    import torch

    shifts = torch.arange(64, device=planes.device)
    bits = (planes[:, :, None] >> shifts) & 1
    return bits.reshape(planes.shape[0], -1)[:, :n_qubits].to(torch.int8)


def best_of(fn, device, n: int = 3):
    """(best wall ms of n warm runs, last result); one warm-up run first."""
    out = fn()
    sync(device)
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best, out


def rand_planes(rng, rows: int, n_qubits: int, density: float = 0.5) -> np.ndarray:
    """uint64[rows, ceil(n/64)] planes with each qubit bit set w.p. density."""
    from symmer_torch.kernels import pack

    return pack.pack_bits(rng.random((rows, n_qubits)) < density, n_qubits)


@functools.lru_cache(maxsize=None)
def synthetic_taper_operator(n_qubits, n_terms, n_sym, seed):
    """Random operator with n_sym planted Z2 symmetries: the generator of
    bench.py:647-664 (qubits split into n_sym blocks; every term's X support
    has even overlap with each block, so each block's all-Z string commutes
    with the whole operator)."""
    from symmer_torch import PauliwordOp

    rng = np.random.default_rng(seed)
    block = n_qubits // n_sym
    xb = rng.integers(0, 2, (n_terms, n_qubits)).astype(bool)
    zb = rng.integers(0, 2, (n_terms, n_qubits)).astype(bool)
    for k in range(n_sym):
        parity = xb[:, k * block : (k + 1) * block].sum(axis=1) & 1
        xb[parity == 1, k * block] ^= True
    coeffs = rng.normal(size=n_terms) + 1j * rng.normal(size=n_terms)
    return PauliwordOp(np.hstack([xb, zb]), coeffs).cleanup()


def random_operator(rng, n_qubits, n_terms, density=0.3, n_diagonal=0):
    """Random operator; its first n_diagonal terms are I/Z-only."""
    from symmer_torch import PauliwordOp

    x = rand_planes(rng, n_terms, n_qubits, density)
    x[:n_diagonal] = 0
    return PauliwordOp.from_planes(
        x, rand_planes(rng, n_terms, n_qubits, density),
        rng.normal(size=n_terms) + 1j * rng.normal(size=n_terms), n_qubits,
    ).cleanup()


def single_pauli(rng, n_qubits, density=0.1):
    from symmer_torch import PauliwordOp

    return PauliwordOp.from_planes(
        rand_planes(rng, 1, n_qubits, density), rand_planes(rng, 1, n_qubits, density),
        [1.0], n_qubits,
    )


def compare_ops(a, b) -> float:
    """Assert equal term sets; return the largest relative coefficient error."""
    assert a.n_qubits == b.n_qubits, (a.n_qubits, b.n_qubits)
    assert a.n_terms == b.n_terms, f"term counts differ: {a.n_terms} vs {b.n_terms}"

    def ordered(op):
        rows = np.hstack([op.x_pack, op.z_pack])
        order = np.lexsort(rows.T[::-1])
        return rows[order], op.coeff_vec[order]

    ra, ca = ordered(a)
    rb, cb = ordered(b)
    assert np.array_equal(ra, rb), "term sets differ"
    scale = np.maximum(np.maximum(np.abs(ca), np.abs(cb)), np.finfo(float).tiny)
    err = float(np.max(np.abs(ca - cb) / scale)) if len(ca) else 0.0
    assert err <= COEFF_RTOL, f"coefficients differ by {err:.3e} relative"
    return err


def ground_energy(op) -> float:
    return float(np.linalg.eigvalsh(op.to_sparse_matrix.toarray())[0])


def load_molecule(name):
    """(PauliwordOp, hf_array, data) of a tests/data/hamiltonians file."""
    from symmer_torch import PauliwordOp

    with open(os.path.join(HAM_DIR, name)) as f:
        data = json.load(f)
    return (PauliwordOp.from_dictionary(data["hamiltonian"]),
            np.asarray(data["data"]["hf_array"]), data)


def rel_err(got: complex, want: complex) -> float:
    return abs(got - want) / max(abs(want), np.finfo(float).tiny)


def energy_at(gmask, base, seg_off, n_free: int, k: int) -> float:
    """E of one assignment index from its definition (float64, host)."""
    g = gmask.cpu().numpy()
    kk = ((~k) & ((1 << n_free) - 1)) | (1 << 31)
    parity = (np.bitwise_count(g & kk) & 1).astype(np.int64)
    signed = (1 - 2 * parity) * base.cpu().numpy()
    b = seg_off.tolist()
    sums = [float(signed[b[i]:b[i + 1]].sum()) for i in range(len(b) - 1)]
    return sums[0] - float(np.sqrt(sum(v * v for v in sums[1:])))


# -- phases -------------------------------------------------------------------

def phase_kernels(device, sizes, rng):
    """Phase 2: each kernel against its plain torch version on `device`."""
    import torch

    from symmer_torch.kernels import cuda, torch_core

    to = lambda a: torch.tensor(np.ascontiguousarray(a).view(np.int64), device=device)
    report = {}
    ac_err = 0
    for m1, m2, nq in sizes["ac_shapes"]:
        x1, z1 = to(rand_planes(rng, m1, nq)), to(rand_planes(rng, m1, nq))
        x2, z2 = to(rand_planes(rng, m2, nq)), to(rand_planes(rng, m2, nq))
        got = cuda.anticommutes(x1, z1, x2, z2)
        want = torch_core.anticommutes(x1, z1, x2, z2)
        sync(device)
        err = int((got.to(torch.int16) - want.to(torch.int16)).abs().max())
        assert torch.equal(got, want), f"anticommutes differs at {(m1, m2, nq)}"
        ac_err = max(ac_err, err)
        kernel = lambda: cuda.anticommutes(x1, z1, x2, z2)
        t_cold = launch_ms(kernel, device, cold=True)
        t_warm = launch_ms(kernel, device, cold=False)
        t_p = device_ms(lambda: torch_core.anticommutes(x1, z1, x2, z2), device, reps=3)
        bound, bound_by = anticommutes_bound(m1, m2, nq)
        # torch._int_mm takes more than 16 rows
        t_lib = int_mm_ms(x1, z1, x2, z2, nq, want) if m1 > 16 else None
        stream = {}
        if m1 > 16 and m2 <= 16:
            # what one plain launch takes to stream op1's bytes on this card:
            # a torch reduction over both planes (not the same function)
            op1 = torch.cat([x1, z1])
            stream["stream_ms"] = f"{launch_ms(lambda: op1.max(), device, cold=True):.5f}"
            del op1
        say("2 kernels", kernel="anticommutes", shape=f"{m1}x{m2}x{nq}q", equal=True,
            ms_l2_cold=f"{t_cold:.5f}", ms_l2_warm=f"{t_warm:.5f}", plain_ms=f"{t_p:.5f}",
            bound_ms=f"{bound:.5f}", bound_by=bound_by,
            share_cold=f"{bound / t_cold:.5f}", share_warm=f"{bound / t_warm:.5f}",
            library_ms="null" if t_lib is None else f"{t_lib:.5f}", **stream)
        if (m1, m2, nq) == tuple(sizes["ac_main"]):
            report["anticommutes"] = dict(
                max_abs_err=0, ms=t_cold, ms_l2_warm=t_warm, plain_ms=t_p,
                bound_ms=bound, bound_by=bound_by, library_ms=t_lib,
                shape=f"{m1}x{m2}x{nq}q")
    report["anticommutes"]["max_abs_err"] = ac_err

    for T, nq, D in sizes["scan_shapes"]:
        x, z = to(rand_planes(rng, T, nq)), to(rand_planes(rng, T, nq))
        c = rng.normal(size=(2, T))
        c[:, :4] = [[0.0, -0.0, 0.0, -0.0], [-0.0, 0.0, 1.0, -1.0]]  # signed zeros
        cr, ci = torch.tensor(c[0], device=device), torch.tensor(c[1], device=device)
        rx, rz = to(rand_planes(rng, D, nq, 0.05)), to(rand_planes(rng, D, nq, 0.05))
        rm = torch.tensor(rng.integers(-4, 5, D), dtype=torch.int64, device=device)
        got = cuda.clifford_scan(x, z, cr, ci, rx, rz, rm)
        want = torch_core.clifford_scan(x, z, cr, ci, rx, rz, rm)
        sync(device)
        for name, g, w in zip(("x", "z", "cr", "ci"), got, want):
            g_bits = g.view(torch.int64) if g.dtype == torch.float64 else g
            w_bits = w.view(torch.int64) if w.dtype == torch.float64 else w
            assert torch.equal(g_bits, w_bits), f"clifford_scan {name} differs bitwise"
        scan_err = max(float((got[2] - want[2]).abs().max()),
                       float((got[3] - want[3]).abs().max()))
        changed = int((got[0] != x).any(dim=1).sum())
        kernel = lambda: cuda.clifford_scan(x, z, cr, ci, rx, rz, rm)
        t_cold = launch_ms(kernel, device, cold=True)
        t_warm = launch_ms(kernel, device, cold=False)
        t_p = device_ms(lambda: torch_core.clifford_scan(x, z, cr, ci, rx, rz, rm),
                        device, reps=3)
        tests, flips = scan_work(x, z, cr, ci, rx, rz, rm)
        bound, bound_by = scan_bound(T, x.shape[1], D, tests, flips)
        say("2 kernels", kernel="clifford_scan", shape=f"{T}x{nq}q_D{D}",
            bitwise_equal=True, rows_changed=changed, anticommuting_steps=flips,
            ms_l2_cold=f"{t_cold:.5f}", ms_l2_warm=f"{t_warm:.5f}", plain_ms=f"{t_p:.5f}",
            bound_ms=f"{bound:.5f}", bound_by=bound_by,
            share_cold=f"{bound / t_cold:.5f}", share_warm=f"{bound / t_warm:.5f}",
            library_ms="null")
        if (T, nq, D) == tuple(sizes["scan_main"]):
            # no single torch call computes a Clifford scan: library_ms is null
            report["clifford_scan"] = dict(
                max_abs_err=scan_err, ms=t_cold, ms_l2_warm=t_warm, plain_ms=t_p,
                bound_ms=bound, bound_by=bound_by, library_ms=None,
                shape=f"{T}x{nq}q_D{D}")
    return report


def expval_inputs(device, sizes, which, B, rng):
    """Operator planes and a deduplicated state on `device` for K10, and a
    label of the shape.  B = "tapered_hf": the molecule tapered on the host
    against its tapered HF state (the main path's shape)."""
    import torch

    from symmer_torch.kernels import pack, torch_state

    if which == "flagship":
        H = synthetic_taper_operator(*sizes["flagship"])
        # 1,024 rows spanned by 10 terms' X parts (offset by a random row):
        # those terms match every row, the others almost none
        gens = H.x_pack[rng.choice(H.n_terms, 10, replace=False)]
        idx = np.arange(B)
        s = rand_planes(rng, 1, H.n_qubits).repeat(B, axis=0)
        for j in range(10):
            s[(idx >> j) & 1 == 1] ^= gens[j]
        a = rng.normal(size=(2, s.shape[0]))
    elif B == "tapered_hf":
        H, psi = tapered_molecule(which)
        s, a = psi._s_pack, np.stack([psi._amps.real, psi._amps.imag])
    else:
        H, _, _ = load_molecule(which)
        rows = rng.choice(1 << H.n_qubits, B, replace=False)
        s = pack.pack_bits((rows[:, None] >> np.arange(H.n_qubits)) & 1 == 1, H.n_qubits)
        a = rng.normal(size=(2, s.shape[0]))
    if B != "tapered_hf":
        a /= np.sqrt((a * a).sum())
    to = lambda v: torch.tensor(np.ascontiguousarray(v).view(np.int64), device=device)
    f = lambda v: torch.tensor(np.ascontiguousarray(v, dtype=np.float64), device=device)
    st, ar, ai = torch_state.cleanup_state(to(s), f(a[0]), f(a[1]))
    label = "tapered" if B == "tapered_hf" else which.split("_")[0]
    shape = f"{label}_{H.n_terms}x{st.shape[0]}rows_{H.n_qubits}q"
    return (to(H.x_pack), to(H.z_pack), f(H.coeff_vec.real), f(H.coeff_vec.imag),
            st, ar, ai, shape)


@functools.lru_cache(maxsize=None)
def tapered_molecule(name):
    """(tapered operator, tapered HF state) of a tests/data/hamiltonians file,
    tapered on the host as phase 6 tapers it."""
    from symmer_torch import QubitTapering, config

    H, hf, _ = load_molecule(name)
    backend, config.backend = config.backend, "host"
    try:
        qt = QubitTapering(H)
        return qt.taper_it(ref_state=hf), qt.tapered_ref_state
    finally:
        config.backend = backend


def brute_inputs(device, entry):
    """(gmask, base, seg_off, n_cliques, n_free, shape, compare) for K12: a
    random search (terms, free generators, cliques, compare), or
    (molecule, "noref"): the noncontextual part of the tapered molecule
    (NoncontextualOp.from_hamiltonian, "SingleSweep_magnitude", as
    ContextualSubspace builds it) with every generator free, as phase 6's
    no-reference solve searches it."""
    from symmer_torch.kernels import torch_noncon

    if entry[1] == "noref":
        from symmer_torch import config
        from symmer_torch.operators import NoncontextualOp

        H_taper, _ = tapered_molecule(entry[0])
        backend, config.backend = config.backend, "host"
        try:
            nc = NoncontextualOp.from_hamiltonian(H_taper, strategy="SingleSweep_magnitude")
        finally:
            config.backend = backend
        F = (nc.G_indices == 1).astype(np.float64)
        n_free = F.shape[1]
        g, b, off, n_cl = torch_noncon.kernel_inputs(
            F, np.zeros(F.shape[0]), (nc.coeff_vec * nc.pauli_mult_signs).real,
            nc.mask_S0.astype(np.float64), nc.mask_Ci.astype(np.float64), device)
        shape = f"tapered_{entry[0].split('_')[0]}_{F.shape[0]}terms_{n_free}free_{n_cl}cliques"
        return g, b, off, n_cl, n_free, shape, True
    M, n_free, n_cl, compare = entry
    r = np.random.default_rng(M + n_free)
    clique = r.integers(-1, n_cl, M)
    mCi = np.array([(clique == i) for i in range(n_cl)], float).reshape(-1, M)
    g, b, off, nc = torch_noncon.kernel_inputs(
        r.integers(0, 2, (M, n_free)), r.integers(0, 2, M), r.normal(size=M),
        (clique < 0).astype(float), mCi, device)
    return g, b, off, nc, n_free, f"{M}terms_{n_free}free_{n_cl}cliques", compare


def cold_warm(kernel, device, reps):
    """(cold median, warm median, 'min-max' of the cold times)."""
    cold = launch_times(kernel, device, cold=True, reps=reps)
    warm = launch_ms(kernel, device, cold=False, reps=reps)
    return float(np.median(cold)), warm, f"{min(cold):.5f}-{max(cold):.5f}"


def phase_state_kernels(device, sizes, rng):
    """Phase 2, the kernels of the CS-VQE slice: K10 (expval) and K12
    (brute-force search) against their plain versions, at the phase-2
    shapes and at the shapes the main path launches them at, then
    is_noncontextual at size with K1 and K9 timed apart."""
    import torch

    from symmer_torch.kernels import cuda, torch_core, torch_noncon, torch_state

    report = {}
    no_lib = "no single torch call computes this function"
    for which, B in sizes["expval_shapes"]:
        x, z, cr, ci, s, ar, ai, shape = expval_inputs(device, sizes, which, B, rng)
        T, W = x.shape
        got = cuda.expval(x, z, cr, ci, s, ar, ai)
        again = cuda.expval(x, z, cr, ci, s, ar, ai)
        want = torch_state.expval(x, z, cr, ci, s, ar, ai)
        sync(device)
        assert torch.equal(torch.stack(got), torch.stack(again)), (
            f"expval not repeatable at {shape}")
        g = complex(float(got[0]), float(got[1]))
        w = complex(float(want[0]), float(want[1]))
        err = rel_err(g, w)
        assert err <= COEFF_RTOL and w != 0, f"expval differs at {shape}: {g!r} vs {w!r}"
        kernel = lambda: cuda.expval(x, z, cr, ci, s, ar, ai)
        t_cold, t_warm, spread = cold_warm(kernel, device, 20)
        t_p = device_ms(lambda: torch_state.expval(x, z, cr, ci, s, ar, ai), device, reps=1)
        matched, matched_groups, U = matched_pairs(x, s)
        bound, bound_by = expval_bound(T, s.shape[0], W, U, matched, matched_groups)
        say("2 kernels", kernel="expval", shape=shape, value=repr(g), rel_err=f"{err:.2e}",
            x_groups=U, matched_pairs=matched, matched_group_pairs=matched_groups,
            ms_l2_cold=f"{t_cold:.5f}", ms_l2_cold_range=spread, ms_l2_warm=f"{t_warm:.5f}",
            plain_ms=f"{t_p:.5f}", bound_ms=f"{bound:.5f}", bound_by=bound_by,
            share_cold=f"{bound / t_cold:.5f}", share_warm=f"{bound / t_warm:.5f}",
            library_ms=f"null ({no_lib})")
        if (which, B) == tuple(sizes["expval_main"]):
            report["expval"] = dict(
                max_abs_err=abs(g - w), ms=t_cold, ms_l2_warm=t_warm, plain_ms=t_p,
                bound_ms=bound, bound_by=bound_by, library_ms=None,
                library_null_reason=no_lib, shape=shape)
        del x, z, cr, ci, s, ar, ai

    for entry in sizes["brute_shapes"]:
        g_, b_, off, nc, n_free, shape, compare = brute_inputs(device, entry)
        e, k = cuda.brute_force_minimise(g_, b_, off, n_free, nc)
        e_again, k_again = cuda.brute_force_minimise(g_, b_, off, n_free, nc)
        sync(device)
        assert torch.equal(e.view(torch.int64), e_again.view(torch.int64)) and int(k) == int(
            k_again), f"brute force not repeatable at {shape}"
        e, k = float(e), int(k)
        assert abs(energy_at(g_, b_, off, n_free, k) - e) <= COEFF_RTOL * max(1.0, abs(e))
        fields, err, t_p = {}, 0.0, None
        if compare:
            e2, k2 = torch_noncon.brute_force_plain(g_, b_, off, n_free, nc)
            e2, k2 = float(e2), int(k2)
            err = abs(e - e2)
            assert err <= COEFF_RTOL * max(1.0, abs(e2)), f"brute force energy {e!r} vs {e2!r}"
            # another index only at a near-tie: its energy reaches the minimum
            assert k == k2 or abs(energy_at(g_, b_, off, n_free, k) - e2) <= (
                COEFF_RTOL * max(1.0, abs(e2))), f"brute force index {k} vs {k2}"
            t_p = device_ms(lambda: torch_noncon.brute_force_plain(g_, b_, off, n_free, nc),
                            device, reps=1)
            fields = dict(plain_index=k2, plain_ms=f"{t_p:.5f}")
        else:
            fields = dict(plain_ms="null (not run at this size)")
        kernel = lambda: cuda.brute_force_minimise(g_, b_, off, n_free, nc)
        reps = 5 if n_free >= 24 else 20
        t_cold, t_warm, spread = cold_warm(kernel, device, reps)
        bound, bound_by = brute_bound((off[1:] - off[:-1]).tolist(), n_free)
        say("2 kernels", kernel="brute_force_minimise", shape=shape, energy=repr(e), index=k,
            ms_l2_cold=f"{t_cold:.5f}", ms_l2_cold_range=spread, ms_l2_warm=f"{t_warm:.5f}",
            **fields, bound_ms=f"{bound:.5f}", bound_by=bound_by,
            share_cold=f"{bound / t_cold:.5f}", share_warm=f"{bound / t_warm:.5f}",
            library_ms=f"null ({no_lib})")
        if tuple(entry[:2]) == tuple(sizes["brute_main"]):
            report["brute_force_minimise"] = dict(
                max_abs_err=err, ms=t_cold, ms_l2_warm=t_warm, plain_ms=t_p,
                bound_ms=bound, bound_by=bound_by, library_ms=None,
                library_null_reason=no_lib, shape=shape)

    # is_noncontextual at size: the adjacency by K1, the test (K9) in torch
    from symmer_torch import config
    from symmer_torch.kernels import dispatch
    from symmer_torch.operators import NoncontextualOp, check_adjmat_noncontextual

    nq, n_cl = sizes["noncon"]
    np.random.seed(0)
    t0 = time.perf_counter()
    nc_op = NoncontextualOp.random(n_qubits=nq, n_cliques=n_cl)
    t_build = time.perf_counter() - t0
    x, z = nc_op.x_pack, nc_op.z_pack
    r = np.random.default_rng(1)
    for _ in range(1000):
        xe, ze = rand_planes(r, 1, nq), rand_planes(r, 1, nq)
        xc, zc = np.vstack([x, xe]), np.vstack([z, ze])
        if not check_adjmat_noncontextual(~np_anticommutes(xc, zc)):
            break
    else:
        raise AssertionError("no term found that makes the operator contextual")
    backend = config.backend
    config.backend, config.device = "device", device
    try:
        for label, (px, pz), want in (("noncontextual", (x, z), True),
                                      ("contextual", (xc, zc), False)):
            host = check_adjmat_noncontextual(~np_anticommutes(px, pz))
            assert host is want, f"host adjacency path says {host} for the {label} operator"
            dev_answer = dispatch.is_noncontextual(px, pz)
            assert dev_answer is want, f"is_noncontextual {dev_answer} for the {label} operator"
            to = lambda v: torch.tensor(np.ascontiguousarray(v).view(np.int64), device=device)
            xd, zd = to(px), to(pz)
            k1 = lambda: cuda.anticommutes(xd, zd, xd, zd)
            t_k1 = launch_ms(k1, device, cold=True)
            t_k1_warm = launch_ms(k1, device, cold=False)
            plain = torch_core.anticommutes(xd, zd, xd, zd)
            assert torch.equal(k1(), plain), f"anticommutes differs on the {label} adjacency"
            t_k1_plain = device_ms(lambda: torch_core.anticommutes(xd, zd, xd, zd), device,
                                   reps=3)
            t_k1_lib = int_mm_ms(xd, zd, xd, zd, nq, plain)
            adj = ~plain
            del plain
            t_k9 = device_ms(lambda: bool(torch_core.check_noncontextual_adj(adj)), device,
                             reps=5)
            k1_bound, k1_by = anticommutes_bound(px.shape[0], px.shape[0], nq)
            t_all, _ = best_of(lambda: dispatch.is_noncontextual(px, pz), device)
            say("2 kernels", check="is_noncontextual", operator=label,
                terms=px.shape[0], qubits=nq, answer=dev_answer, host_answer=host,
                k1_adjacency_ms_l2_cold=f"{t_k1:.5f}", k1_ms_l2_warm=f"{t_k1_warm:.5f}",
                k1_plain_ms=f"{t_k1_plain:.5f}", k1_library_ms=f"{t_k1_lib:.5f}",
                k1_bound_ms=f"{k1_bound:.5f}", k1_bound_by=k1_by,
                k1_share_cold=f"{k1_bound / t_k1:.5f}", k9_ms=f"{t_k9:.5f}",
                dispatch_best_ms=f"{t_all:.3f}", build_s=f"{t_build:.2f}")
            del xd, zd, adj
    finally:
        config.backend = backend
    return report


def np_anticommutes(x, z):
    from symmer_torch.kernels import np_core

    return np_core.anticommutes(x, z, x, z)


def phase_chemistry(device):
    """Phase 3: LiH and H2 resident tapers against their pinned energies."""
    from symmer_torch import PauliwordOp, QubitTapering

    with open(LIH_FILE) as f:
        data = json.load(f)
    H = PauliwordOp.from_dictionary(data["hamiltonian"])
    t0 = time.perf_counter()
    tapered = QubitTapering(H).taper_it(
        ref_state=np.asarray(data["data"]["hf_array"]), aux_operator=H.to_device()
    ).to_host()
    sync(device)
    t_lih = (time.perf_counter() - t0) * 1e3
    e_lih = ground_energy(tapered)
    assert abs(e_lih - LIH_TAPERED_GS) < ENERGY_TOL, f"LiH {e_lih!r} vs {LIH_TAPERED_GS!r}"
    say("3 chemistry", system="LiH_STO-3G", qubits=f"{H.n_qubits}->{tapered.n_qubits}",
        terms=tapered.n_terms, energy=repr(e_lih), err=f"{abs(e_lih - LIH_TAPERED_GS):.2e}",
        wall_ms=f"{t_lih:.1f}")

    H2 = PauliwordOp.from_dictionary(H2_JW)
    tapered = QubitTapering(H2).taper_it(
        ref_state=np.array([1, 1, 0, 0]), aux_operator=H2.to_device()
    ).to_host()
    e_h2 = ground_energy(tapered)
    assert abs(e_h2 - H2_FCI) < ENERGY_TOL, f"H2 {e_h2!r} vs FCI {H2_FCI!r}"
    say("3 chemistry", system="H2_STO-3G", qubits=f"{H2.n_qubits}->{tapered.n_qubits}",
        energy=repr(e_h2), err=f"{abs(e_h2 - H2_FCI):.2e}")


def phase_flagship(device, sizes, config):
    """Phase 4: the synthetic taper, resident on the card vs the host path."""
    from symmer_torch import QubitTapering

    nq, nt, ns, seed = sizes["flagship"]
    t0 = time.perf_counter()
    H = synthetic_taper_operator(nq, nt, ns, seed)
    qt = QubitTapering(H)
    ref = np.zeros(nq, dtype=int)
    H_dev = H.to_device()
    sync(device)
    say("4 flagship", operator=f"{nq}q_x_{H.n_terms}terms", symmetries=qt.n_taper,
        setup_s=f"{time.perf_counter() - t0:.2f}")
    t_res, out = best_of(lambda: qt.taper_it(ref_state=ref, aux_operator=H_dev), device)
    resident = out.to_host()
    config.backend = "host"
    try:
        qt_host = QubitTapering(H)
        t_host, host = best_of(lambda: qt_host.taper_it(ref_state=ref), device)
    finally:
        config.backend = "device"
    err = compare_ops(resident, host)
    say("4 flagship", tapered=f"{resident.n_qubits}q_x_{resident.n_terms}terms",
        same_term_set=True, max_rel_err=f"{err:.2e}",
        resident_best_ms=f"{t_res:.2f}", host_best_ms=f"{t_host:.2f}")
    return dict(resident_ms=t_res, host_ms=t_host)


def phase_algebra(device, sizes, config, rng):
    """Phase 5: squaring, non-Clifford rotation, DeviceOperator chain."""
    def both(fn):
        t_dev, dev_out = best_of(fn, device)
        config.backend = "host"
        try:
            t_host, host_out = best_of(fn, device)
        finally:
            config.backend = "device"
        return t_dev, dev_out, t_host, host_out

    nq, nt = sizes["square"]
    A = random_operator(rng, nq, nt)
    t_dev, dev_out, t_host, host_out = both(lambda: A * A)
    err = compare_ops(dev_out, host_out)
    say("5 algebra", op=f"square_{nq}q_x_{A.n_terms}", out_terms=dev_out.n_terms,
        max_rel_err=f"{err:.2e}", device_best_ms=f"{t_dev:.2f}", host_best_ms=f"{t_host:.2f}")

    nq, nt = sizes["rotation"]
    B = random_operator(rng, nq, nt)
    r = single_pauli(rng, nq, 0.3)
    t_dev, dev_out, t_host, host_out = both(lambda: B.perform_rotations([(r, 0.3)]))
    err = compare_ops(dev_out, host_out)
    say("5 algebra", op=f"rotation_{nq}q_x_{B.n_terms}", out_terms=dev_out.n_terms,
        max_rel_err=f"{err:.2e}", device_best_ms=f"{t_dev:.2f}", host_best_ms=f"{t_host:.2f}")

    nq, n1, n2 = sizes["chain"]
    C1 = random_operator(rng, nq, n1, 0.02, n_diagonal=n1 // 2)
    C2 = random_operator(rng, nq, n2, 0.02, n_diagonal=n2 // 2)
    rots = [(single_pauli(rng, nq, 0.02), a) for a in (0.3, None, np.pi, 0.7, -np.pi / 2)]
    t0 = time.perf_counter()
    chain = C1.to_device().cleanup().multiply(C2.to_device()).perform_rotations(rots)
    e_dev = chain.expval_iz()
    sync(device)
    t_chain = (time.perf_counter() - t0) * 1e3
    config.backend = "host"
    try:
        host_chain = (C1.cleanup() * C2).perform_rotations(rots)
    finally:
        config.backend = "device"
    err = compare_ops(chain.to_host(), host_chain)
    diag = ~np.any(host_chain.x_pack != 0, axis=1)
    e_host = complex(np.sum(host_chain.coeff_vec[diag]))
    assert diag.any() and abs(e_dev - e_host) <= 1e-12 * max(1.0, abs(e_host)), (e_dev, e_host)
    say("5 algebra", op=f"chain_{nq}q_{C1.n_terms}x{C2.n_terms}_rot{len(rots)}",
        out_terms=chain.n_terms, max_rel_err=f"{err:.2e}", expval_iz=repr(e_dev),
        wall_ms=f"{t_chain:.2f}")


def cs_vqe_flow(name, n_qubits, with_aux):
    """Taper -> ContextualSubspace("SingleSweep_magnitude") -> n_qubits.

    with_aux: the tapered reference state fixes the sector and the tapered
    UCCSD operator drives the stabilizer search (test_molecule_parity.py:
    165-175); otherwise neither (test_molecule_parity.py:84-88).  Returns
    (projected operator, QubitTapering, tapered operator)."""
    from symmer_torch import ContextualSubspace, PauliwordOp, QubitTapering

    H, hf, data = load_molecule(name)
    qt = QubitTapering(H)
    H_taper = qt.taper_it(ref_state=hf)
    cs = ContextualSubspace(
        H_taper, noncontextual_strategy="SingleSweep_magnitude",
        reference_state=qt.tapered_ref_state.normalize if with_aux else None,
    )
    aux = None
    if with_aux:
        aux = qt.taper_it(aux_operator=PauliwordOp.from_dictionary(
            data["data"]["auxiliary_operators"]["UCCSD_operator"]))
    cs.update_stabilizers(n_qubits, aux_operator=aux, strategy="aux_preserving")
    return cs.project_onto_subspace(), qt, H_taper


def phase_csvqe(device, sizes, config):
    """Phase 6: the contextual-subspace flows on the card (backend 'device')."""
    from symmer_torch import ContextualSubspace, QubitTapering
    from symmer_torch.kernels import cuda
    from symmer_torch.profiling import kernel_stats

    for name in sizes["cs_pinned"]:
        t0 = time.perf_counter()
        H_cs, _, H_taper = cs_vqe_flow(name, 3, with_aux=False)
        sync(device)
        wall = (time.perf_counter() - t0) * 1e3
        e = ground_energy(H_cs)
        pin = CSVQE_3Q_GS[name]
        assert H_cs.n_qubits == 3 and abs(e - pin) < ENERGY_TOL, f"{name}: {e!r} vs {pin!r}"
        say("6 cs-vqe", system=name.split("_")[0], qubits=f"{H_taper.n_qubits}->3",
            energy=repr(e), err=f"{abs(e - pin):.2e}", wall_ms=f"{wall:.1f}")

    for name, n in sizes["cs_host"]:
        # dispatches per device run (best_of runs the flow 4 times), by side:
        # under backend "device" the small calls of the floored entries
        # (dispatch.DEVICE_FLOOR) run on the host
        before = {side: dict(c) for side, c in (("device", kernel_stats.device_calls),
                                                ("host", kernel_stats.host_calls))}
        t_dev, (H_cs, qt, H_taper) = best_of(lambda: cs_vqe_flow(name, n, True), device)
        per_run = {
            side: ",".join(f"{k}:{(v - before[side].get(k, 0)) // 4}"
                           for k, v in sorted(c.items()) if v > before[side].get(k, 0))
            for side, c in (("device", kernel_stats.device_calls),
                            ("host", kernel_stats.host_calls))}
        config.backend = "host"
        try:
            t_host, (H_host, _, _) = best_of(lambda: cs_vqe_flow(name, n, True), device)
        finally:
            config.backend = "device"
        err = compare_ops(H_cs, H_host)
        e = ground_energy(H_cs)
        fci = load_molecule(name)[2]["data"]["calculated_properties"]["FCI"]["energy"]
        say("6 cs-vqe", system=name.split("_")[0],
            qubits=f"{qt.operator.n_qubits}->{H_taper.n_qubits}->{H_cs.n_qubits}",
            terms=H_cs.n_terms, same_term_set=True, max_rel_err=f"{err:.2e}",
            energy=repr(e), fci=repr(fci), err_vs_fci=f"{e - fci:.3e}",
            device_best_ms=f"{t_dev:.1f}", host_best_ms=f"{t_host:.1f}",
            device_run_device_calls=per_run["device"], device_run_host_calls=per_run["host"])

    # no reference state: the brute force over every symmetry generator
    _, qt, H_taper = cs_vqe_flow(sizes["cs_noref"], 3, with_aux=False)
    before = cuda.launches["brute_force_minimise"]
    t0 = time.perf_counter()
    cs = ContextualSubspace(H_taper, noncontextual_strategy="SingleSweep_magnitude")
    sync(device)
    wall = (time.perf_counter() - t0) * 1e3
    searches = cuda.launches["brute_force_minimise"] - before
    config.backend = "host"
    try:
        e_host = ContextualSubspace(
            H_taper, noncontextual_strategy="SingleSweep_magnitude").noncontextual_operator.energy
    finally:
        config.backend = "device"
    nc = cs.noncontextual_operator
    e_dev = nc.energy
    assert searches >= 1, "the no-reference solve did not run the brute-force kernel"
    assert abs(e_dev - e_host) <= COEFF_RTOL * abs(e_host), (e_dev, e_host)
    say("6 cs-vqe", system=sizes["cs_noref"].split("_")[0], reference_state=None,
        generators=nc.symmetry_generators.n_terms, cliques=nc.n_cliques, terms=nc.n_terms,
        brute_force_launches=searches, energy=repr(e_dev), host_energy=repr(e_host),
        wall_ms=f"{wall:.1f}")

    # DeviceOperator.expval of each tapered molecule against its tapered HF state
    for name in sorted({*sizes["cs_pinned"], *(n for n, _ in sizes["cs_host"])}):
        H, hf, _ = load_molecule(name)
        qt = QubitTapering(H)
        H_taper = qt.taper_it(ref_state=hf)
        got = H_taper.to_device().expval(qt.tapered_ref_state)
        config.backend = "host"
        try:
            want = H_taper.expval(qt.tapered_ref_state)
        finally:
            config.backend = "device"
        err = rel_err(got, want)
        assert err <= COEFF_RTOL, f"{name}: DeviceOperator.expval {got!r} vs {want!r}"
        say("6 cs-vqe", system=name.split("_")[0], device_expval=repr(got.real),
            host_expval=repr(want.real), rel_err=f"{err:.2e}")


# -- phase 7: the eigensolvers -----------------------------------------------

def grouped_inputs(name, tapered):
    """(operator, ux, gidx, z_int, phase_c) of a molecule's X-grouped form."""
    from symmer_torch.kernels import dense

    H = tapered_molecule(name)[0] if tapered else load_molecule(name)[0]
    return (H, *dense.group_scatter_inputs(H.x_pack, H.z_pack, H.coeff_vec, H.n_qubits))


def grouped_terms(ux, gidx, z_int, ph, device):
    """(ux, off, z, ph) on `device`: the terms sorted by group, as
    kernels/lanczos.py:prepare_operator keeps them (without its budget)."""
    import torch

    order = np.argsort(gidx, kind="stable")
    off = np.concatenate([[0], np.cumsum(np.bincount(gidx, minlength=ux.shape[0]))])
    as_t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)
    return (as_t(ux, torch.int64), as_t(off, torch.int32), as_t(z_int[order], torch.int32),
            as_t(ph[order], torch.complex128))


def matvec_bound(G: int, T: int, n: int, b: int):
    """(ms, 'bytes' or 'operations', ms of the table design, ms of the
    recomputing design): the least card time of H @ V (b columns).

    Reading the table: G 2^n complex128 entries, V read and out written
    once (ops: one complex multiply-add, 4 float64 FMAs, per group, row and
    column, far below).  Recomputing the diagonals from the T terms: a
    thread that holds 2^k rows differing in k bits adds each term's signed
    phase into one of 2^k buckets, picked by z_t's k bits (one complex add,
    2 float64 operations, per term and thread), and a k-stage
    Walsh-Hadamard transform of each group's buckets gives its D_g(r) (2k
    operations a row); then the complex multiply-add, 4 FMAs per (group,
    row, column).  The least over k of 2 T 2^n / 2^k + G 2^n (2k + 4b)
    operations; its bytes are the terms and the vectors.  Parities and
    signs are not counted.  The bound is the lesser of the two designs'
    times."""
    dim = 1 << n
    vec_bytes = 2 * 16 * b * dim
    table = max((16 * G * dim + 8 * G + vec_bytes) / HBM_BYTES_PER_S,
                4 * G * dim * b / FP64_OPS_PER_S) * 1e3
    t_rec_ops = min(2 * T * dim / (1 << k) + G * dim * (2 * k + 4 * b)
                    for k in range(n + 1)) / FP64_OPS_PER_S
    t_rec_bytes = (8 * G + 4 * (G + 1) + 20 * T + vec_bytes) / HBM_BYTES_PER_S
    recompute = max(t_rec_ops, t_rec_bytes) * 1e3
    if table <= recompute:
        return table, "bytes", table, recompute
    return recompute, ("operations" if t_rec_ops >= t_rec_bytes else "bytes"), table, recompute


def step_bound(dim: int):
    """(ms, 'bytes'): the least card time of one pass-1 step: hv, v_prev and
    v_cur read once, v_next written once (16 bytes a row each; the kernel
    also keeps w in hv between its phases, which no caller reads); its
    float64 operations (about 20 a row) take a sixteenth of that."""
    return 4 * 16 * dim / HBM_BYTES_PER_S * 1e3, "bytes"


def replay_bound(dim: int, m: int):
    """(ms, 'bytes'): the least card time of one pass-2 step with m Ritz
    vectors: hv, v_prev, v_cur and y read once, v_prev and y written once
    (16 bytes a row each); about 10 + 4 m float64 operations a row."""
    return (4 + 2 * m) * 16 * dim / HBM_BYTES_PER_S * 1e3, "bytes"


def build_bound(G: int, T: int, n: int):
    """(ms, 'bytes' or 'operations'): the least card time of the table build:
    the table written once and the T terms (gidx, z_int, phase_c) read once,
    against n complex adds (2 float64 adds) per table entry."""
    dim = 1 << n
    t_bytes = (16 * G * dim + 32 * T) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * n * G * dim / FP64_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def csr_of(ux, D):
    """torch CSR matrix (rows r, columns r ^ ux[g], values D[g, r]) of the
    X-grouped operator on D's device, columns sorted within each row."""
    import torch

    G, dim = D.shape
    rows = torch.arange(dim, device=D.device)
    cols = rows[:, None] ^ ux[None, :]
    cols, order = torch.sort(cols, dim=1)
    vals = torch.gather(D.t(), 1, order)
    crow = torch.arange(0, dim + 1, device=D.device) * G
    return torch.sparse_csr_tensor(crow, cols.reshape(-1), vals.reshape(-1), (dim, dim))


def phase_eigen_kernels(device, sizes):
    """Phase 7's kernel checks (before the counted run): K13's matvec and
    table build against their plain versions, timed."""
    import torch

    from symmer_torch.kernels import cuda, torch_lanczos

    report = {}
    as_t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)
    for name, tapered in sizes["eig_build"]:
        H, ux, gidx, z_int, ph = grouped_inputs(name, tapered)
        G, T, n = ux.shape[0], gidx.shape[0], H.n_qubits
        args = (as_t(gidx, torch.int64), as_t(z_int, torch.int64), as_t(ph, torch.complex128))
        got = cuda.build_group_diagonals(*args, G, n)
        again = cuda.build_group_diagonals(*args, G, n)
        want = torch_lanczos.build_group_diagonals(*args, G, n)
        sync(device)
        bits = lambda t: torch.view_as_real(t).view(torch.int64)
        assert torch.equal(bits(got), bits(want)), f"build_group_diagonals differs at {name}"
        assert torch.equal(bits(got), bits(again)), f"build_group_diagonals not repeatable"
        del got, again, want
        kernel = lambda: cuda.build_group_diagonals(*args, G, n)
        t_cold, t_warm, spread = cold_warm(kernel, device, 10)
        t_p = device_ms(lambda: torch_lanczos.build_group_diagonals(*args, G, n), device, reps=1)
        bound, bound_by = build_bound(G, T, n)
        label = f"{'tapered_' if tapered else ''}{name.split('_')[0]}_{G}x2^{n}_{T}terms"
        say("7 eigensolvers", kernel="build_group_diagonals", shape=label, bitwise_equal=True,
            table_mb=f"{16 * G * (1 << n) / 1e6:.1f}", ms_l2_cold=f"{t_cold:.5f}",
            ms_l2_cold_range=spread, ms_l2_warm=f"{t_warm:.5f}", plain_ms=f"{t_p:.5f}",
            bound_ms=f"{bound:.5f}", bound_by=bound_by, share_cold=f"{bound / t_cold:.5f}",
            share_warm=f"{bound / t_warm:.5f}", library_ms="null (no single torch call)")
        if "build_group_diagonals" not in report:
            report["build_group_diagonals"] = dict(
                max_abs_err=0.0, ms=t_cold, ms_l2_warm=t_warm, plain_ms=t_p, bound_ms=bound,
                bound_by=bound_by, library_ms=None,
                library_null_reason="no single torch call computes the table", shape=label)

    rng = np.random.default_rng(7)
    dims = []
    for name, tapered, widths in sizes["eig_matvec"]:
        H, ux, gidx, z_int, ph = grouped_inputs(name, tapered)
        G, T, n = ux.shape[0], gidx.shape[0], H.n_qubits
        dims.append(n)
        terms = grouped_terms(ux, gidx, z_int, ph, device)
        D = cuda.build_group_diagonals(as_t(gidx, torch.int64), as_t(z_int, torch.int64),
                                       as_t(ph, torch.complex128), G, n)
        csr = csr_of(terms[0], D)
        del D
        for b in widths:
            V = torch.tensor(rng.normal(size=(b, 1 << n)) + 1j * rng.normal(size=(b, 1 << n)),
                             device=device)
            got = cuda.group_matvec(*terms, V)
            again = cuda.group_matvec(*terms, V)
            want = torch_lanczos.terms_matvec(*terms, V)
            sync(device)
            assert torch.equal(torch.view_as_real(got), torch.view_as_real(again)), (
                f"group_matvec not repeatable at {name}")
            err = float((got - want).abs().max() / torch.linalg.vector_norm(want))
            assert err <= 1e-13, f"group_matvec differs at {name} b={b}: {err:.2e}"
            kernel = lambda: cuda.group_matvec(*terms, V)
            t_cold, t_warm, spread = cold_warm(kernel, device, 20)
            t_p = device_ms(lambda: torch_lanczos.terms_matvec(*terms, V), device, reps=1)
            Vt = V.t().contiguous()
            lib = csr @ Vt
            sync(device)
            lib_err = float((lib.t() - got).abs().max() / torch.linalg.vector_norm(want))
            assert lib_err <= 1e-13, f"CSR yardstick differs at {name}: {lib_err:.2e}"
            t_lib = launch_ms(lambda: csr @ Vt, device, cold=True)
            # the same launches (grid, slices) for one group of one term:
            # what a matvec of these rows costs before its term loop
            one = (terms[0][:1], torch.tensor([0, 1], dtype=torch.int32, device=device),
                   terms[2][:1], terms[3][:1])
            t_fixed = launch_ms(lambda: cuda.group_matvec(*one, V), device, cold=True)
            bound, bound_by, t_table, t_rec = matvec_bound(G, T, n, b)
            label = f"{'tapered_' if tapered else ''}{name.split('_')[0]}_{G}x2^{n}_b{b}"
            say("7 eigensolvers", kernel="group_matvec", shape=label, rel_err=f"{err:.2e}",
                terms=T, ms_l2_cold=f"{t_cold:.5f}", ms_l2_cold_range=spread,
                ms_l2_warm=f"{t_warm:.5f}", plain_ms=f"{t_p:.5f}", bound_ms=f"{bound:.5f}",
                bound_by=bound_by, bound_table_ms=f"{t_table:.5f}",
                bound_recompute_ms=f"{t_rec:.5f}", share_cold=f"{bound / t_cold:.5f}",
                share_warm=f"{bound / t_warm:.5f}", library_ms=f"{t_lib:.5f}",
                library_rel_err=f"{lib_err:.2e}", slices=cuda._matvec_slices(1 << n, b),
                one_term_ms_l2_cold=f"{t_fixed:.5f}")
            if "group_matvec" not in report:
                report["group_matvec"] = dict(
                    max_abs_err=float((got - want).abs().max()), ms=t_cold, ms_l2_warm=t_warm,
                    plain_ms=t_p, bound_ms=bound, bound_by=bound_by, library_ms=t_lib,
                    library="torch CSR @ dense (cuSPARSE) on the table, never called by the port",
                    bound_table_ms=t_table, bound_recompute_ms=t_rec, shape=label)
            del got, again, want, V
        del csr, terms
        torch.cuda.empty_cache()

    # the scalar step at the matvec shapes' row counts: pass 1 (the JSON
    # line's time) and pass 2, each bit for bit its plain version
    bits = lambda t: torch.view_as_real(t).view(torch.int64) if t.is_complex() else t.view(torch.int64)
    for n in sorted(set(dims), key=dims.index):
        dim = 1 << n
        vec = lambda: torch.tensor(rng.normal(size=dim) + 1j * rng.normal(size=dim), device=device)
        ops = (vec(), vec(), vec(), torch.zeros(8, dtype=torch.float64, device=device),
               torch.tensor(rng.random(8) + 0.5, device=device))
        S = torch.tensor(rng.normal(size=(8, 1)), device=device)
        y0 = torch.zeros((1, dim), dtype=torch.complex128, device=device)
        outs = {}
        for key, fn in (("kernel", cuda.lanczos_step), ("again", cuda.lanczos_step),
                        ("plain", torch_lanczos.lanczos_step)):
            args = tuple(t.clone() for t in ops)
            fn(*args, 3)
            outs[key] = args
        for key, fn in (("replay", cuda.lanczos_replay), ("replay_plain", torch_lanczos.lanczos_replay)):
            args = tuple(t.clone() for t in ops[:3]) + outs["kernel"][3:]
            y = y0.clone()
            fn(*args, 3, S, y)
            outs[key] = (*args, y)
        sync(device)
        for key in ("again", "plain"):
            assert all(torch.equal(bits(a), bits(b)) for a, b in zip(outs["kernel"], outs[key])), (
                f"lanczos_step differs from {key} at 2^{n}")
        assert all(torch.equal(bits(a), bits(b)) for a, b in zip(outs["replay"], outs["replay_plain"])), (
            f"lanczos_replay differs from its plain version at 2^{n}")
        assert torch.equal(bits(outs["replay"][1]), bits(outs["kernel"][1])), (
            f"pass 2 does not rebuild pass 1's vector at 2^{n}")
        work = tuple(t.clone() for t in ops)
        y = y0.clone()
        label = f"2^{n}_rows"
        for key, kernel, plain, (bound, bound_by) in (
                ("lanczos_step", lambda: cuda.lanczos_step(*work, 3),
                 lambda: torch_lanczos.lanczos_step(*work, 3), step_bound(dim)),
                ("lanczos_replay", lambda: cuda.lanczos_replay(*work, 3, S, y),
                 lambda: torch_lanczos.lanczos_replay(*work, 3, S, y), replay_bound(dim, 1))):
            t_cold, t_warm, spread = cold_warm(kernel, device, 20)
            t_p = device_ms(plain, device, reps=3)
            say("7 eigensolvers", kernel=key, shape=label, bitwise_equal=True,
                ms_l2_cold=f"{t_cold:.5f}", ms_l2_cold_range=spread, ms_l2_warm=f"{t_warm:.5f}",
                plain_ms=f"{t_p:.5f}", bound_ms=f"{bound:.5f}", bound_by=bound_by,
                share_cold=f"{bound / t_cold:.5f}", share_warm=f"{bound / t_warm:.5f}",
                library_ms="null (no single torch call)")
            if key not in report:
                report[key] = dict(
                    max_abs_err=0.0, ms=t_cold, ms_l2_warm=t_warm, plain_ms=t_p,
                    bound_ms=bound, bound_by=bound_by, library_ms=None,
                    library_null_reason="no single torch call computes a Lanczos step",
                    shape=label)
        del outs, work, ops

    # the scalar driver's loops at tapered N2 (both passes, no state built),
    # and the host time of one call of each wrapper (enqueued, not waited on)
    from symmer_torch.kernels import lanczos

    H = tapered_molecule(sizes["eig_gs"])[0]
    planes = (H.x_pack, H.z_pack, H.coeff_vec, H.n_qubits)
    prep = lanczos.prepare_operator(*planes)
    s0 = cuda.launches["lanczos_step"] + cuda.launches["lanczos_replay"]
    t_loop, _ = best_of(lambda: lanczos.lanczos_ground_state(*planes, prepared=prep), device)
    steps = (cuda.launches["lanczos_step"] + cuda.launches["lanczos_replay"] - s0) // 4
    dim = 1 << H.n_qubits
    V = torch.tensor(rng.normal(size=(1, dim)) + 0j, device=device)
    out = torch.empty_like(V)
    vecs = [V[0].clone() for _ in range(3)]
    scal = (torch.zeros(8, dtype=torch.float64, device=device),
            torch.ones(8, dtype=torch.float64, device=device))
    host = {"group_matvec": lambda: cuda.group_matvec(prep.ux, prep.off, prep.z, prep.ph, V, out=out),
            "lanczos_step": lambda: cuda.lanczos_step(*vecs, *scal, 3)}
    host_us = {}
    for k, fn in host.items():
        fn()
        sync(device)
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        host_us[k] = (time.perf_counter() - t0) / 200 * 1e6
        sync(device)
    say("7 eigensolvers", driver="lanczos_ground_state", system=f"tapered_N2_{H.n_qubits}q",
        steps_per_run=steps, best_ms=f"{t_loop:.1f}", ms_per_step=f"{t_loop / max(1, steps):.4f}",
        host_us_per_matvec_call=f"{host_us['group_matvec']:.1f}",
        host_us_per_step_call=f"{host_us['lanczos_step']:.1f}")
    return report


def host_energies(H, k):
    """The k lowest eigenvalues of H by scipy eigsh on its host CSR matrix."""
    from scipy.sparse.linalg import eigsh

    return np.sort(eigsh(H.to_sparse_matrix, k=k, which="SA")[0])


def host_expval(H, psi) -> float:
    """<psi|H|psi> / <psi|psi> with the host CSR matrix."""
    v = psi.to_sparse_matrix.toarray().reshape(-1)
    return float(np.real(np.vdot(v, H.to_sparse_matrix @ v)) / np.real(np.vdot(v, v)))


def phase_eigensolvers(device, sizes, config):
    """Phase 7, counted: the eigensolvers and QubitSubspaceManager on the card."""
    from symmer_torch import PauliwordOp, QubitSubspaceManager
    from symmer_torch import utils as tutils
    from symmer_torch.kernels import cuda
    from symmer_torch.profiling import kernel_stats
    from symmer_torch.utils import (exact_gs_energy, exact_gs_energy_device,
                                    exact_lowest_states_device)

    # tapered N2: the Lanczos ground state against the host eigensolver
    name = sizes["eig_gs"]
    H, _ = tapered_molecule(name)
    fci = load_molecule(name)[2]["data"]["calculated_properties"]["FCI"]["energy"]
    keys = ("group_matvec", "lanczos_step", "lanczos_replay")
    m0, s0, r0 = (cuda.launches.get(k, 0) for k in keys)
    t_dev, (e_dev, psi) = best_of(lambda: exact_gs_energy_device(H), device)
    per_run = (cuda.launches.get("group_matvec", 0) - m0) // 4
    steps_per_run = (cuda.launches.get("lanczos_step", 0) - s0) // 4
    replays_per_run = (cuda.launches.get("lanczos_replay", 0) - r0) // 4
    t0 = time.perf_counter()
    e_host = float(exact_gs_energy(H.matrix_free_linear_operator())[0])
    t_host = (time.perf_counter() - t0) * 1e3
    e_psi = host_expval(H, psi)
    assert abs(e_dev - e_host) <= 1e-10, f"{name}: {e_dev!r} vs host {e_host!r}"
    assert abs(e_psi - e_dev) <= 1e-10, f"{name}: <psi|H|psi> {e_psi!r} vs {e_dev!r}"
    say("7 eigensolvers", flow="exact_gs_energy_device",
        system=f"tapered_{name.split('_')[0]}_{H.n_qubits}q",
        terms=H.n_terms, energy=repr(float(e_dev)), host_energy=repr(e_host),
        err_vs_host=f"{abs(e_dev - e_host):.2e}", expval_err=f"{abs(e_psi - e_dev):.2e}",
        err_vs_fci=f"{e_dev - fci:.3e}", matvec_launches_per_run=per_run,
        step_launches_per_run=steps_per_run, replay_launches_per_run=replays_per_run,
        device_best_ms=f"{t_dev:.1f}",
        ms_per_step=f"{t_dev / max(1, steps_per_run + replays_per_run):.4f}",
        host_eigsh_ms=f"{t_host:.1f}")

    # the lowest states with multiplicity: H2O's four by the default method
    # (deflated restarts); CH2's triplet ground pair by the band recurrence,
    # which must finish by itself (no deflated sweeps)
    for name, k, method in sizes["eig_lowest"]:
        H = load_molecule(name)[0]
        want = host_energies(H, k)
        calls0 = dict(kernel_stats.device_calls)
        t_dev, (evals, states) = best_of(lambda: exact_lowest_states_device(H, k, method=method),
                                         device, n=1)
        per_run = {f: (kernel_stats.device_calls[f] - calls0.get(f, 0)) // 2
                   for f in ("lanczos_block_eigsh", "lanczos_ground_state")}
        if method == "block":
            assert per_run["lanczos_ground_state"] == 0, (
                f"{name}: the block method fell back to deflated sweeps")
        else:
            assert per_run["lanczos_block_eigsh"] == 0, f"{name}: '{method}' ran the band driver"
        err = float(np.abs(np.asarray(evals) - want).max())
        assert len(states) == k and err <= 1e-9, f"{name} {method}: {evals!r} vs {want!r}"
        st_err = max(abs(host_expval(H, s) - e) for s, e in zip(states, evals))
        assert st_err <= 1e-8, f"{name} {method}: a state's energy is off by {st_err:.2e}"
        say("7 eigensolvers", flow="exact_lowest_states_device", method=method,
            system=f"{name.split('_')[0]}_{H.n_qubits}q", energies=",".join(repr(float(e)) for e in evals),
            host_eigsh=",".join(repr(float(e)) for e in want), max_err=f"{err:.2e}",
            state_expval_err=f"{st_err:.2e}",
            band_passes_per_run=per_run["lanczos_block_eigsh"],
            deflated_sweeps_per_run=per_run["lanczos_ground_state"],
            device_best_ms=f"{t_dev:.1f}")

    # CH2 (triplet): the particle-number sweep on a degenerate multiplet
    name, n_particles = sizes["eig_particles"]
    H, _, data = load_molecule(name)
    fci = data["data"]["calculated_properties"]["FCI"]["energy"]
    nq = H.n_qubits
    N = PauliwordOp.from_dictionary(
        {"I" * nq: nq / 2, **{"I" * i + "Z" + "I" * (nq - i - 1): -0.5 for i in range(nq)}})
    t0 = time.perf_counter()
    e, psi = exact_gs_energy_device(H, n_particles=n_particles, number_operator=N)
    sync(device)
    wall = (time.perf_counter() - t0) * 1e3
    assert abs(e - fci) <= 1e-8, f"{name}: {e!r} vs FCI {fci!r}"
    n_exp = host_expval(N, psi)
    say("7 eigensolvers", flow="exact_gs_energy_device(n_particles)", system=f"{name.split('_')[0]}_{nq}q",
        n_particles=n_particles, energy=repr(float(e)), fci=repr(fci),
        err_vs_fci=f"{e - fci:.2e}", number_expval=f"{n_exp:.10f}", wall_ms=f"{wall:.1f}")

    # QubitSubspaceManager without a reference state: the Lanczos route
    name, n_red = sizes["eig_qsm"]
    H, _, data = load_molecule(name)
    fci = data["data"]["calculated_properties"]["FCI"]["energy"]
    found = []
    real_gs = tutils.exact_gs_energy_device

    def spy(op, *a, **kw):
        out = real_gs(op, *a, **kw)
        found.append(out)
        return out

    def flow():
        found.clear()
        qsm = QubitSubspaceManager(H)
        return qsm, qsm.get_reduced_hamiltonian(n_red)

    import warnings

    tutils.exact_gs_energy_device = spy
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            m0, s0, r0 = (cuda.launches.get(k, 0) for k in ("group_matvec", "lanczos_step",
                                                     "lanczos_replay"))
            t0 = time.perf_counter()
            qsm, red = flow()
            sync(device)
            t_card = (time.perf_counter() - t0) * 1e3
            launched = cuda.launches.get("group_matvec", 0) - m0
            steps = cuda.launches.get("lanczos_step", 0) - s0
            replays = cuda.launches.get("lanczos_replay", 0) - r0
            assert found and launched > 0, "QubitSubspaceManager did not take the Lanczos route"
            e_lanczos = float(found[0][0])
            psi_card = found[0][1]
            # the same flow with the plain versions on this machine's CPU
            dev_before = config.device
            ok = QubitSubspaceManager._device_lanczos_ok
            config.device = "cpu"
            QubitSubspaceManager._device_lanczos_ok = staticmethod(lambda: True)
            try:
                t0 = time.perf_counter()
                qsm_cpu, red_cpu = flow()
                t_cpu = (time.perf_counter() - t0) * 1e3
            finally:
                config.device = dev_before
                QubitSubspaceManager._device_lanczos_ok = ok
    finally:
        tutils.exact_gs_energy_device = real_gs
    psi_cpu = found[0][1]
    va = psi_card.to_sparse_matrix.toarray().reshape(-1)
    vb = psi_cpu.to_sparse_matrix.toarray().reshape(-1)
    phase = np.vdot(vb, va) / abs(np.vdot(vb, va))
    state_diff = float(np.abs(va - phase * vb).max())
    # amplitudes near the 1e-4 cleanup that the two reference states may keep differently
    near = int(np.sum(np.abs(np.abs(va) - 1e-4) < 1e-9))
    assert abs(e_lanczos - fci) <= 1e-10, f"{name} reference {e_lanczos!r} vs FCI {fci!r}"
    err = compare_ops(red, red_cpu)
    e_red = ground_energy(red)
    say("7 eigensolvers", flow="QubitSubspaceManager",
        system=f"{name.split('_')[0]}_{H.n_qubits}q",
        reference="lanczos", matvec_launches=launched, step_launches=steps,
        replay_launches=replays,
        lanczos_energy=repr(e_lanczos),
        err_vs_fci=f"{e_lanczos - fci:.2e}", ref_terms=qsm.ref_state.n_terms,
        ref_terms_cpu=qsm_cpu.ref_state.n_terms, ref_state_diff_up_to_phase=f"{state_diff:.2e}",
        amplitudes_near_cleanup=near,
        reduced=f"{red.n_qubits}q_{red.n_terms}terms", same_as_cpu_device=True,
        max_rel_err=f"{err:.2e}", reduced_ground=repr(e_red),
        reduced_err_vs_fci=f"{e_red - fci:.3e}", card_wall_ms=f"{t_card:.1f}",
        cpu_device_wall_ms=f"{t_cpu:.1f}")


# -- phase 9: the evolution slice --------------------------------------------

def larger(t_bytes: float, t_ops: float):
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rotate_bound(dim: int, P: int = 1):
    """(ms, 'bytes' or 'operations'): P rotations read the state once and
    write it once (32 bytes a row, the P angles' 16 bytes each), against 4
    float64 operations a row and rotation at the FMA rate (c p - s g for
    each component: one multiply and one FMA; ph in {+-1, +-i} makes g a
    swap and a sign of q, which costs none)."""
    return larger((32 * dim + 16 * P) / HBM_BYTES_PER_S * 1e3,
                  4 * P * dim / FP64_OPS_PER_S * 1e3)


def sweep_bound(dim: int, P: int):
    """(ms, 'bytes' or 'operations'): the adjoint sweep reads psi and lam
    once (32 bytes a row) and writes the P overlaps, against, counted as
    rotate_bound counts them, 4 FMAs a row for each overlap and 4
    operations a row for each of the two un-rotations of P - 1 steps."""
    return larger((32 * dim + 32 * P) / HBM_BYTES_PER_S * 1e3,
                  (4 * P + 8 * (P - 1)) * dim / FP64_OPS_PER_S * 1e3)


def overlaps_bound(dim: int, N: int, G: int):
    """(ms, 'bytes' or 'operations'): a and b read once, the N Paulis read
    and the N results written once, against the least float64 work of the
    N overlaps in G X groups: 4 FMAs a row and group for w = conj(a) b[r ^
    x], and 2 adds a row and Pauli for the signed sums (the sign a
    negation, ph applied once a Pauli)."""
    return larger((32 * dim + 48 * N) / HBM_BYTES_PER_S * 1e3,
                  (4 * G + 2 * N) * dim / FP64_OPS_PER_S * 1e3)


def rref_bound(R: int, W: int, rank: int):
    """(ms, 'bytes' or 'operations'): M read once and written once (16 R W
    bytes), against one 64-bit AND (two 32-bit logic ops) a row and pivot,
    the test of each row for the pivot bit; the XORs, which depend on the
    rows that hold each pivot bit, are not counted."""
    t_bytes = 16 * R * W / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * rank * R / LOP3_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tapered_with_uccsd(name):
    """(tapered operator, tapered UCCSD operator, normalised tapered HF
    state, data) of a molecule, tapered on the host."""
    from symmer_torch import PauliwordOp, QubitTapering, config

    H, hf, data = load_molecule(name)
    backend, config.backend = config.backend, "host"
    try:
        qt = QubitTapering(H)
        Ht = qt.taper_it(ref_state=hf)
        cc = qt.taper_it(aux_operator=PauliwordOp.from_dictionary(
            data["data"]["auxiliary_operators"]["UCCSD_operator"]))
        return Ht, cc, qt.tapered_ref_state.normalize, data
    finally:
        config.backend = backend


def rref_stack(entry):
    """(label, uint64[R, W]) for K11: rows of the 1000-qubit flagship's joint
    planes (bench.py:647-664 generator, W = 32) or tapered N2's."""
    from symmer_torch.kernels import pack

    what, R = entry
    if what == "flagship":
        op = synthetic_taper_operator(1000, R, 4, 1)
        label = f"flagship_{op.n_terms}x32"
    else:
        op = tapered_molecule(what)[0]
        label = f"tapered_{what.split('_')[0]}_{op.n_terms}terms"
    M = pack.hstack_words(op.x_pack, op.z_pack)
    return f"{label}_W{M.shape[1]}", M


def phase_evolution_kernels(device, sizes):
    """Phase 9's kernel checks (before the counted run): K15a, K15c and K11
    against their plain versions, timed, with K11's host crossover."""
    import torch

    from symmer_torch.kernels import cuda, torch_gf2, torch_vqe
    from symmer_torch.native import gf2core

    report, single, t_phase = {}, {}, time.perf_counter()
    bits = lambda t: torch.view_as_real(t).view(torch.int64)
    rng = np.random.default_rng(19)

    def state(n):
        v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
        return torch.tensor(v / np.linalg.norm(v), device=device)

    # the single rotation (the one-generator case of the runs' entry point)
    for n in sizes["evo_rotate"]:
        dim = 1 << n
        psi, out = state(n), torch.empty(dim, dtype=torch.complex128, device=device)
        t = float(rng.normal())
        args = (int(rng.integers(dim)), int(rng.integers(dim)), 0.0, -1.0, np.cos(t), np.sin(t))
        got, again = cuda.vqe_rotate(psi, *args), cuda.vqe_rotate(psi, *args)
        want = torch_vqe.rotate(psi, *args)
        sync(device)
        assert torch.equal(bits(got), bits(want)), f"vqe_rotate differs from its plain version at 2^{n}"
        assert torch.equal(bits(got), bits(again)), f"vqe_rotate not repeatable at 2^{n}"
        plan = torch_vqe.plan_runs([args[0]], [args[1]], [complex(args[2], args[3])], n).on(device)
        cs = torch.tensor([[args[4], args[5]]], device=device)
        t_cold, t_warm, spread = cold_warm(lambda: cuda.vqe_runs(psi, plan, cs, out=out), device, 20)
        t_p = device_ms(lambda: torch_vqe.rotate(psi, *args), device, reps=3)
        bound, bound_by = rotate_bound(dim)
        say("9 evolution", kernel="vqe_rotate", shape=f"one_rotation_2^{n}_rows", bitwise_equal=True,
            ms_l2_cold=f"{t_cold:.5f}", ms_l2_cold_range=spread, ms_l2_warm=f"{t_warm:.5f}",
            plain_ms=f"{t_p:.5f}", bound_ms=f"{bound:.5f}", bound_by=bound_by,
            share_cold=f"{bound / t_cold:.5f}", share_warm=f"{bound / t_warm:.5f}",
            library_ms="null (no single torch call)")
        single[n] = t_cold
        del psi, out, got, again, want

    # the fused forward and the adjoint sweep at the VQE flow's shape
    from symmer_torch.evolution import device_vqe

    name = sizes["evo_vqe"]
    H, cc, _, _ = tapered_with_uccsd(name)
    gx, gz, gph = device_vqe.term_arrays(cc)
    keep = (gx != 0) | (gz != 0)  # VQE_Driver's generators: the non-identity terms
    gx, gz, gph = gx[keep], gz[keep], gph[keep]
    n, P = H.n_qubits, gx.shape[0]
    dim = 1 << n
    plan = torch_vqe.plan_runs(gx, gz, gph, n)
    dplan = plan.on(device)
    t = 0.05 * rng.normal(size=P)
    cs = torch.tensor(np.stack([np.cos(t), np.sin(t)], 1), device=device)
    psi, lam = state(n), state(n)
    label = f"tapered_{name.split('_')[0]}_{P}gens_2^{n}_rows_{plan.n_runs}runs_d{plan.tile_bits}"
    got, again = cuda.vqe_runs(psi, dplan, cs), cuda.vqe_runs(psi, dplan, cs)
    ov, ov_again = (cuda.vqe_adjoint(psi.clone(), lam.clone(), dplan, cs) for _ in range(2))
    sync(device)
    t0 = time.perf_counter()
    want = torch_vqe.rotate_runs(psi, plan, cs)
    sync(device)
    fwd_plain = (time.perf_counter() - t0) * 1e3
    seq = psi
    for k in range(P):
        seq = torch_vqe.rotate(seq, int(gx[k]), int(gz[k]), gph[k].real, gph[k].imag,
                               np.cos(t[k]), np.sin(t[k]))
    t0 = time.perf_counter()
    ov_want = torch_vqe.adjoint_sweep(psi, lam, plan, cs)
    sync(device)
    sweep_plain = (time.perf_counter() - t0) * 1e3
    assert torch.equal(bits(got), bits(want)), f"vqe_runs differs from its plain version at {label}"
    assert torch.equal(bits(got), bits(seq)), f"vqe_runs differs from {P} sequential rotations"
    assert torch.equal(bits(got), bits(again)), f"vqe_runs not repeatable at {label}"
    assert torch.equal(bits(ov), bits(ov_want)), f"vqe_adjoint differs from its plain version at {label}"
    assert torch.equal(bits(ov), bits(ov_again)), f"vqe_adjoint not repeatable at {label}"
    out = torch.empty_like(psi)
    times = (cold_warm(lambda: cuda.vqe_runs(psi, dplan, cs, out=out), device, 20),
             # in place on scratch copies: unitary, the values stay bounded
             cold_warm(lambda: cuda.vqe_adjoint(got, again, dplan, cs), device, 20))
    for kernel, (t_cold, t_warm, spread), bound_fn, t_p in (
            ("vqe_rotate", times[0], rotate_bound, fwd_plain),
            ("vqe_adjoint", times[1], sweep_bound, sweep_plain)):
        bound, bound_by = bound_fn(dim, P)
        say("9 evolution", kernel=kernel, shape=label, bitwise_equal=True,
            ms_l2_cold=f"{t_cold:.5f}", ms_l2_cold_range=spread, ms_l2_warm=f"{t_warm:.5f}",
            plain_ms=f"{t_p:.5f}", bound_ms=f"{bound:.5f}", bound_by=bound_by,
            share_cold=f"{bound / t_cold:.5f}", share_warm=f"{bound / t_warm:.5f}",
            library_ms="null (no single torch call)")
        report[kernel] = dict(
            max_abs_err=0.0, ms=t_cold, ms_l2_warm=t_warm, plain_ms=t_p, bound_ms=bound,
            bound_by=bound_by, library_ms=None,
            library_null_reason="no single torch call applies a run of Pauli rotations"
            if kernel == "vqe_rotate" else "no single torch call runs an adjoint sweep",
            shape=label)
    report["vqe_rotate"].update({f"one_rotation_2^{k}_ms": v for k, v in single.items()})
    del psi, lam, got, again, want, seq, out

    for entry in sizes["evo_overlaps"]:
        if entry[1] == "pool":  # tapered N2's UCCSD pool against its 2^15 state
            H, pool, _, _ = tapered_with_uccsd(entry[0])
            n, (px, pz, pph) = H.n_qubits, device_vqe.term_arrays(pool)
            N = px.shape[0]
            label = f"tapered_{entry[0].split('_')[0]}_pool_{N}x2^{n}"
        else:
            n, N = entry
            px, pz = rng.integers(0, 1 << n, size=N), rng.integers(0, 1 << n, size=N)
            pph = np.array([1, -1j, -1, 1j])[rng.integers(0, 4, size=N)]
            label = f"{N}x2^{n}"
        a, b = state(n), state(n)
        xs, zs = torch.tensor(px, device=device), torch.tensor(pz, device=device)
        ph = torch.tensor(np.stack([pph.real, pph.imag], axis=1), device=device)
        groups = cuda.overlap_groups(px, 1 << n, device)
        G = groups[0].shape[0]
        label += f"_{G}groups"
        got = cuda.pauli_overlaps(a, b, xs, zs, ph, groups=groups)
        again = cuda.pauli_overlaps(a, b, xs, zs, ph, groups=groups)
        want = torch_vqe.pauli_overlaps(a, b, xs, zs, ph)
        sync(device)
        assert torch.equal(bits(got), bits(want)), f"pauli_overlaps differs from its plain version at {label}"
        assert torch.equal(bits(got), bits(again)), f"pauli_overlaps not repeatable at {label}"
        out = torch.empty_like(got)
        t_cold, t_warm, spread = cold_warm(
            lambda: cuda.pauli_overlaps(a, b, xs, zs, ph, out=out, groups=groups), device, 20)
        t_p = device_ms(lambda: torch_vqe.pauli_overlaps(a, b, xs, zs, ph), device, reps=3)
        bound, bound_by = overlaps_bound(1 << n, N, G)
        say("9 evolution", kernel="pauli_overlaps", shape=label, bitwise_equal=True,
            ms_l2_cold=f"{t_cold:.5f}", ms_l2_cold_range=spread, ms_l2_warm=f"{t_warm:.5f}",
            plain_ms=f"{t_p:.5f}", bound_ms=f"{bound:.5f}", bound_by=bound_by,
            share_cold=f"{bound / t_cold:.5f}", share_warm=f"{bound / t_warm:.5f}",
            library_ms="null (no single torch call)")
        report.setdefault("pauli_overlaps", dict(
            max_abs_err=0.0, ms=t_cold, ms_l2_warm=t_warm, plain_ms=t_p, bound_ms=bound,
            bound_by=bound_by, library_ms=None,
            library_null_reason="no single torch call computes <a|P|b> for a signed permutation P",
            shape=label))
        del a, b, got, again, want

    crossover = []
    for entry in sizes["evo_rref"]:
        label, M = rref_stack(entry)
        R, W = M.shape
        host = M.copy()
        t0 = time.perf_counter()
        gf2core.rref_inplace(host)
        t_host = (time.perf_counter() - t0) * 1e3
        rank = int(host.any(axis=1).sum())
        M0 = torch.tensor(M.view(np.int64), device=device)
        got = cuda.gf2_rref(M0.clone())
        again = cuda.gf2_rref(M0.clone())
        want = torch_gf2.rref(M0.clone())
        sync(device)
        assert torch.equal(got, want), f"gf2_rref differs from its plain version at {label}"
        assert torch.equal(got, again), f"gf2_rref not repeatable at {label}"
        assert np.array_equal(got.cpu().numpy().view(np.uint64), host), f"gf2_rref differs from gf2core at {label}"
        reps = 20 if R * W < (1 << 20) else 5
        copies = iter([M0.clone() for _ in range(2 * reps + 2)])
        t_cold, t_warm, spread = cold_warm(lambda: cuda.gf2_rref(next(copies)), device, reps)
        del copies
        t_p = device_ms(lambda: torch_gf2.rref(M0.clone()), device, reps=1)
        # the wrapper's route from host planes: upload, kernel, download
        t0 = time.perf_counter()
        cuda.gf2_rref(torch.from_numpy(M.view(np.int64)).to(device)).cpu()
        t_route = (time.perf_counter() - t0) * 1e3
        bound, bound_by = rref_bound(R, W, rank)
        crossover.append((label, t_route, t_host))
        say("9 evolution", kernel="gf2_rref", shape=label, rank=rank, bitwise_equal=True,
            ms_l2_cold=f"{t_cold:.5f}", ms_l2_cold_range=spread, ms_l2_warm=f"{t_warm:.5f}",
            plain_ms=f"{t_p:.5f}", bound_ms=f"{bound:.5f}", bound_by=bound_by,
            share_cold=f"{bound / t_cold:.5f}", host_gf2core_ms=f"{t_host:.3f}",
            card_route_with_copies_ms=f"{t_route:.3f}", library_ms="null (no single torch call)")
        if label.startswith(f"flagship_{sizes['evo_generators']}x"):
            report["gf2_rref"] = dict(
                max_abs_err=0.0, ms=t_cold, ms_l2_warm=t_warm, plain_ms=t_p, bound_ms=bound,
                bound_by=bound_by, library_ms=None,
                library_null_reason="no single torch call row-reduces over GF(2)",
                host_gf2core_ms=t_host, shape=label)
        del M0, got, again, want
        torch.cuda.empty_cache()
    say("9 evolution", k11_crossover=";".join(
        f"{l}:card_route_{c:.3f}ms_host_{h:.3f}ms" for l, c, h in crossover),
        kernel_checks_wall_s=f"{time.perf_counter() - t_phase:.1f}")
    return report


def counted(fn):
    """(fn(), (launches, wrapper calls)): what fn() launched, by kernel, as
    'key:count' lists."""
    from symmer_torch.kernels import cuda

    l0, c0 = dict(cuda.launches), dict(cuda.calls)
    out = fn()
    fmt = lambda now, was: ",".join(f"{k}:{now[k] - was[k]}" for k in now if now[k] > was[k])
    return out, (fmt(cuda.launches, l0), fmt(cuda.calls, c0))


def phase_evolution(device, sizes, config):
    """Phase 9, counted: VQE at tapered MgH2, ADAPT at tapered N2, the CLI,
    CircuitSymmerlator at the BASELINE Clifford shape and the generators of
    a flagship operator, on the card."""
    import torch

    from symmer_torch import PauliwordOp
    from symmer_torch.evolution import ADAPT_VQE, CircuitSymmerlator, VQE_Driver, device_vqe
    from symmer_torch.kernels import dense, lanczos, torch_vqe

    walls, t_phase = {}, time.perf_counter()
    # VQE at tapered MgH2: the non-identity terms of the tapered UCCSD operator
    name = sizes["evo_vqe"]
    H, cc, ref, data = tapered_with_uccsd(name)
    n = H.n_qubits
    drv = VQE_Driver(H, excitation_ops=cc, ref_state=ref)
    drv.verbose = False
    drv.expectation_eval = "device_array"
    P = drv.n_params
    x = 0.05 * np.random.default_rng(23).normal(size=P)
    e = drv.f(x)  # builds the engine
    t0 = time.perf_counter()
    e, per_f = counted(lambda: drv.f(x))
    walls["vqe_f"] = (time.perf_counter() - t0) * 1e3
    # the process's first gradient (as earlier slices timed it), then a warm one
    t0 = time.perf_counter()
    g = drv.gradient(x)
    walls["vqe_first_gradient"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    g, per_g = counted(lambda: drv.gradient(x))
    walls["vqe_gradient"] = (time.perf_counter() - t0) * 1e3
    eng = drv._device_engine()
    # the plain route on the card, its gradient by torch.autograd
    as_t = lambda a: torch.as_tensor(a, device=device)
    gx, gz, gph = (as_t(a) for a in device_vqe.term_arrays(drv.excitation_generators))
    hx, hz, hph = (as_t(a) for a in device_vqe.term_arrays(H))
    xt = torch.tensor(x, device=device, requires_grad=True)
    t0 = time.perf_counter()
    e_plain = torch_vqe.energy(xt, eng._psi0, gx, gz, gph, hx, hz, hph)
    e_plain.backward()
    g_plain = xt.grad.cpu().numpy()
    walls["vqe_plain_f_and_autograd"] = (time.perf_counter() - t0) * 1e3
    e_plain = float(e_plain.detach())
    del xt
    torch.cuda.empty_cache()
    # the host energy of the downloaded state
    psi = eng.evolve(x).cpu().numpy()
    t0 = time.perf_counter()
    e_host = float(np.vdot(psi, dense.matvec_host(H.x_pack, H.z_pack, H.coeff_vec, n, psi)).real)
    walls["host_matvec"] = (time.perf_counter() - t0) * 1e3
    # the exact parameter-shift values for three parameters
    ks = [0, P // 2, P - 1]
    shift = [drv.partial_derivative(x, k) for k in ks]
    err_plain = abs(e - e_plain)
    err_grad = float(np.abs(g - g_plain).max())
    err_host = abs(e - e_host)
    err_shift = max(abs(g[k] - s) for k, s in zip(ks, shift))
    assert err_plain <= 1e-11 and err_grad <= 1e-10, (
        f"VQE {name}: engine vs plain route {err_plain:.2e} (energy), {err_grad:.2e} (gradient)")
    assert err_host <= 1e-10, f"VQE {name}: engine {e!r} vs host {e_host!r}"
    assert err_shift <= 1e-10, f"VQE {name}: gradient vs parameter shift {err_shift:.2e}"
    # the exact ground energy: Lanczos on the card over the grouped terms
    # (prepare_operator's reference table budget refuses this size)
    ux, gidx, z_int, phc = dense.group_scatter_inputs(H.x_pack, H.z_pack, H.coeff_vec, n)
    prep = lanczos.PreparedOperator(*grouped_terms(ux, gidx, z_int, phc, device), None, n, 0)
    e0 = float(lanczos.lanczos_ground_state(H.x_pack, H.z_pack, H.coeff_vec, n, prepared=prep)[0][0])
    fci = data["data"]["calculated_properties"]["FCI"]["energy"]
    t0 = time.perf_counter()
    opt, hist = drv.run(x0=np.zeros(P), method="BFGS", options={"maxiter": 5})
    sync(device)
    walls["vqe_bfgs5"] = (time.perf_counter() - t0) * 1e3
    e_hf = hist["energy"][0]
    assert opt["fun"] >= e0 - 1e-10, f"VQE {name}: {opt['fun']!r} below the ground energy {e0!r}"
    assert opt["fun"] < e_hf, f"VQE {name}: BFGS did not lower the HF energy {e_hf!r}"
    say("9 evolution", flow="VQE_Driver(device_array)", system=f"tapered_{name.split('_')[0]}_{n}q",
        terms=H.n_terms, generators=P, energy=repr(e), plain_route_err=f"{err_plain:.2e}",
        gradient_vs_autograd_err=f"{err_grad:.2e}", host_matvec_err=f"{err_host:.2e}",
        param_shift_err=f"{err_shift:.2e}", f_ms=f"{walls['vqe_f']:.1f}",
        first_gradient_ms=f"{walls['vqe_first_gradient']:.1f}",
        gradient_ms=f"{walls['vqe_gradient']:.1f}",
        plain_f_and_autograd_ms=f"{walls['vqe_plain_f_and_autograd']:.1f}",
        host_matvec_ms=f"{walls['host_matvec']:.1f}", bfgs5_ms=f"{walls['vqe_bfgs5']:.1f}",
        launches_per_energy=per_f[0], calls_per_energy=per_f[1],
        launches_per_gradient=per_g[0], calls_per_gradient=per_g[1],
        bfgs5_energy=repr(float(opt["fun"])), hf_energy=repr(float(e_hf)),
        lanczos_ground=repr(e0), ground_err_vs_fci=f"{e0 - fci:.2e}", nfev=opt["nfev"],
        njev=opt["njev"])

    # ADAPT at tapered N2 with the tapered UCCSD pool
    name = sizes["evo_adapt"]
    H, pool, ref, data = tapered_with_uccsd(name)
    adapt = ADAPT_VQE(H, excitation_pool=pool, ref_state=ref)
    adapt.verbose = False
    adapt.derivative_eval, adapt.expectation_eval = "commutators", "device_array"
    t0 = time.perf_counter()
    d_card, per_pool = counted(adapt.pool_gradient)
    walls["pool_gradient"] = (time.perf_counter() - t0) * 1e3
    host = ADAPT_VQE(H, excitation_pool=pool, ref_state=ref)
    host.verbose, host.expectation_eval = False, "symbolic_direct"
    backend, config.backend = config.backend, "host"
    try:
        t0 = time.perf_counter()
        d_host = host.pool_gradient()
        walls["pool_gradient_host"] = (time.perf_counter() - t0) * 1e3
    finally:
        config.backend = backend
    err_pool = float(np.abs(d_card - d_host).max())
    assert err_pool <= 1e-10, f"ADAPT {name}: pool gradient vs host commutators {err_pool:.2e}"
    t0 = time.perf_counter()
    out = adapt.optimize(max_cycles=3)
    sync(device)
    walls["adapt3"] = (time.perf_counter() - t0) * 1e3
    energies = out["interim_data"]["history"]
    assert len(energies) == 3 and all(b <= a + 1e-12 for a, b in zip(energies, energies[1:])), (
        f"ADAPT {name}: energies {energies!r}")
    fci = data["data"]["calculated_properties"]["FCI"]["energy"]
    assert energies[-1] >= fci - 1e-10, f"ADAPT {name}: {energies[-1]!r} below FCI {fci!r}"
    say("9 evolution", flow="ADAPT_VQE(commutators, device_array)",
        system=f"tapered_{name.split('_')[0]}_{H.n_qubits}q", pool=pool.n_terms,
        pool_gradient_vs_host_err=f"{err_pool:.2e}", pool_gradient_ms=f"{walls['pool_gradient']:.1f}",
        launches_per_pool_gradient=per_pool[0], calls_per_pool_gradient=per_pool[1],
        host_commutators_ms=f"{walls['pool_gradient_host']:.1f}",
        cycle_energies=",".join(repr(float(v)) for v in energies), err_vs_fci=f"{energies[-1] - fci:.3e}",
        excitations=",".join(out["adapt_operator"]), adapt_3_cycles_ms=f"{walls['adapt3']:.1f}")

    # the CLI, as a user runs it, on the card
    for command, mol, arg in sizes["evo_cli"]:
        _, hf, data = load_molecule(mol)
        Ht, _, ref_t, _ = tapered_with_uccsd(mol)
        args = [sys.executable, "-m", "symmer_torch.command_line", command,
                "-H", os.path.join(HAM_DIR, mol), "--taper-reference", ",".join(map(str, hf)),
                "--device", "cuda"]
        args += ["--max-cycles", str(arg)] if command == "vqe" else ["--n-qubits", str(arg)]
        t0 = time.perf_counter()
        res = subprocess.run(args, cwd=REPO, capture_output=True, text=True, timeout=600)
        wall = (time.perf_counter() - t0) * 1e3
        assert res.returncode == 0, f"CLI {command} failed:\n{res.stderr[-3000:]}"
        out = json.loads(res.stdout)
        fci = data["data"]["calculated_properties"]["FCI"]["energy"]
        if command == "vqe":
            e_ref = float(Ht.expval(ref_t).real)
            assert out["n_qubits_after_taper"] == Ht.n_qubits and out["n_excitations"] >= 1
            assert fci - 1e-10 <= out["vqe_energy"] < e_ref, f"CLI vqe: {out['vqe_energy']!r}"
            fields = dict(vqe_energy=repr(out["vqe_energy"]), err_vs_fci=f"{out['vqe_energy'] - fci:.3e}",
                          excitations=",".join(out["adapt_operator"]))
        else:
            assert out["n_qubits_after"] == arg and out["reduced_hamiltonian"]
            assert np.isfinite(out["noncontextual_energy"])
            fields = dict(noncontextual_energy=repr(out["noncontextual_energy"]),
                          reduced_terms=len(out["reduced_hamiltonian"]))
        say("9 evolution", flow=f"cli_{command}", system=mol.split("_")[0], device="cuda",
            subprocess_wall_ms=f"{wall:.1f}", **fields)

    # CircuitSymmerlator at the BASELINE Clifford shape (BASELINE.md:10)
    n, depth, n_obs = sizes["evo_circuit"]
    r = np.random.default_rng(31)
    gates = ["h", "s", "sdg", "x", "y", "z", "sx", "cx", "cz", "cy"]
    steps = []
    for _ in range(depth):
        g = gates[int(r.integers(len(gates)))]
        steps.append((g, [int(q) for q in r.choice(n, size=2 if g[0] == "c" else 1, replace=False)]))
    sim = CircuitSymmerlator(n)
    for g, q in steps:
        sim.gate_map[g](*q)
    # the observable U D U^dag of a diagonal D (Z strings), so that
    # <0|U^dag O U|0> is the sum of D's coefficients: built on the host by the
    # inverse rotations, forward order, negated angles
    D = PauliwordOp.from_planes(np.zeros((n_obs, (n + 63) // 64), np.uint64),
                                rand_planes(r, n_obs, n, 0.05), r.normal(size=n_obs) + 0j,
                                n).cleanup()
    config.backend = "host"
    obs = D.perform_rotations([(p, -a) for p, a in sim.sequence])
    want = complex(np.sum(D.coeff_vec))
    values, rotated = {}, {}
    for backend in ("host", "auto"):
        config.backend = backend
        t0 = time.perf_counter()
        rotated[backend] = sim.apply_sequence(obs)
        values[backend] = complex(np.sum(rotated[backend].coeff_vec[
            ~np.any(rotated[backend].x_pack, axis=1)]))
        sync(device)
        walls[f"circuit_{backend}"] = (time.perf_counter() - t0) * 1e3
    config.backend = "device"
    assert sim.evaluate(obs) == values["auto"]
    err = compare_ops(rotated["auto"], rotated["host"])
    assert err <= COEFF_RTOL and abs(values["auto"] - values["host"]) <= 1e-12, (
        f"CircuitSymmerlator: card vs host {err:.2e}")
    assert abs(values["auto"] - want) <= 1e-12 * max(1.0, abs(want)), (
        f"CircuitSymmerlator: {values['auto']!r} vs the diagonal's sum {want!r}")
    say("9 evolution", flow="CircuitSymmerlator.evaluate", qubits=n, gates=depth,
        rotations=len(sim.sequence), observable_terms=obs.n_terms, value=repr(values["auto"]),
        exact=repr(want),
        equal_to_host=True, max_rel_err=f"{err:.2e}", card_ms=f"{walls['circuit_auto']:.1f}",
        host_ms=f"{walls['circuit_host']:.1f}")

    # PauliwordOp.generators of a flagship operator: the K11 route
    op = synthetic_taper_operator(1000, sizes["evo_generators"], 4, 1)
    t0 = time.perf_counter()
    gens = PauliwordOp.from_planes(op.x_pack, op.z_pack, op.coeff_vec, 1000).generators
    walls["generators_card"] = (time.perf_counter() - t0) * 1e3
    config.backend = "host"
    t0 = time.perf_counter()
    gens_host = PauliwordOp.from_planes(op.x_pack, op.z_pack, op.coeff_vec, 1000).generators
    walls["generators_host"] = (time.perf_counter() - t0) * 1e3
    config.backend = "device"
    assert np.array_equal(gens.x_pack, gens_host.x_pack) and np.array_equal(gens.z_pack, gens_host.z_pack)
    say("9 evolution", flow="PauliwordOp.generators", terms=op.n_terms, qubits=1000,
        generators=gens.n_terms, equal_to_host=True, card_ms=f"{walls['generators_card']:.1f}",
        host_ms=f"{walls['generators_host']:.1f}")
    say("9 evolution", counted_flows_wall_s=f"{time.perf_counter() - t_phase:.1f}")


# the kernels of each counted path: phases 3-6 (taper, algebra, CS-VQE),
# phase 7 (the eigensolvers) and phase 9 (the evolution slice)
PATH_KERNELS = {
    "3-6": ("anticommutes", "clifford_scan", "expval", "brute_force_minimise"),
    "7": ("group_matvec", "lanczos_step", "lanczos_replay"),
    "9": ("vqe_rotate", "vqe_adjoint", "pauli_overlaps", "gf2_rref"),
}
# kept, built and held against its plain version in phase 7, but off every
# path the drivers run since the matvec recomputes the diagonals
OFF_PATH = {"build_group_diagonals": "7"}


def run(device, sizes, config):
    """Phases 2-9 on the CUDA `device`; returns (kernel report, launch counts:
    each kernel's launches on its own path, each path counted from zero)."""
    import torch

    from symmer_torch.kernels import cuda
    from symmer_torch.profiling import kernel_stats

    rng = np.random.default_rng(0)
    config.device = device
    report = phase_kernels(device, sizes, rng)
    report.update(phase_state_kernels(device, sizes, rng))
    report.update(phase_eigen_kernels(device, sizes))
    report.update(phase_evolution_kernels(device, sizes))
    torch.cuda.empty_cache()  # release the kernel checks' large temporaries to CUDA
    config.backend = "device"
    config.device = device
    counts = {}
    # each path: the counts set to 0 just before it and read just after
    cuda.reset_launches()
    kernel_stats.reset()
    phase_chemistry(device)
    phase_flagship(device, sizes, config)
    phase_algebra(device, sizes, config, rng)
    phase_csvqe(device, sizes, config)
    counts["3-6"] = dict(cuda.launches)
    print(kernel_stats.summary(), flush=True)
    cuda.reset_launches()
    kernel_stats.reset()
    phase_eigensolvers(device, sizes, config)
    counts["7"] = dict(cuda.launches)
    print(kernel_stats.summary(), flush=True)
    torch.cuda.empty_cache()
    cuda.reset_launches()
    kernel_stats.reset()
    phase_evolution(device, sizes, config)
    counts["9"] = dict(cuda.launches)
    print(kernel_stats.summary(), flush=True)
    for path, c in counts.items():
        say("8 coverage", phases=path, **{f"launches_{k}": v for k, v in c.items()})
    assert counts["7"]["build_group_diagonals"] == 0, "the drivers built a group-diagonal table"
    launches = {k: counts[path][k] for path, names in PATH_KERNELS.items() for k in names}
    return report, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from symmer_torch import config
    from symmer_torch.kernels import cuda

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    say("0 device", nvidia_smi=repr(smi), torch=repr(name),
        torch_version=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    lib = cuda.build()
    cuda._lib()
    say("1 build", seconds=f"{time.perf_counter() - t0:.2f}", library=os.path.relpath(lib, REPO))
    for line in cuda.build_log.splitlines():
        if any(k in line for k in ("Compiling entry", "Used", "Function properties", "spill")):
            print("  " + line.strip())
    report, launches = run(device, FULL, config)
    missing = [k for k, n in launches.items() if n == 0]
    assert not missing, f"kernels not launched on their path: {missing}"

    sources = {
        "anticommutes": ("symmer_torch/csrc/anticommutes.cu",
                         "symmer_tpu/kernels/pallas_gf2.py:45"),
        "clifford_scan": ("symmer_torch/csrc/clifford_scan.cu",
                          "symmer_tpu/kernels/jx_core.py:591"),
        "expval": ("symmer_torch/csrc/state_expval.cu",
                   "symmer_tpu/kernels/jx_state.py:131"),
        "brute_force_minimise": ("symmer_torch/csrc/noncon_brute.cu",
                                 "symmer_tpu/kernels/jx_noncon.py:36"),
        "group_matvec": ("symmer_torch/csrc/lanczos_matvec.cu",
                         "symmer_tpu/kernels/jx_lanczos.py:464"),
        "build_group_diagonals": ("symmer_torch/csrc/group_diag.cu",
                                  "symmer_tpu/kernels/jx_lanczos.py:281"),
        "lanczos_step": ("symmer_torch/csrc/lanczos_step.cu",
                         "symmer_tpu/kernels/jx_lanczos.py:623 (pass 1's step in "
                         "_tridiag_segment_fn)"),
        "lanczos_replay": ("symmer_torch/csrc/lanczos_step.cu",
                           "symmer_tpu/kernels/jx_lanczos.py:682 (the replay's step in "
                           "_ritz_segment_fn)"),
        "vqe_rotate": ("symmer_torch/csrc/vqe_rotate.cu",
                       "symmer_tpu/evolution/jx_vqe.py:87 (the evolve scan of "
                       "_jitted_engine's loss_plain; _jitted_pool_grad's at :403)"),
        "vqe_adjoint": ("symmer_torch/csrc/vqe_rotate.cu",
                        "symmer_tpu/evolution/jx_vqe.py:189 (jax.grad's backward through "
                        "the evolve scan of :87)"),
        "pauli_overlaps": ("symmer_torch/csrc/pauli_overlaps.cu",
                           "symmer_tpu/evolution/jx_vqe.py:418 (_jitted_pool_grad's pterm "
                           "scan; the jax.grad backward of :189)"),
        "gf2_rref": ("symmer_torch/csrc/gf2_rref.cu",
                     "symmer_tpu/kernels/jx_gf2.py:21 (rref_packed_device)"),
    }
    kernels = [
        dict(name=k, route="cuda", source=sources[k][0], replaces=sources[k][1],
             launches=launches.get(k, 0), **report[k],
             **({"on_main_path": False, "held_in_phase": OFF_PATH[k]} if k in OFF_PATH else {}))
        for k in sources
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
