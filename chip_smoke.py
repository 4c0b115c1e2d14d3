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
     brute-force search); K2 (row_signature, the cleanup's 128-bit row
     signature) bit for bit its plain version and a second launch at the
     flagship's 200,000 x 16 words, a mesh shard's 50,000 x 16 and tapered
     N2's 2,229 x 1, timed cold and warm beside its bound (bytes or 32-bit
     integer operations) and the plain version, and at 200,000 rows a whole
     cleanup_sorted with K2, K17 and K3 against the same call with the
     plain sort and merge and with all plain (walls in turns, outputs
     alike); K4
     (pair_products, a product's signatures and coefficients without its
     rows) at phase 5's 500 x 500-term square and the CS-VQE flows' largest
     product bit for bit its plain version on the card and the CPU; K17
     (sort_keys, the cleanup's stable sort by the first signature key) at
     the flagship's 200,000 keys, the rotation's 200,000 slots, the
     square's 250,000 pairs, the chain's 1,162,560 slots, a shard's 50,000,
     tapered N2's 2,229 and one key, and at one block's 4,096 keys and one
     past, all keys equal, the int64 extremes, negative keys, small
     integers, hash keys skewed (a bucket past a block's shared memory, a
     500-key group, a sub-range at the comparison's cap and one past it)
     and 2^23 hash keys, perm and sorted keys exactly its plain version
     (torch.argsort(stable=True)), the launches a call its design states
     (none, one or three) by its counter and by a captured CUDA graph's
     kernel nodes (graph_nodes), timed
     cold and warm beside its bound, the bytes its design moves, the plain
     version, torch.sort(stable=True) (library_ms) and the parent's
     _lexsort, with each launch's card time (torch.profiler) beside
     torch.sort's; the
     four device composites bit for bit the parent's composition (_lexsort,
     then the plain merge) on the CPU and the sort by (ka, kb) through K3 on
     the card, and with their first key forged to collide:
     the split run reported, the repair route taken once, the same bits; K3
     (merge_groups, the cleanup's merge after its sort) at K2's shapes on
     K17's sorted keys bit for bit its plain version on the CPU and the
     parent's output, and within 1e-12 of its plain version on the card,
     its passes timed apart and its wrapper's span with its one host read;
     K3's one-block route (merge_small: up to 4,096 slots grouped, sorted,
     summed and compacted in one launch) at the CS-VQE flows' 1 x 1 and
     67 x 1 products, LiH's projection, tapered N2's cleanup, 4,096 x 16
     words, one group of 4,096 slots, 4,096 slots cancelling and a
     1,000-term rotation, bit for bit its plain version on the CPU, the
     parent's composition, the large route and a second launch, one launch
     a call, timed cold and warm beside the parent's route on the same
     inputs (K17 and K3's two passes, and both wrapper spans with their
     host read), the plain version, its bound and its aims; its fused
     route (sign_merge_small: a cleanup's or product's slots signed in
     the launch, K2's and K4's bits) at the CS-VQE flows' 1 x 1 and 67 x 1
     products, tapered N2's cleanup and the flagship's rows at the
     budget's edge and one past it, bit for bit its plain version, the two
     launches it replaces and a second launch, one kernel node a call,
     timed cold and warm beside the two launches on the same inputs (bare
     C calls, then both wrapper spans), the plain version, its bound and
     its aims;
     K6 (rotation_rows, a non-Clifford rotation's 2 T slots:
     signatures, coefficients, live flags, without the rotated rows) at
     phase 5's rotation of 100,000 terms with about half, none and all of
     them anticommuting and at the largest rotation of phase 5's chain, and
     K7 (project_rows, a projection's slots after K5 and K1, without the
     filtered rows) at the flagship taper's and LiH's projections, each bit
     for bit its plain version on the card and the CPU and a second launch,
     timed beside its bound (operations or bytes) and the plain version,
     and K3 on each output with its live flags and its row source; each
     device cleanup's, product's, rotation's and projection's torch ops,
     launches, host synchronisations and peak memory (cleanup_costs); then
     is_noncontextual at 8,192 terms, K1 (the adjacency, with its plain
     version and torch._int_mm) and K9 timed apart, against the host
     adjacency path;
  3. chemistry: LiH and H2 tapered on the card (resident taper), ground
     energies against their pins to 1e-10;
  4. flagship: the 1000-qubit x 200,000-term, 4-symmetry synthetic taper,
     resident on the card against the port's host path;
  5. algebra core: squaring, a non-Clifford rotation and a DeviceOperator
     chain on the card against the host path, each with its peak allocated
     memory;
  6. CS-VQE (backend "device"): Be, HF, H2O and BeH2 tapered, projected by
     ContextualSubspace to 3 qubits, energies against their pins to 1e-10;
     N2 (20 -> 15 -> 8 qubits) and MgH2 (22 -> 17 -> 8) with the tapered
     reference state and UCCSD operator, equal to the port's host path;
     tapered N2 with no reference state (the brute force over all 14
     symmetry generators on the card) reaching the host path's energy
     (anticommutes and the state actions below dispatch.DEVICE_FLOOR
     term-words run on the host: each 8-qubit flow prints its dispatches
     per run by side, and its multiply_cleanup calls with their kernel
     launches and host synchronisations a call);
     DeviceOperator.expval of each tapered molecule against its tapered HF
     state;
  7. eigensolvers (the Lanczos slice, on the card, config.device "cuda"):
     the Lanczos kernels against their plain versions first (outside the
     counted run): the X-grouped matvec (group_matvec, recomputing the
     group diagonals from the terms) at tapered N2 (378 groups, 2^15 rows,
     b = 1 and 4), H2O (162 x 2^14) and tapered MgH2 (580 x 2^17) within
     1e-13 of ||out|| and bit-identical on a second launch; at the same
     row counts, pass 1's step (lanczos_step) on the route its size rule
     takes (one thread-block cluster up to the cluster's most rows, one
     cooperative launch above; the route and the cluster printed), with
     v_next aliased to v_prev and distinct, the other route where it runs
     (timed too: the rule's evidence), pass 2 from a kept basis
     (lanczos_ritz) at the drivers' k = 16 + 24 n and the replay
     (lanczos_replay, pass 2 where the basis does not fit, off the
     drivers' path at these sizes), each counted under its own key, bit
     for bit its plain version and on a second launch; the table build
     (build_group_diagonals, off the drivers' path) at tapered N2 and H2O
     bit for bit; times cold and warm, bounds (the matvec's float64
     operations, recounted in matvec_bound: one complex add per term and
     thread of 2^k rows, a k-stage Walsh-Hadamard transform and one
     complex multiply-add per group, row and column, the least over k; the
     steps' and lanczos_ritz's bytes), the matvec's time for one term at
     the same launch shape, cuSPARSE's CSR product on the table as the
     matvec's yardstick; tapered N2's lanczos_ground_state on both pass-2
     routes (the kept basis; the replay, with keeps_basis patched to
     refuse), bit for bit alike, timed, with its launches a run.  Then,
     counted: exact_gs_energy_device of tapered N2 against the port's host
     eigensolver (1e-10) with <psi|H|psi> equal to the energy; H2O's lowest
     four states (deflate) against host eigsh (1e-9); CH2's ground pair by
     the band recurrence; CH2 with n_particles = 8 against FCI (1e-8);
     QubitSubspaceManager(H2O) with no reference state on the Lanczos
     route, its exact energy against FCI (1e-10) and its 6-qubit
     Hamiltonian equal to the same flow on the CPU device; the counted run
     launches no table build;
  8. coverage: the twelve kernels of phases 3-6 (K1, K5, K10, K12, the
     fused route (sign_merge_small), which every cleanup of stored rows and
     every product within cuda.small_fused launches, K2, which the larger
     cleanups of stored rows launch, K3's one-block route (merge_small),
     which every other cleanup, product, rotation and projection of at
     most 4,096 slots launches, K17 and K3's two passes, which the
     larger ones launch, K4, which the larger products launch, K6, which every
     non-Clifford rotation launches, and K7, which every projection
     launches) were launched there, K3's calls on each route printed for
     every counted path, and no sort was repaired on any counted path
     (cuda.sort_repairs), the matvec, the
     step and lanczos_ritz in phase 7, the evolution slice's four in phase
     9, route_rows, anticommutes, clifford_scan, brute_force_minimise, the
     matvec, the step, lanczos_ritz, vqe_rotate, vqe_adjoint,
     pauli_overlaps, row_signature, pair_products, sort_keys,
     merge_groups, rotation_rows and project_rows in phase 10;
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
     1000-qubit flagship's joint planes at 2,048, 20,000 and 200,000 rows,
     on tapered N2's and on the transposed stacks of the symmetry search of
     a 1,100-qubit, 200,000-term operator after its sketch (2,200 x 108
     words, the blocked kernel's panel in shared memory) and without it
     (2,200 x 3,160, the panel in global memory), bit for bit its plain
     version, the host's gf2core.rref_inplace
     and a second launch, with its passes and launches a call, timed
     against the host (the crossover; tools/ab_compare.py rref times an
     older tree's kernel on the same shapes); times cold and warm, bounds (bytes, or float64
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
     route) and IndependentOp.symmetry_generators of the 1,100-qubit,
     200,000-term operator (K11 on the sketch's stack) against the host
     path;
 10. the mesh (symmer_torch.use_mesh): first, outside the counted run, K16
     (route_rows, one exchange round's stable keep/send partition) at the
     flagship's shard shape bit for bit its plain version and a second
     launch, one launch a call, its wrapper's host time a call, timed cold
     and warm beside its bytes bound; K13 with a row
     range (group_matvec(..., rows=), a shard's block of the Lanczos
     matvec) at tapered N2 and tapered MgH2, each of the four row blocks
     bit for bit the launch over every row and a second launch, within
     1e-13 of the plain version's block (itself bit for bit the plain
     version's whole product's rows), a quarter timed cold and warm beside
     its bound, the plain version and cuSPARSE on the quarter's rows of the
     table; then, counted,
     four shards of cuda:0 (Mesh([cuda:0] * 4), one process running the
     shards in turn) through the public API: the flagship taper (the host
     PauliwordOp's fused projection), the square of a 1000-qubit 500-term
     operator, a non-Clifford rotation of 100,000 terms, a cleanup of
     200,000 rows (4 copies of 50,000 terms), the flagship's expval against
     1,024 rows and tapered N2's 14-generator brute force (one range of
     assignments a shard), each against the port's one-device route (term
     sets and 1e-12 relative; energies 1e-10; the brute force bit for bit)
     and timed both ways; exact_gs_energy_device of tapered N2 and of
     tapered MgH2 (whose counted table, 4 GiB, only the mesh's budget
     admits: the one-device route raises MemoryError, and the reference
     solve runs with the budget raised for that call only) on the
     row-sharded Lanczos matvec, each matvec one K13 launch (and its slice
     sum) a shard, energies within 1e-10 of the one-device route; tapered
     MgH2's VQE energy and gradient (1,316 generators) with the observable's
     terms in four slices, within 1e-10; each timed both ways;
     kernel_stats.mesh_calls shows each route; with two cards or more, a
     cleanup over all of them.

The line before the last is a JSON object with each kernel's launches,
error and times (twenty-two kernels; a kernel on two counted paths carries
the first one's launches); the last line is {"ok": true, "device":
{...}}.
Imports neither jax nor symmer_tpu.  tools/ab_compare.py runs phases 2 and 4
of this file on several checkouts in turns, to compare them on one card.
"""
from __future__ import annotations

import contextlib
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
INT32_OPS_PER_S = 64 * 132 * 1.98e9         # 32-bit multiplies, shifts, adds: 64 per clock per SM
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
    # row_signature (K2): the flagship's rows (its first N; all 200,000 are
    # the resident taper's cleanup, 50,000 a mesh shard's), tapered N2's
    # operator (the CS-VQE flows' cleanups); a cleanup_sorted at the first
    sig_shapes=[("flagship", 200_000), ("flagship", 50_000), ("N2_STO-3G_SINGLET_JW.json", None)],
    sig_main=("flagship", 200_000),
    # pair_products (K4): phase 5's square (500 x 500 terms at 1000 q, 16
    # words) and the CS-VQE flows' largest product (tapered N2's first 67
    # terms times one term, one word; 861 of the N2 flow's 863 products are
    # 1 x 1); merge_groups (K3) runs at sig_shapes
    pair_shapes=["square", ("N2_STO-3G_SINGLET_JW.json", 67)],
    pair_main="square",
    # merge_groups (K3) also on each K4 output (the pair row source) and at
    # (kind, rows, k) of 16 words: rows repeating about twice (k distinct)
    # and cancelling, under a threshold that drops groups; one group of k
    # rows (merge_case)
    merge_shapes=[("repeats", 200_000, 100_000), ("one_group", 200_000, 100_000)],
    # K3's one-block route (merge_small) at the small composites of the main
    # path, (composite, shape): the CS-VQE flows' 1 x 1 and 67 x 1 products,
    # LiH's projection (631 slots, live flags), tapered N2's cleanup (2,229
    # x 1 word), the flagship's first 4,096 rows (16 words), one group of
    # 4,096 slots, 4,096 slots in pairs that cancel under 0.5 (merge_case)
    # and a 1,000-term rotation (rotation_small: 2,000 slots, live flags);
    # the JSON line's at small_main
    small_shapes=[("product", ("N2_STO-3G_SINGLET_JW.json", 1)),
                  ("product", ("N2_STO-3G_SINGLET_JW.json", 67)), ("projection", "LiH"),
                  ("cleanup", ("N2_STO-3G_SINGLET_JW.json", None)),
                  ("cleanup", ("flagship", 4096)), ("merge", ("one_group", 4096, 4096)),
                  ("merge", ("cancelling", 4096, 2048)), ("rotation", "small")],
    small_main=("product", ("N2_STO-3G_SINGLET_JW.json", 67)),
    # the fused route (cleanup_small, product_small: K3's one-block route
    # signing its slots) at the main path's small calls, (composite, shape):
    # the CS-VQE flows' 1 x 1 and 67 x 1 products, tapered N2's cleanup
    # (2,229 x 1 word), and the flagship's rows (16 words) at the budget's
    # edge: cuda.FUSED_WORDS / 16 rows, and one more (the rule's first
    # cleanup of 16-word rows on K2's route); the JSON line's at fused_main
    fused_shapes=[("product", ("N2_STO-3G_SINGLET_JW.json", 1)),
                  ("product", ("N2_STO-3G_SINGLET_JW.json", 67)),
                  ("cleanup", ("N2_STO-3G_SINGLET_JW.json", None)),
                  ("cleanup", ("flagship", "budget")), ("cleanup", ("flagship", "past"))],
    fused_main=("product", ("N2_STO-3G_SINGLET_JW.json", 67)),
    # cleanup_costs' calls: cleanups, products and rotations (projections
    # at proj_shapes), the large route's and the one-block route's
    cost_cleanups=[("flagship", 200_000), ("N2_STO-3G_SINGLET_JW.json", None)],
    cost_products=["square", ("N2_STO-3G_SINGLET_JW.json", 67),
                   ("N2_STO-3G_SINGLET_JW.json", 1)],
    cost_rotations=["mixed", "small", "chain"],
    # sort_keys (K17): the first signature key of the flagship's 200,000 rows
    # (the JSON line's shape), of phase 5's rotation's 200,000 slots, the
    # square's 250,000 pairs, the chain's largest rotation's 1,162,560
    # slots, a shard's 50,000 rows, tapered N2's 2,229 terms and one key;
    # then edges of (kind, keys): one block's 4,096 and one past, all keys
    # equal, the int64 extremes, negative keys, small integers, and hash
    # keys skewed (sort_edge_keys), and 2^23 hash keys (buckets through
    # global memory)
    sort_shapes=[("flagship", 200_000), ("rotation", None), ("square", None), ("chain", None),
                 ("flagship", 50_000), ("N2_STO-3G_SINGLET_JW.json", None), ("flagship", 1)],
    sort_main=("flagship", 200_000),
    sort_edges=[("random", 4096), ("random", 4097), ("equal", 200_000), ("extremes", 200_000),
                ("negative", 200_000), ("small", 200_000), ("big_bucket", 200_000),
                ("group500", 200_000), ("cap", 200_000), ("cap_past", 200_000),
                ("random", 2**23)],
    # rotation_rows (K6): phase 5's rotation (rotation below: 1000 q x
    # 100,000 terms, Q of density 0.3) with about half, none and all of its
    # terms anticommuting, and the largest rotation of phase 5's chain
    # (captured from a run of the chain); project_rows (K7): the flagship
    # taper's projection (200,000 x 16 words, 4 stabilizers) and LiH's
    # (each captured from its taper); K3 with live flags on each
    rot_shapes=["mixed", "none", "all", "chain"],
    rot_main="mixed",
    proj_shapes=["flagship", "LiH"],
    proj_main="flagship",
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
    rotation_small=(1000, 1000),
    chain=(1000, 2000, 200),
    # the evolution slice: K15a at tapered (2^17) and untapered (2^22)
    # MgH2's rows; K15c at N = 1 there and tapered N2's UCCSD pool; K11 on
    # the flagship's joint planes (the JSON line at evo_generators rows),
    # tapered N2's and the transposed stacks of the symmetry search of a
    # 1,100-qubit, 200,000-term operator after the sketch (2,200 x 108
    # words) and without it (2,200 x 3,160); the phase-9 flows
    evo_rotate=[17, 22],
    evo_overlaps=[(17, 1), (22, 1), ("N2_STO-3G_SINGLET_JW.json", "pool")],
    evo_rref=[("flagship", 2048), ("flagship", 20_000), ("flagship", 200_000),
              ("N2_STO-3G_SINGLET_JW.json", None), ("symmetry_search", True),
              ("symmetry_search", False)],
    evo_generators=20_000,
    evo_symmetry=(1100, 200_000),
    evo_vqe="MgH2_STO-3G_SINGLET_JW.json",
    evo_adapt="N2_STO-3G_SINGLET_JW.json",
    evo_cli=[("vqe", "MgH2_STO-3G_SINGLET_JW.json", 2),
             ("contextual_subspace", "N2_STO-3G_SINGLET_JW.json", 8)],
    # CircuitSymmerlator at the BASELINE Clifford shape: qubits, gates,
    # observable terms (BASELINE.md:10, bench.py:355-375)
    evo_circuit=(1000, 2000, 100),
    # the mesh slice: shards of the card; the flows run the flagship taper,
    # the square and the rotation above, a cleanup of (qubits, rows, copies
    # of each term), the flagship's expval against a state of this many rows
    # and the main path's brute force (brute_main) against one device;
    # K16 timed at the flagship's shard shape
    mesh_shards=4,
    mesh_cleanup=(1000, 200_000, 4),
    mesh_expval=1024,
    # the eigensolvers on the mesh: tapered N2, then tapered MgH2, whose
    # counted table only the mesh's budget admits; K13's row range timed at
    # both; the VQE flow at evo_vqe
    mesh_lanczos=("N2_STO-3G_SINGLET_JW.json", "MgH2_STO-3G_SINGLET_JW.json"),
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


def signature_bound(T: int, W: int):
    """(ms, 'bytes' or 'operations'): K2 reads each row's 2 W words once and
    writes its two int64 keys (16 W + 16 bytes a row), and does 11 32-bit
    integer operations (3 xor-shifts, 3 multiplies, 4 xors, 1 add) for each
    of a row's 4 W half-words in each of its 4 lanes."""
    return larger((16 * W + 16) * T / HBM_BYTES_PER_S * 1e3,
                  11 * 4 * 4 * W * T / INT32_OPS_PER_S * 1e3)


@contextlib.contextmanager
def plain_kernels(*names):
    """Within the block the named cuda wrappers are their plain torch
    versions (the cleanup's composition before the named kernels)."""
    from symmer_torch.kernels import cuda, torch_core

    kept = {k: getattr(cuda, k) for k in names}
    for k in names:
        setattr(cuda, k, getattr(torch_core, k))
    try:
        yield
    finally:
        for k, fn in kept.items():
            setattr(cuda, k, fn)


def same_terms(a, b, exact: bool) -> None:
    """Two cleanups' (x, z, cr, ci[, ka]) alike: rows and keys bit for bit,
    coefficients bit for bit or, where torch's CUDA segment_reduce summed a
    group (a plain merge on the card), within COEFF_RTOL."""
    import torch

    assert all(same_bits(g, w) for g, w in zip(a[:2], b[:2])), "cleanup rows differ"
    for g, w in zip(a[2:4], b[2:4]):
        if exact:
            assert same_bits(g, w), "cleanup coefficients differ"
        else:
            assert bool(torch.all((g - w).abs() <= COEFF_RTOL * w.abs())), "coefficients differ"


def cleanup_walls(x, z, device, rounds: int = 6) -> dict:
    """A cleanup_sorted of the rows x, z (random coefficients, seed 1) three
    ways, in turns (A B C C B A ...): K2, K17 and K3 (the main path), K2
    with the plain sort and merge (torch.argsort and the plain merge) and
    all three plain; the outputs alike (same_terms); each way's median wall
    (host clock, the card synchronised before and after)."""
    import torch

    from symmer_torch.kernels import torch_core

    c = np.random.default_rng(1).normal(size=(2, x.shape[0]))
    cr, ci = torch.tensor(c[0], device=device), torch.tensor(c[1], device=device)
    ways = {"k2_k17_k3": (), "k2_plain_sort_merge": ("sort_keys", "merge_groups"),
            "plain": ("sort_keys", "merge_groups", "row_signature")}

    def run(way):
        with plain_kernels(*ways[way]):
            return torch_core.cleanup_sorted(x, z, cr, ci, None)

    out = {way: run(way) for way in ways}
    sync(device)
    same_terms(out["k2_plain_sort_merge"], out["k2_k17_k3"], exact=False)
    same_terms(out["plain"], out["k2_plain_sort_merge"], exact=True)
    walls = {way: [] for way in ways}
    for r in range(rounds):
        for way in (list(ways) if r % 2 == 0 else list(ways)[::-1]):
            sync(device)
            t0 = time.perf_counter()
            run(way)
            sync(device)
            walls[way].append((time.perf_counter() - t0) * 1e3)
    return dict(cleanup_out_terms=out["k2_k17_k3"][0].shape[0],
                **{f"cleanup_{way}_ms": f"{np.median(w):.3f}" for way, w in walls.items()})


def phase_signature_kernel(device, sizes):
    """Phase 2, K2 (row_signature): bit for bit its plain version and a
    second launch at each shape, timed cold and warm beside its bound and
    the plain version; at sig_main also a whole cleanup_sorted with K2 and
    K3 against the same call with K3's plain version and with both plain
    (cleanup_walls)."""
    import torch

    from symmer_torch.kernels import cuda, torch_core

    to = lambda v: torch.tensor(np.ascontiguousarray(v).view(np.int64), device=device)
    no_lib = "no single torch call computes the signature"
    report = {}
    for which, rows in sizes["sig_shapes"]:
        label, xp, zp = planes_of(which, rows, sizes)
        x, z = to(xp), to(zp)
        T, W = x.shape
        shape = f"{label}_{T}x{W}words"
        got, again = cuda.row_signature(x, z), cuda.row_signature(x, z)
        want = torch_core.row_signature(x, z)
        sync(device)
        for g, a, w in zip(got, again, want):
            assert torch.equal(g, w), f"row_signature differs from its plain version at {shape}"
            assert torch.equal(g, a), f"row_signature not repeatable at {shape}"
        kernel = lambda: cuda.row_signature(x, z)
        t_cold, t_warm, spread = cold_warm(kernel, device, 20)
        t_p = device_ms(lambda: torch_core.row_signature(x, z), device, reps=3)
        bound, bound_by = signature_bound(T, W)
        fields = cleanup_walls(x, z, device) if (which, rows) == tuple(sizes["sig_main"]) else {}
        say("2 kernels", kernel="row_signature", shape=shape, bit_for_bit_plain=True,
            repeatable=True, ms_l2_cold=f"{t_cold:.5f}", ms_l2_cold_range=spread,
            ms_l2_warm=f"{t_warm:.5f}", plain_ms=f"{t_p:.5f}", bound_ms=f"{bound:.5f}",
            bound_by=bound_by, share_cold=f"{bound / t_cold:.5f}",
            share_warm=f"{bound / t_warm:.5f}", library_ms=f"null ({no_lib})", **fields)
        if (which, rows) == tuple(sizes["sig_main"]):
            report["row_signature"] = dict(
                max_abs_err=0, ms=t_cold, ms_l2_warm=t_warm, plain_ms=t_p, bound_ms=bound,
                bound_by=bound_by, library_ms=None, library_null_reason=no_lib, shape=shape)
        del x, z, got, again, want
    return report


def sort_inputs(device, sizes):
    """Yield (label, ka, kb, main) of each K17 shape (sort_shapes): the
    first signature key of the flagship's first rows (K2), of phase 5's
    rotation's and the chain's largest rotation's slots (K6), of the
    square's pairs (K4), of tapered N2's terms, one key; then the edges
    (sort_edges): one block's 4,096 keys and one past, all keys equal, the
    int64 extremes, negative keys in long runs."""
    import torch

    from symmer_torch.kernels import cuda

    to = lambda v: torch.tensor(np.ascontiguousarray(v).view(np.int64), device=device)
    for which, rows in sizes["sort_shapes"]:
        if which in ("rotation", "chain"):
            label, args, _ = rotation_inputs(device, "mixed" if which == "rotation" else which,
                                             sizes)
            ka, kb = cuda.rotation_rows(*args)[:2]
            label = f"{label}_{ka.shape[0]}slots"
        elif which == "square":
            label, ops = product_operands(device, which, sizes)
            ka, kb = cuda.pair_products(*ops)[:2]
            label = f"{label}_{ka.shape[0]}pairs"
        else:
            label, xp, zp = planes_of(which, rows, sizes)
            ka, kb = cuda.row_signature(to(xp), to(zp))
            ka, kb = ka[:rows].contiguous(), kb[:rows].contiguous()
            label = f"{label}_{ka.shape[0]}keys"
        yield label, ka, kb, (which, rows) == tuple(sizes["sort_main"])
    rng = np.random.default_rng(11)
    for kind, T in sizes["sort_edges"]:
        yield (f"{kind}_{T}keys", to(sort_edge_keys(rng, T, kind)),
               to(rng.integers(-2**63, 2**63 - 1, T, endpoint=True)), False)


def sort_edge_keys(rng, T: int, kind: str):
    """T int64 keys: "random" (full range), "equal" (one key), "extremes"
    (INT64_MIN, INT64_MAX, -1, 0 and 1 only), "negative" (-49 .. -1),
    "small" (below 2^24: the top five digits constant); hash keys skewed,
    with u = key ^ 2^63: "big_bucket" (a third of them with top byte 0x42:
    a bucket past a block's shared memory), "group500" (one key 500 times),
    "cap" / "cap_past" (exactly 64 / 65 keys with top bytes 0x42, 0x17: a
    sub-range at K17's comparison cap and one past it)."""
    if kind == "equal":
        return np.full(T, -5, np.int64)
    if kind == "extremes":
        return rng.choice(np.array([-2**63, 2**63 - 1, -1, 0, 1], np.int64), T)
    if kind == "negative":
        return -rng.integers(1, 50, T)
    if kind == "small":
        return rng.integers(0, 2**24, T)
    keys = rng.integers(-2**63, 2**63 - 1, T, endpoint=True)
    u = keys.view(np.uint64) ^ np.uint64(1 << 63)
    if kind == "big_bucket":
        pick = rng.random(T) < 1 / 3
        u[pick] = (u[pick] & np.uint64(2**56 - 1)) | np.uint64(0x42 << 56)
    elif kind == "group500":
        u[rng.permutation(T)[:min(500, T // 2)]] = u[0]
    elif kind in ("cap", "cap_past"):
        u[(u >> np.uint64(48)) == np.uint64(0x4217)] += np.uint64(1 << 48)
        pick = rng.permutation(T)[:64 + (kind == "cap_past")]
        u[pick] = (u[pick] & np.uint64(2**48 - 1)) | np.uint64(0x4217 << 48)
    return (u ^ np.uint64(1 << 63)).view(np.int64)


GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset"}  # CUgraphNodeType


def graph_nodes(fn) -> dict:
    """{node type: count} of the work one fn() call enqueues on the card: the
    nodes of a CUDA graph that captures it (cuGraphGetNodes,
    cuGraphNodeGetType).  Exact, where the profiler's trace is not: on the
    card it has dropped one kernel record of a few hundred now and then."""
    import ctypes

    import torch

    cu = ctypes.CDLL("libcuda.so.1")

    def check(what, err):
        assert err == 0, f"{what} failed: CUresult {err}"

    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    handle, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    check("cuGraphGetNodes", cu.cuGraphGetNodes(handle, None, ctypes.byref(n)))
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    check("cuGraphGetNodes", cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)))
    counts = {}
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        check("cuGraphNodeGetType", cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                                          ctypes.byref(kind)))
        name = GRAPH_NODE_TYPES.get(kind.value, f"type{kind.value}")
        counts[name] = counts.get(name, 0) + 1
    graph.reset()
    return counts


def kernel_device_us(fn, reps: int = 5, margin_s: float = 0.05):
    """[(microseconds a call, launches a call, name)] of each kernel fn()
    runs on the card, largest first, from torch.profiler over reps calls
    after one warm-up.  The trace's window holds margin_s of idle time
    before the calls and after them: the profiler drops a kernel record
    whose time, moved to the host's clock, falls outside its window, and
    on the card that move has put kernels up to 4.9 ms before their own
    launches (so a call's records came short of one a kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(margin_s)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(margin_s)
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
        if t and e.device_type.name == "CUDA":
            rows.append((t / reps, e.count // reps, e.key[:70]))
    return sorted(rows, reverse=True)


def phase_sort_kernel(device, sizes):
    """Phase 2, K17 (sort_keys, the cleanup's sort): at each shape of
    sort_inputs, perm and sorted keys bit for bit its plain version
    (torch.argsort(stable=True) and the gather) on the card and the CPU and
    a second launch, its launches a call (sort_launches, by its counter and
    by a captured graph's kernel and memset nodes); timed cold and
    warm beside its bound (and the bytes its design and an 8-pass LSD sort
    move), the plain version, torch.sort(stable=True) (library_ms) and the
    parent's _lexsort, and each launch's card time and torch.sort's
    (kernel_device_us).  Returns the JSON entry at sort_main."""
    import torch

    from symmer_torch.kernels import cuda, torch_core

    report = {}
    for label, ka, kb, main in sort_inputs(device, sizes):
        T = ka.shape[0]
        before = cuda.launches["sort_keys"]
        got = cuda.sort_keys(ka)
        per_call = cuda.launches["sort_keys"] - before
        again, plain = cuda.sort_keys(ka), torch_core.sort_keys(ka)
        cpu = torch_core.sort_keys(ka.cpu())
        sync(device)
        for g, a, p, w in zip(got, again, plain, cpu):
            assert torch.equal(g, p) and torch.equal(g.cpu(), w), f"sort_keys differs at {label}"
            assert torch.equal(g, a), f"sort_keys not repeatable at {label}"
        want_launches = sort_launches(T)
        assert per_call == want_launches, f"sort_keys made {per_call} launches at {label}"
        if T <= 1:
            say("2 kernels", kernel="sort_keys", shape=label, bit_for_bit_plain=True,
                launches_per_call=per_call)
            continue
        t_cold, t_warm, spread, t_lib = sort_shape_times(ka, device)
        t_p = device_ms(lambda: torch_core.sort_keys(ka), device, reps=5)
        t_lex = device_ms(lambda: torch_core._lexsort(ka, kb), device, reps=5)
        bound, bound_by = sort_bound(T)
        say("2 kernels", kernel="sort_keys", shape=label, keys=T, bit_for_bit_plain=True,
            repeatable=True, launches_per_call=per_call, ms_l2_cold=f"{t_cold:.5f}",
            ms_l2_cold_range=spread, ms_l2_warm=f"{t_warm:.5f}", plain_ms=f"{t_p:.5f}",
            bound_ms=f"{bound:.5f}", bound_by=bound_by, share_cold=f"{bound / t_cold:.5f}",
            share_warm=f"{bound / t_warm:.5f}", design_bytes_ms=f"{design_bytes_ms(T):.5f}",
            lsd_bytes_ms=f"{lsd_bytes_ms(T):.5f}", library_ms=f"{t_lib:.5f}",
            lexsort_ms=f"{t_lex:.5f}")
        for fn, who in ((lambda: cuda.sort_keys(ka), "sort_keys"),
                        (lambda: torch.sort(ka, stable=True), "torch.sort")):
            rows = kernel_device_us(fn)
            say("2 kernels", kernel="sort_keys", shape=label, launches_of=who,
                card_us_per_call=f"{sum(r[0] for r in rows):.2f}",
                per_launch=";".join(f"{n}x{name}:{t:.2f}us" for t, n, name in rows))
        # K17's kernels and memsets a call, by a captured graph's nodes
        nodes = graph_nodes(lambda: cuda.sort_keys(ka))
        want = {"kernel": want_launches, **({"memset": 1} if T > 4096 else {})}
        assert nodes == want, f"a call's graph holds {nodes} at {label}, not {want}"
        say("2 kernels", kernel="sort_keys", shape=label,
            graph_nodes_per_call=";".join(f"{n}x{k}" for k, n in sorted(nodes.items())))
        if main:
            report["sort_keys"] = dict(
                max_abs_err=0, ms=t_cold, ms_l2_warm=t_warm, plain_ms=t_p, bound_ms=bound,
                bound_by=bound_by, library_ms=t_lib, library_call="torch.sort(ka, stable=True)",
                lexsort_ms=t_lex, design_bytes_ms=design_bytes_ms(T), lsd_bytes_ms=lsd_bytes_ms(T),
                shape=label)
        del got, again, plain, cpu
    return report


def sort_launches(T: int) -> int:
    """K17's launches for T keys, as its design states them: none for one
    key, one block up to 4,096, else the histograms, the partition and the
    buckets (and a memset)."""
    return 0 if T <= 1 else 1 if T <= 4096 else 3


def sort_shape_times(ka, device):
    """(L2-cold median, warm median, 'min-max' of the cold times) of
    cuda.sort_keys(ka) over 20 calls, and torch.sort(ka, stable=True)'s
    median of 5: the timing phase 2 and tools/ab_compare.py sort share."""
    import torch

    from symmer_torch.kernels import cuda

    t_cold, t_warm, spread = cold_warm(lambda: cuda.sort_keys(ka), device, 20)
    t_lib = device_ms(lambda: torch.sort(ka, stable=True), device, reps=5)
    return t_cold, t_warm, spread, t_lib


def sort_times(device, sizes) -> None:
    """K17 (cuda.sort_keys) at every shape of sort_inputs, timed by
    sort_shape_times, its perm and sorted keys bit for bit
    torch.sort(stable=True): what tools/ab_compare.py sort runs on each
    tree."""
    import torch

    from symmer_torch.kernels import cuda

    for label, ka, _, _ in sort_inputs(device, sizes):
        if ka.shape[0] <= 1:
            continue
        perm, out = cuda.sort_keys(ka)
        want = torch.sort(ka, stable=True)
        assert torch.equal(perm.long(), want.indices) and torch.equal(out, want.values), label
        t_cold, t_warm, spread, t_lib = sort_shape_times(ka, device)
        say("2 sort", shape=label, keys=ka.shape[0], ms_l2_cold=f"{t_cold:.5f}",
            ms_l2_cold_range=spread, ms_l2_warm=f"{t_warm:.5f}", library_ms=f"{t_lib:.5f}")


@contextlib.contextmanager
def forged_first_key(name):
    """Within the block cuda.<name> (K2, K4, K6 or K7) gives its first key,
    ka, cut to its top four bits: many signatures share ka (a forged
    64-bit collision), so K3's check must report the split run."""
    from symmer_torch.kernels import cuda

    real = getattr(cuda, name)

    def forged(*args):
        out = real(*args)
        return ((out[0] >> 60) << 60,) + tuple(out[1:])

    setattr(cuda, name, forged)
    try:
        yield
    finally:
        setattr(cuda, name, real)


def composite_inputs(device, sizes):
    """Yield (label, the kernel giving its keys, the composite, its
    arguments with the threshold) of each device composite at the main
    path's shapes: the flagship's 200,000-row cleanup, phase 5's square,
    its 100,000-term rotation and the flagship taper's projection."""
    import torch

    from symmer_torch.kernels import torch_core

    to = lambda v: torch.tensor(np.ascontiguousarray(v).view(np.int64), device=device)
    _, xp, zp = planes_of(*sizes["sig_main"], sizes)
    x, z = to(xp), to(zp)
    c = np.random.default_rng(1).normal(size=(2, x.shape[0]))
    cr, ci = torch.tensor(c[0], device=device), torch.tensor(c[1], device=device)
    yield (f"cleanup_sorted_{x.shape[0]}x{x.shape[1]}words", "row_signature",
           torch_core.cleanup_sorted, (x, z, cr, ci, 1e-15))
    label, ops = product_operands(device, sizes["pair_main"], sizes)
    yield f"mul_pairs_cleanup_{label}", "pair_products", torch_core.mul_pairs_cleanup, (*ops, 1e-15)
    label, args, th = rotation_inputs(device, sizes["rot_main"], sizes)
    yield (f"rotate_nonclifford_cleanup_{label}", "rotation_rows",
           torch_core.rotate_nonclifford_cleanup, (*args, th))
    label, args, th = projection_inputs(device, sizes["proj_main"], sizes)
    yield (f"clifford_project_cleanup_{label}", "project_rows",
           torch_core.clifford_project_cleanup, (*args, th))


def composite_keys(fn, args):
    """(ka, kb, pr, pi, rows, live) that a composite's key kernels give K3
    (its row source and live flags too), from its arguments: K2 for a
    cleanup, K4 for a product, K6 for a rotation, K5, K1 and K7 for a
    projection."""
    from symmer_torch.kernels import cuda, torch_core

    if fn is torch_core.cleanup_sorted:
        x, z, cr, ci = args[:4]
        (ka, kb), pr, pi, rows, live = cuda.row_signature(x, z), cr, ci, (x, z), None
    elif fn is torch_core.mul_pairs_cleanup:
        ka, kb, pr, pi = cuda.pair_products(*args[:8])
        rows, live = (args[0], args[1], args[4], args[5]), None
    elif fn is torch_core.rotate_nonclifford_cleanup:
        ka, kb, pr, pi, live = cuda.rotation_rows(*args[:8])
        rows = (args[0], args[1], args[4], args[5])
    else:
        x, z, cr, ci, rx, rz, rm, sx, sz, neg_x, neg_z, col_keep = args[:12]
        if rx.shape[0]:
            x, z, cr, ci = cuda.clifford_scan(x, z, cr, ci, rx, rz, rm)
        ac = cuda.anticommutes(x, z, sx, sz)
        ka, kb, pr, pi, live = cuda.project_rows(x, z, cr, ci, ac, neg_x, neg_z, col_keep)
        rows = (x, z, col_keep)
    return ka, kb, pr, pi, rows, live


def parent_composition(fn, args):
    """Two references for a composite, from its key kernel's outputs on the
    card: the sort by (ka, kb) on the card (_lexsort's two torch argsorts)
    and K3 without the check; and the parent's composition on the CPU
    (_lexsort, then the plain merge without the check, which is the
    parent's plain merge on a sort by (ka, kb))."""
    from symmer_torch.kernels import cuda, torch_core

    th = args[-1]
    ka, kb, pr, pi, rows, live = composite_keys(fn, args)
    perm = torch_core._lexsort(ka, kb)
    card = cuda.merge_groups(perm.int(), ka[perm], ka, kb, pr, pi, th, rows, live, False)[:4]
    ka, kb = ka.cpu(), kb.cpu()
    perm = torch_core._lexsort(ka, kb)
    cpu = torch_core.merge_groups(perm, ka[perm], ka, kb, pr.cpu(), pi.cpu(), th,
                                  tuple(t.cpu() for t in rows),
                                  None if live is None else live.cpu(), False)[:4]
    return card, cpu


def phase_composite_sorts(device, sizes):
    """Phase 2, the four device composites after K17: each bit for bit the
    parent's composition on the CPU and the sort by (ka, kb) through K3 on
    the card (parent_composition), with one K17 call and no repair; then
    with its key kernel's ka forged to collide (forged_first_key), K3
    reports the split run, the repair (K17 twice, K3 again without the
    check) runs once (cuda.sort_repairs) and the output is still both
    references' bit for bit."""
    from symmer_torch.kernels import cuda

    for label, key_fn, fn, args in composite_inputs(device, sizes):
        want, parent = parent_composition(fn, args)
        for forge in (False, True):
            cuda.reset_launches()
            with forged_first_key(key_fn) if forge else contextlib.nullcontext():
                got = fn(*args)
            sync(device)
            launches = dict(cuda.launches)
            assert all(same_bits(g, w) for g, w in zip(got, want)), \
                f"{label} differs from the sort by (ka, kb) on the card (forged: {forge})"
            assert all(same_bits(g.cpu(), w) for g, w in zip(got, parent)), \
                f"{label} differs from the parent's composition on the CPU (forged: {forge})"
            assert cuda.sort_repairs == int(forge), f"{label}: repairs {cuda.sort_repairs}"
            say("2 kernels", composite=label, forged_collision=forge,
                bit_for_bit_lexsort_route=True, bit_for_bit_parent_cpu=True,
                repairs=cuda.sort_repairs,
                sort_keys_launches=launches["sort_keys"],
                merge_groups_launches=launches["merge_groups"])
        del want, parent, got
    cuda.reset_launches()


def pair_bound(M1: int, M2: int, W: int):
    """(ms, 'bytes' or 'operations'): K4 reads both operands once (16 W + 16
    bytes a row) and writes 32 bytes a pair; against the larger of its
    32-bit integer work, 11 operations for each of a product row's 4 W
    half-words in each of 4 lanes (the signature) and 2 W XORs (the product
    words) a pair, and its popcounts, two 64-bit words a word and pair (y of
    the product, the sign) and one a word and operand row (y1, y2), each
    64-bit popcount two 32-bit ones."""
    T = M1 * M2
    t_ops = max((44 * 4 * W + 2 * W) * T / INT32_OPS_PER_S,
                (4 * W * T + 2 * W * (M1 + M2)) / POPC_OPS_PER_S)
    return larger(((M1 + M2) * (16 * W + 16) + 32 * T) / HBM_BYTES_PER_S * 1e3, t_ops * 1e3)


def merge_bound(T: int, n: int, W: int, rows, live: bool = False, repeats: int = 0):
    """(ms, 'bytes'): K3 reads perm (int32), the sorted ka and both
    coefficients once (28 bytes a row, and a row's live flag where it has
    them) and kb of the `repeats` rows whose ka equals a neighbour's, and
    writes each of its n survivors' rows with its two sums and its key (16 W
    + 24 bytes); it reads the survivors' rows (16 W bytes each) from the
    planes (a rotation's or masked rows: the input row), or from a
    product's operands no more than both operands once; the group sums'
    float64 adds (two a row) take far less."""
    pairs = len(rows) == 4 and rows[2].dim() == 2
    read = 16 * W * (min(2 * n, rows[0].shape[0] + rows[2].shape[0]) if pairs else n)
    return (((29 if live else 28) * T + 8 * repeats + read + n * (16 * W + 24))
            / HBM_BYTES_PER_S * 1e3, "bytes")


def small_bound(T: int, n: int, W: int, rows, live: bool = False):
    """(ms, 'bytes'): K3's one-block route reads each slot's ka, kb and both
    coefficients once (32 bytes a slot, and its live flag where it has
    them), reads its n survivors' rows as merge_bound does, and writes each
    survivor's row with its two sums and its key (16 W + 24 bytes) and the
    count (8 bytes); its sort, its group sums and its survivors' places stay
    on the chip, and its arithmetic takes far less."""
    pairs = len(rows) == 4 and rows[2].dim() == 2
    read = 16 * W * (min(2 * n, rows[0].shape[0] + rows[2].shape[0]) if pairs else n)
    return (((33 if live else 32) * T + read + n * (16 * W + 24) + 8)
            / HBM_BYTES_PER_S * 1e3, "bytes")


def sort_bound(T: int):
    """(ms, 'bytes'): K17's function reads each key once and writes its
    int32 index and its sorted key once (20 bytes a key); it does no
    floating-point work and its digit arithmetic takes far less."""
    return 20 * T / HBM_BYTES_PER_S * 1e3, "bytes"


def design_bytes_ms(T: int) -> float:
    """The bytes K17's design moves for T hash keys at 3.35 TB/s: the
    histograms read the keys (8 bytes a key), the partition reads them and
    writes each key and its int32 index (20), the buckets read and write
    both (24)."""
    return 52 * T / HBM_BYTES_PER_S * 1e3


def lsd_bytes_ms(T: int) -> float:
    """The bytes an 8-pass LSD radix sort of T keys moves at 3.35 TB/s (the
    yardstick of a sort by digit passes alone): a key and its int32 index
    read and written a digit pass (24 bytes), the histograms' read of the
    keys (8 bytes)."""
    return (24 * 8 + 8) * T / HBM_BYTES_PER_S * 1e3


def rotation_bound(T: int, W: int):
    """(ms, 'bytes' or 'operations'): K6 reads each row's 2 W words and two
    coefficients once (16 W + 16 bytes) and writes two slots of two keys,
    two coefficients and a flag (66 bytes); against the larger of its
    32-bit integer work, two signatures of 11 operations for each of 4 W
    half-words in each of 4 lanes and 2 W XORs (the twin's words) a row, and
    its popcounts, five 64-bit words a word (x & zr, z & xr, x & z, xr & zr,
    the twin's x & z), each two 32-bit ones."""
    t_ops = max((2 * 44 * 4 * W + 2 * W) * T / INT32_OPS_PER_S, 10 * W * T / POPC_OPS_PER_S)
    return larger((16 * W + 16 + 66) * T / HBM_BYTES_PER_S * 1e3, t_ops * 1e3)


def project_bound(T: int, W: int, S: int):
    """(ms, 'bytes' or 'operations'): K7 reads each row's 2 W words, two
    coefficients and its S flags of K1's output once (16 W + 16 + S bytes)
    and writes two keys, two coefficients and a flag (33 bytes); against
    the larger of its 32-bit integer work, one signature of 11 operations
    for each of 4 W half-words in each of 4 lanes and 2 W ANDs (the masked
    words) a row, and its popcounts, two 64-bit words a word (x & neg_x, z
    & neg_z), each two 32-bit ones."""
    t_ops = max((44 * 4 * W + 2 * W) * T / INT32_OPS_PER_S, 4 * W * T / POPC_OPS_PER_S)
    return larger((16 * W + 16 + S + 33) * T / HBM_BYTES_PER_S * 1e3, t_ops * 1e3)


@functools.lru_cache(maxsize=1)
def flagship_operator(flagship):
    """synthetic_taper_operator(*flagship), built once a process for the
    kernel checks, which only read it (phases 2 and 10's K16 check, K10's
    flagship state)."""
    return synthetic_taper_operator(*flagship)


def planes_of(which, rows, sizes):
    """(label, x_pack, z_pack) of a K2 or K3 shape: the flagship's first
    `rows` rows, or a molecule's tapered operator."""
    if which == "flagship":
        op, label = flagship_operator(tuple(sizes["flagship"])), "flagship"
    else:
        op, label = tapered_molecule(which)[0], f"tapered_{which.split('_')[0]}"
    return label, op.x_pack[:rows], op.z_pack[:rows]


def product_operands(device, which, sizes):
    """(label, (x1, z1, cr1, ci1, x2, z2, cr2, ci2)) of a K4 shape on
    `device`: the square of a random 1000-qubit operator of 500 terms
    (phase 5's), or ("N2_...", m): tapered N2's first m terms times its term
    m (the CS-VQE flows' products are 1 x 1 and 67 x 1 terms of one word)."""
    import torch

    to = lambda v: torch.tensor(np.ascontiguousarray(v).view(np.int64), device=device)
    f = lambda v: torch.tensor(np.ascontiguousarray(v, dtype=np.float64), device=device)
    if which == "square":
        nq, nt = sizes["square"]
        A = random_operator(np.random.default_rng(5), nq, nt)
        ops = (A, A)
        label = f"square_{A.n_terms}x{A.n_terms}_{nq}q"
    else:
        name, m = which
        H = tapered_molecule(name)[0]
        ops = (H[:m], H[m:m + 1])
        label = f"tapered_{name.split('_')[0]}_{m}x1"
    planes = []
    for op in ops:
        planes += [to(op.x_pack), to(op.z_pack), f(op.coeff_vec.real), f(op.coeff_vec.imag)]
    return label, tuple(planes)


def merge_case(kind, T, k, W, device):
    """(label, x, z, cr, ci, threshold) of a K3 shape of W-word rows on
    `device`: "repeats", T rows drawn from k distinct rows (about T / k a
    group), a tenth of the coefficients exact zeros and 1,000 lone pairs of
    rows whose coefficients cancel exactly, in a random order, under the
    threshold 0.5 (which drops groups by their sums' hypot); "one_group",
    one row k times at scattered places among T - k distinct rows, under
    1e-15; "cancelling", k distinct rows twice each, the second copy's
    coefficient the first's negated (every group sums to exactly 0), under
    0.5."""
    import torch

    rng = np.random.default_rng(T + k)
    c = rng.normal(size=(2, T))
    if kind == "repeats":
        base = rng.integers(-2**62, 2**62, (k + 1000, 2, W))
        idx = rng.integers(0, k, T)
        c[:, rng.random(T) < 0.1] = 0.0
        idx[:2000] = k + np.repeat(np.arange(1000), 2)
        c[:, 1:2000:2] = -c[:, 0:2000:2]
        order = rng.permutation(T)
        rows, c, th = base[idx[order]], c[:, order], 0.5
    elif kind == "cancelling":
        order = rng.permutation(T)
        rows = np.tile(rng.integers(-2**62, 2**62, (k, 2, W)), (T // k, 1, 1))[order]
        c[:, k:] = -c[:, :k]
        c, th = c[:, order], 0.5
    else:
        rows = rng.integers(-2**62, 2**62, (T, 2, W))
        pick = rng.permutation(T)[:k]
        rows[pick] = rows[pick[0]]
        th = 1e-15
    x, z = (torch.tensor(np.ascontiguousarray(rows[:, j]), device=device) for j in (0, 1))
    cr, ci = (torch.tensor(c[j], device=device) for j in (0, 1))
    return f"{kind}_{T}x{W}words_from_{k}", x, z, cr, ci, th


def merge_pass_a(ka, kb, cr, ci, threshold, device, live=None):
    """K3's pass A as a bare C call on preallocated buffers, after this
    tree's sort: (the call, its output: the keep flags, then the sums, then
    the count, as int64).  A tree with K17 (cuda.sort_keys) runs pass A on
    K17's int32 perm and sorted ka with the split check; an older one on
    _lexsort's int64 perm and both keys by input row, with live flags where
    its pass A takes them (tools/ab_compare.py merge runs this on older
    trees)."""
    import torch

    from symmer_torch.kernels import cuda, torch_core

    lib, stream = cuda._lib(), cuda._stream(device)
    T = ka.shape[0]
    scratch = torch.empty(2 * T + (T + 7) // 8 + 1, dtype=torch.int64, device=device)
    sums, count = scratch.data_ptr(), scratch[-1:].data_ptr()
    flags = [None if live is None else live.data_ptr()]
    if hasattr(cuda, "sort_keys"):
        perm, kas = cuda.sort_keys(ka)
        keys, check = (perm, kas, kb), [1]
    else:
        keys, check = (torch_core._lexsort(ka, kb), ka, kb), []
        if len(lib.symmer_merge_groups_sums.argtypes) == 12:
            flags = []
    sync(device)

    def pass_a():
        cuda._raise("merge_groups", lib.symmer_merge_groups_sums(
            *(t.data_ptr() for t in keys), cr.data_ptr(), ci.data_ptr(), *flags, T, *check,
            int(threshold is not None), 0.0 if threshold is None else threshold,
            sums + 16 * T, sums, count, stream))

    return pass_a, scratch


def merge_pass_times(ka, kb, cr, ci, rows, threshold, n, device, live=None):
    """K3's two passes timed apart, as bare C calls on preallocated buffers
    (pass B with a fresh look-back epoch each call): ((A cold, A warm), (B
    cold, B warm)) medians of 20; B is (0, 0) where nothing survives."""
    import torch

    from symmer_torch.kernels import cuda

    lib, stream = cuda._lib(), cuda._stream(device)
    T, W = ka.shape[0], rows[0].shape[1]
    pass_a, scratch = merge_pass_a(ka, kb, cr, ci, threshold, device, live)
    sums = scratch.data_ptr()
    planes = torch.empty((2, n, W), dtype=torch.int64, device=device)
    out = torch.empty((3, n), dtype=torch.int64, device=device)
    o = out.data_ptr()

    def pass_b():
        status, epoch = cuda._look_back_status(device, stream, lib.symmer_merge_groups_tiles(T))
        cuda._raise("merge_groups", lib.symmer_merge_groups_gather(
            sums + 16 * T, sums, ka.data_ptr(), T, W, *cuda.source_args(rows), epoch,
            status.data_ptr(), planes[0].data_ptr(), planes[1].data_ptr(), o, o + 8 * n,
            o + 16 * n, stream))

    pass_a()
    return [cold_warm(fn, device, 20)[:2] if n or fn is pass_a else (0.0, 0.0)
            for fn in (pass_a, pass_b)]


def longest_group(ka, kb) -> int:
    """Rows of the longest run of equal keys in sorted order."""
    import torch

    from symmer_torch.kernels import torch_core

    perm = torch_core._lexsort(ka, kb)
    kas, kbs = ka[perm], kb[perm]
    new = torch.ones_like(kas, dtype=torch.bool)
    new[1:] = (kas[1:] != kas[:-1]) | (kbs[1:] != kbs[:-1])
    starts = torch.cat([new.nonzero().squeeze(1), new.new_full((1,), new.shape[0], dtype=torch.int64)])
    return int(torch.diff(starts).max())


def repeated_keys(ka) -> int:
    """Rows whose ka equals a neighbour's in sorted order (where pass A
    reads kb)."""
    import torch

    kas = torch.sort(ka).values
    same = kas[1:] == kas[:-1]
    rep = torch.zeros_like(kas, dtype=torch.bool)
    rep[1:] |= same
    rep[:-1] |= same
    return int(rep.sum())


def merge_check(device, shape, ka, kb, cr, ci, threshold, rows, live=None) -> dict:
    """K3 at one shape, on K17's sorted keys: bit for bit its plain version
    on the CPU (after the CPU's sort), the parent's output (the plain
    version after _lexsort) and a second launch, within COEFF_RTOL of its
    plain version on the card (torch's CUDA segment_reduce may add in
    another order), two launches a call, no split run; its passes timed
    apart (merge_pass_times), the wrapper's span with its host read, the
    plain version and the bound.  Prints a line and returns the JSON
    entry's fields."""
    from symmer_torch.kernels import cuda, torch_core

    perm, kas = cuda.sort_keys(ka)
    args = (perm, kas, ka, kb, cr, ci, threshold, rows, live)
    before = cuda.launches["merge_groups"]
    got = cuda.merge_groups(*args)
    per_call = cuda.launches["merge_groups"] - before
    assert got is not None, f"merge_groups found a split run at {shape}"
    again = cuda.merge_groups(*args)
    plain = torch_core.merge_groups(*args)
    cpu_ka, cpu_kb = ka.cpu(), kb.cpu()
    cpu_rest = (cr.cpu(), ci.cpu(), threshold, tuple(t.cpu() for t in rows),
                None if live is None else live.cpu())
    cpu = torch_core.merge_groups(*torch_core.sort_keys(cpu_ka), cpu_ka, cpu_kb, *cpu_rest)
    lex = torch_core._lexsort(cpu_ka, cpu_kb)
    parent = torch_core.merge_groups(lex, cpu_ka[lex], cpu_ka, cpu_kb, *cpu_rest, False)
    sync(device)
    n = got[0].shape[0]
    assert per_call == (2 if n else 1), f"merge_groups made {per_call} launches at {shape}"
    for g, a, w, q in zip(got, again, cpu, parent):
        assert same_bits(g.cpu(), w), f"merge_groups differs from its plain version at {shape}"
        assert same_bits(w, q), f"the sort by ka changed the merge's output at {shape}"
        assert same_bits(g, a), f"merge_groups not repeatable at {shape}"
    same_terms(got, plain, exact=False)
    err = max(float((g - p).abs().max()) if g.numel() else 0.0
              for g, p in zip(got[2:4], plain[2:4]))
    T, W = ka.shape[0], rows[0].shape[1]
    (a_cold, a_warm), (b_cold, b_warm) = merge_pass_times(ka, kb, cr, ci, rows, threshold, n,
                                                          device, live)
    w_cold, w_warm, spread = cold_warm(lambda: cuda.merge_groups(*args), device, 20)
    t_p = device_ms(lambda: torch_core.merge_groups(*args), device, reps=3)
    repeats = repeated_keys(ka)
    bound, bound_by = merge_bound(T, n, W, rows, live is not None, repeats)
    t_cold, t_warm = a_cold + b_cold, a_warm + b_warm
    no_lib = ("no single torch call sums sorted groups and compacts them in input order "
              "(segment_reduce, argsort and nonzero are the plain version's three)")
    source = ("planes", "pairs", "rotation", "masked")[cuda.row_source(rows)]
    say("2 kernels", kernel="merge_groups", shape=shape, rows=source,
        live_rows="all" if live is None else int(live.sum()), threshold=threshold,
        survivors=n, longest_group=longest_group(ka, kb), rows_with_repeated_ka=repeats,
        launches_per_call=per_call, bit_for_bit_plain_cpu=True, bit_for_bit_parent=True,
        repeatable=True, max_abs_err_plain_card=f"{err:.3e}", ms_l2_cold=f"{t_cold:.5f}",
        ms_l2_warm=f"{t_warm:.5f}", pass_a_cold=f"{a_cold:.5f}", pass_b_cold=f"{b_cold:.5f}",
        pass_a_warm=f"{a_warm:.5f}", pass_b_warm=f"{b_warm:.5f}",
        wrapper_span_cold=f"{w_cold:.5f}", wrapper_span_cold_range=spread,
        wrapper_span_warm=f"{w_warm:.5f}", plain_ms=f"{t_p:.5f}", bound_ms=f"{bound:.5f}",
        bound_by=bound_by, share_cold=f"{bound / t_cold:.5f}",
        share_warm=f"{bound / t_warm:.5f}", library_ms=f"null ({no_lib})")
    return dict(max_abs_err=err, ms=t_cold, ms_l2_warm=t_warm, pass_a_ms=a_cold,
                wrapper_span_ms=w_cold, plain_ms=t_p, bound_ms=bound, bound_by=bound_by,
                library_ms=None, library_null_reason=no_lib, shape=shape)


def peak_allocated_mb(fn, device):
    """Peak card memory allocated during one fn() call above what was
    allocated before it, in MiB (torch.cuda.max_memory_allocated)."""
    import torch

    sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    fn()
    sync(device)
    return f"{(torch.cuda.max_memory_allocated(device) - base) / 2**20:.3f}"


@contextlib.contextmanager
def host_syncs():
    """Yield a list that, when the block ends, holds the messages of the
    host synchronisations made inside it (torch's sync debug warnings, on
    only inside the block)."""
    import warnings

    import torch

    seen = []
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield seen
    finally:
        torch.cuda.set_sync_debug_mode("default")
    seen.extend(str(w.message) for w in caught if "synchroniz" in str(w.message))


def call_costs(fn, device) -> dict:
    """One warm fn() call's torch ops (aten ops without a parent op, from
    torch.profiler), kernel launches (the CUDA runtime's launch calls in the
    same trace), host synchronisations (host_syncs) and peak allocated
    memory above what was allocated before it."""
    from torch.profiler import ProfilerActivity, profile

    def traced():
        with host_syncs() as syncs:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
        out.update(events=prof.events(), syncs=syncs)

    out = {}
    fn()
    peak = peak_allocated_mb(traced, device)
    events = out["events"]
    return dict(
        torch_ops=sum(1 for e in events if e.name.startswith("aten::") and e.cpu_parent is None),
        kernel_launches=sum(1 for e in events if e.name in (
            "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx",
            "cudaLaunchCooperativeKernel")),
        host_syncs=len(out["syncs"]),
        peak_mb=peak)


def cleanup_costs(device, sizes) -> None:
    """Per device call, with this tree's symmer_torch: a cleanup_sorted of
    each cost_cleanups shape (the flagship's first 200,000 rows, tapered
    N2's 2,229), mul_pairs_cleanup of each cost_products shape (phase 5's
    square, the CS-VQE flows' 67 x 1 and 1 x 1), rotate_nonclifford_cleanup
    at each cost_rotations shape (phase 5's rotation, 1,000 terms, the
    chain's largest), clifford_project_cleanup at each proj_shapes taper's
    projection (the flagship's, LiH's): torch ops, kernel launches, host
    synchronisations and peak allocated memory (call_costs), and the median
    wall of 5 warm calls (host clock, synchronised).  Uses only entry points
    older trees also have (tools/ab_compare.py cleanup runs it on each
    tree)."""
    import torch

    from symmer_torch.kernels import torch_core

    to = lambda v: torch.tensor(np.ascontiguousarray(v).view(np.int64), device=device)
    calls = []
    for which, n in sizes["cost_cleanups"]:
        label, xp, zp = planes_of(which, n, sizes)
        x, z = to(xp), to(zp)
        c = np.random.default_rng(1).normal(size=(2, x.shape[0]))
        cr, ci = torch.tensor(c[0], device=device), torch.tensor(c[1], device=device)
        calls.append((f"cleanup_sorted_{label}_{x.shape[0]}x{x.shape[1]}words",
                      lambda a=(x, z, cr, ci): torch_core.cleanup_sorted(*a, 1e-15)))
    for shape in sizes["cost_products"]:
        label, ops = product_operands(device, shape, sizes)
        calls.append((f"mul_pairs_cleanup_{label}",
                      lambda ops=ops: torch_core.mul_pairs_cleanup(*ops, 1e-15)))
    for shape in sizes["cost_rotations"]:
        label, args, th = rotation_inputs(device, shape, sizes)
        calls.append((f"rotate_nonclifford_cleanup_{label}",
                      lambda a=args, th=th: torch_core.rotate_nonclifford_cleanup(*a, th)))
    for shape in sizes["proj_shapes"]:
        label, args, th = projection_inputs(device, shape, sizes)
        calls.append((f"clifford_project_cleanup_{label}",
                      lambda a=args, th=th: torch_core.clifford_project_cleanup(*a, th)))
    for label, fn in calls:
        costs = call_costs(fn, device)
        walls = []
        for _ in range(5):
            sync(device)
            t0 = time.perf_counter()
            fn()
            sync(device)
            walls.append((time.perf_counter() - t0) * 1e3)
        say("2 kernels", call=label, **costs, wall_ms=f"{np.median(walls):.3f}")


def merge_inputs(device, sizes):
    """Yield (shape, ka, kb, cr, ci, threshold, rows, main) of each K3 shape:
    each K4 output (pair_shapes, through its pair row source), the rows of
    sig_shapes with random coefficients (main: sig_main) and merge_shapes
    (merge_case)."""
    import torch

    from symmer_torch.kernels import cuda

    for which in sizes["pair_shapes"]:
        label, ops = product_operands(device, which, sizes)
        ka, kb, pr, pi = cuda.pair_products(*ops)
        yield (f"{label}_{ka.shape[0]}pairs", ka, kb, pr, pi, 1e-15,
               (ops[0], ops[1], ops[4], ops[5]), False)
    to = lambda v: torch.tensor(np.ascontiguousarray(v).view(np.int64), device=device)
    for which, rows in sizes["sig_shapes"]:
        label, xp, zp = planes_of(which, rows, sizes)
        x, z = to(xp), to(zp)
        T, W = x.shape
        c = np.random.default_rng(1).normal(size=(2, T))
        cr, ci = torch.tensor(c[0], device=device), torch.tensor(c[1], device=device)
        ka, kb = cuda.row_signature(x, z)
        yield (f"{label}_{T}x{W}words", ka, kb, cr, ci, 1e-15, (x, z),
               (which, rows) == tuple(sizes["sig_main"]))
    for kind, T, k in sizes["merge_shapes"]:
        shape, x, z, cr, ci, th = merge_case(kind, T, k, 16, device)
        ka, kb = cuda.row_signature(x, z)
        yield shape, ka, kb, cr, ci, th, (x, z), False


def pass_a_times(device, sizes) -> None:
    """K3's pass A alone (merge_pass_a, after the tree's sort), L2-cold and
    warm medians of 20, at every K3 shape (merge_inputs) beside its longest
    group: how its time grows with a group's length (tools/ab_compare.py
    merge runs it on each tree)."""
    for shape, ka, kb, cr, ci, th, rows, _ in merge_inputs(device, sizes):
        pass_a, _ = merge_pass_a(ka, kb, cr, ci, th, device)
        t_cold, t_warm, spread = cold_warm(pass_a, device, 20)
        say("2 kernels", kernel="merge_groups_pass_a", shape=shape,
            longest_group=longest_group(ka, kb), ms_l2_cold=f"{t_cold:.5f}",
            ms_l2_cold_range=spread, ms_l2_warm=f"{t_warm:.5f}")


def small_inputs(device, sizes):
    """Yield (label, (ka, kb, cr, ci, threshold, rows, live), main) of each
    small_shapes entry: the key kernels' outputs for a composite's
    arguments (composite_keys) or a merge_case's rows' signatures."""
    import torch

    from symmer_torch.kernels import cuda, torch_core

    to = lambda v: torch.tensor(np.ascontiguousarray(v).view(np.int64), device=device)
    for kind, which in sizes["small_shapes"]:
        if kind == "merge":
            label, x, z, cr, ci, th = merge_case(*which, 16, device)
            fn, args = torch_core.cleanup_sorted, (x, z, cr, ci, th)
        elif kind == "cleanup":
            label, xp, zp = planes_of(*which, sizes)
            x, z = to(xp), to(zp)
            c = np.random.default_rng(1).normal(size=(2, x.shape[0]))
            cr, ci = torch.tensor(c[0], device=device), torch.tensor(c[1], device=device)
            label = f"cleanup_{label}_{x.shape[0]}x{x.shape[1]}words"
            fn, args = torch_core.cleanup_sorted, (x, z, cr, ci, 1e-15)
        elif kind == "product":
            label, ops = product_operands(device, which, sizes)
            fn, args = torch_core.mul_pairs_cleanup, (*ops, 1e-15)
        elif kind == "rotation":
            label, args, th = rotation_inputs(device, which, sizes)
            fn, args = torch_core.rotate_nonclifford_cleanup, (*args, th)
        else:
            label, args, th = projection_inputs(device, which, sizes)
            label = f"projection_{label}"
            fn, args = torch_core.clifford_project_cleanup, (*args, th)
        ka, kb, pr, pi, rows, live = composite_keys(fn, args)
        assert ka.shape[0] <= cuda.SMALL_ROWS, f"{label}: {ka.shape[0]} slots"
        yield label, (ka, kb, pr, pi, args[-1], rows, live), (kind, which) == sizes["small_main"]


def merge_small_call(ka, kb, cr, ci, threshold, rows, live, device, lib=None):
    """K3's one-block route (symmer_merge_small of `lib`, by default the
    package's library) as a bare C call on a preallocated buffer (no
    allocation, no host read): the call, timed as the kernel's time."""
    import torch

    from symmer_torch.kernels import cuda

    lib, stream = lib or cuda._lib(), cuda._stream(device)
    T, W = ka.shape[0], rows[0].shape[1]
    buf = torch.empty(2 * T * W + 3 * T + 1, dtype=torch.int64, device=device)
    b = buf.data_ptr()
    o = b + 16 * T * W

    def call():
        cuda._raise("merge_small", lib.symmer_merge_small(
            ka.data_ptr(), kb.data_ptr(), cr.data_ptr(), ci.data_ptr(),
            None if live is None else live.data_ptr(), T, int(threshold is not None),
            0.0 if threshold is None else threshold, W, *cuda.source_args(rows), b,
            b + 8 * T * W, o, o + 8 * T, o + 16 * T, o + 24 * T, stream))

    return call


def fused_dims(kind, ops):
    """(T, W, M2) of a fused-route call's operands: a cleanup's planes (x,
    z, cr, ci), or a product's operands (x1, z1, cr1, ci1, x2, z2, cr2,
    ci2)."""
    if kind == "cleanup":
        return ops[0].shape[0], ops[0].shape[1], 0
    return ops[0].shape[0] * ops[4].shape[0], ops[0].shape[1], ops[4].shape[0]


def fused_call(kind, ops, threshold, device, lib=None):
    """The fused route (symmer_sign_merge_small of `lib`, by default the
    package's library) as a bare C call on a preallocated buffer (no
    allocation, no host read): the call, timed as the kernel's time."""
    import torch

    from symmer_torch.kernels import cuda

    lib, stream = lib or cuda._lib(), cuda._stream(device)
    T, W, M2 = fused_dims(kind, ops)
    buf = torch.empty(2 * T * W + 4 * T + 1, dtype=torch.int64, device=device)
    b = buf.data_ptr()
    o = b + 16 * T * W

    def call():  # (the operands' pointers taken here: the call keeps them alive)
        p = [t.data_ptr() for t in ops] + [0] * (8 - len(ops))
        cuda._raise("sign_merge_small", lib.symmer_sign_merge_small(
            cuda.PLANES if kind == "cleanup" else cuda.PAIRS, *p, M2, T, W,
            int(threshold is not None),
            0.0 if threshold is None else threshold, b, b + 8 * T * W, o, o + 8 * T,
            o + 16 * T, o + 32 * T, o + 24 * T, stream))

    return call


def two_launch_call(kind, ops, threshold, device):
    """The route the fused one replaces, as bare C calls on preallocated
    buffers: K2 (a cleanup's signatures) or K4 (a product's keys and
    coefficients), then K3's one-block route (merge_small_call).  Returns
    (both calls, the key kernel's call, the merge's call)."""
    import torch

    from symmer_torch.kernels import cuda

    lib, stream = cuda._lib(), cuda._stream(device)
    T, W, M2 = fused_dims(kind, ops)
    keys = torch.empty((2, T), dtype=torch.int64, device=device)
    coeffs = torch.empty((2, T), dtype=torch.float64, device=device)
    k, c = keys.data_ptr(), coeffs.data_ptr()
    if kind == "cleanup":
        x, z, cr, ci = ops
        rows = (x, z)

        def key_call():
            cuda._raise("row_signature", lib.symmer_row_signature(
                x.data_ptr(), z.data_ptr(), T, W, k, k + 8 * T, stream))
    else:
        cr, ci = coeffs[0], coeffs[1]
        rows = (ops[0], ops[1], ops[4], ops[5])

        def key_call():
            p = [t.data_ptr() for t in ops]
            cuda._raise("pair_products", lib.symmer_pair_products(
                *p[:4], T // M2, *p[4:], M2, W, k, k + 8 * T, c, c + 8 * T, stream))
    merge = merge_small_call(keys[0], keys[1], cr, ci, threshold, rows, None, device)

    def both():
        key_call()
        merge()

    return both, key_call, merge


def sign_blocks(T: int, W: int) -> int:
    """The blocks of the fused route's launch (symmer_sign_merge_small): the
    cluster (merge_small.cu's kCopyBlocks) where block 0's N / 4 threads in
    groups of L lanes a slot (L the power of two at or above W, at most 32)
    would take more than kSignRounds rounds of slots, else one."""
    from symmer_torch.kernels import cuda

    N, L = max(128, 1 << (T - 1).bit_length()), 1
    while L < W and L < 32:
        L *= 2
    rounds = -(-T * L // (N // 4))
    return 8 if rounds > cuda._source_constant("kSignRounds", "merge_small.cu") else 1


def fused_bound(kind, ops, n: int):
    """(ms, 'bytes' or 'operations'): the fused route reads each stored
    row's 2 W words and its coefficients once (a product: each operand
    row's), writes each of its n survivors' rows with its two sums and its
    key (16 W + 24 bytes) and the count (small_bound's output), and does
    the signing's 11 32-bit integer operations for each of a slot's 4 W
    half-words in each of 4 lanes (a product also its popcounts:
    pair_bound's count); its merge stays on the chip."""
    T, W, M2 = fused_dims(kind, ops)
    rows = T if kind == "cleanup" else T // M2 + M2
    t_bytes = (rows * (16 * W + 16) + n * (16 * W + 24) + 8) / HBM_BYTES_PER_S * 1e3
    if kind == "cleanup":
        t_ops = 11 * 4 * 4 * W * T / INT32_OPS_PER_S
    else:
        t_ops = max((44 * 4 * W + 2 * W) * T / INT32_OPS_PER_S,
                    (4 * W * T + 2 * W * rows) / POPC_OPS_PER_S)
    return larger(t_bytes, t_ops * 1e3)


# the L2-cold aims of the fused route, by shape label prefix (ms)
FUSED_AIMS = {"tapered_N2_1x1": 0.0135, "tapered_N2_67x1": 0.0165,
              "cleanup_tapered_N2": 0.021}


# the L2-cold aims of K3's one-block route, by shape label prefix (ms)
SMALL_AIMS = {"tapered_N2_1x1": 0.006, "tapered_N2_67x1": 0.008,
              "cleanup_tapered_N2": 0.015, "cleanup_flagship_4096": 0.030}


def phase_merge_small(device, sizes):
    """Phase 2, K3's one-block route (merge_small) at small_inputs: bit for
    bit its plain version on the CPU, the parent's composition (_lexsort,
    the plain merge) and a second launch, its integers equal to the plain
    version's on the card and its sums within 1e-12 relative (CUDA's
    segment_reduce), and bit for bit the large route (K17, K3's two passes)
    on the card; one launch a call by its counter, one kernel node and no
    other in a captured graph of its C call, and its kernel alone and no
    memset in the wrapper's trace.  Timed, L2 cold and warm, beside the parent's
    route on the same inputs in the same call: the kernel as a bare C call
    against K17 and K3's passes (merge_pass_times), and each route's
    wrapper span with its host read; the plain version, the bound
    (small_bound) and each aim (SMALL_AIMS; one group
    of 4,096 slots: the parent's K17 and passes).  Returns the JSON entry
    at small_main."""
    import torch

    from symmer_torch.kernels import cuda, torch_core

    report = {}
    no_lib = ("no single torch call groups, sums and compacts in first-occurrence order "
              "(the plain version is two argsorts, segment_reduce, argsort and nonzero)")
    for label, args, main in small_inputs(device, sizes):
        ka, kb, cr, ci, th, rows, live = args
        sync(device)
        before = dict(cuda.launches)
        got, again = cuda.merge_small(*args), cuda.merge_small(*args)
        sync(device)
        made = {k: v - before[k] for k, v in cuda.launches.items() if v != before[k]}
        assert made == {"merge_small": 2}, f"merge_small at {label} launched {made}"
        card = torch_core.merge_small(*args)
        cpu_rows = tuple(t.cpu() for t in rows)
        cpu_live = None if live is None else live.cpu()
        cpu_ka, cpu_kb = ka.cpu(), kb.cpu()
        want = torch_core.merge_small(cpu_ka, cpu_kb, cr.cpu(), ci.cpu(), th, cpu_rows, cpu_live)
        lex = torch_core._lexsort(cpu_ka, cpu_kb)
        parent = torch_core.merge_groups(lex, cpu_ka[lex], cpu_ka, cpu_kb, cr.cpu(), ci.cpu(), th,
                                         cpu_rows, cpu_live, False)
        perm, kas = cuda.sort_keys(ka)
        large = cuda.merge_groups(perm, kas, ka, kb, cr, ci, th, rows, live)
        assert large is not None, f"the large route found a split run at {label}"
        sync(device)
        for g, a, w, q, b in zip(got, again, want, parent, large):
            assert same_bits(g.cpu(), w), f"merge_small differs from its plain version at {label}"
            assert same_bits(w, q), f"merge_small's plain version is not the parent's at {label}"
            assert same_bits(g, a), f"merge_small not repeatable at {label}"
            assert same_bits(g, b), f"merge_small differs from the large route at {label}"
        same_terms(got, card, exact=False)
        err = max(float((g - p).abs().max()) if g.numel() else 0.0
                  for g, p in zip(got[2:4], card[2:4]))
        # one kernel a call and nothing else, by a captured graph's nodes of
        # the C call; the wrapper's trace holds that kernel, the count's copy
        # to the host and nothing else (no other kernel, no memset)
        nodes = graph_nodes(lambda: merge_small_call(*args, device)())
        assert nodes == {"kernel": 1}, f"a merge_small call's graph holds {nodes} at {label}"
        rows_ = kernel_device_us(lambda: cuda.merge_small(*args))
        names = {name for _, _, name in rows_ if not name.startswith("Memcpy")}
        assert len(names) == 1 and "merge_small_kernel" in names.pop(), \
            f"the profiler saw {rows_} a call at {label}"
        card_us = sum(t for t, _, name in rows_ if "merge_small" in name)
        T, W, n = ka.shape[0], rows[0].shape[1], got[0].shape[0]
        t_cold, t_warm, spread = cold_warm(merge_small_call(*args, device), device, 20)
        s_cold, s_warm, _ = cold_warm(lambda: cuda.merge_small(*args), device, 20)
        k_cold, k_warm, _ = cold_warm(lambda: cuda.sort_keys(ka), device, 20)
        (a_cold, a_warm), (b_cold, b_warm) = merge_pass_times(ka, kb, cr, ci, rows, th, n,
                                                              device, live)
        p_cold, p_warm, _ = cold_warm(
            lambda: cuda.merge_groups(*cuda.sort_keys(ka), ka, kb, cr, ci, th, rows, live),
            device, 20)
        t_p = device_ms(lambda: torch_core.merge_small(*args), device, reps=3)
        bound = small_bound(T, n, W, rows, live is not None)[0]
        parent_cold = k_cold + a_cold + b_cold
        aim = next((v for k, v in SMALL_AIMS.items() if label.startswith(k)), None)
        if label.startswith("one_group_4096"):
            aim = parent_cold
        source = ("planes", "pairs", "rotation", "masked")[cuda.row_source(rows)]
        say("2 kernels", kernel="merge_small", shape=label, rows=source, slots=T, words=W,
            live_slots="all" if live is None else int(live.sum()), threshold=th, survivors=n,
            longest_group=longest_group(ka, kb), launches_per_call=1,
            graph_kernel_nodes=1, kernel_card_us=f"{card_us:.2f}",
            bit_for_bit_plain_cpu=True, bit_for_bit_parent=True, bit_for_bit_large_route=True,
            repeatable=True, max_abs_err_plain_card=f"{err:.3e}", ms_l2_cold=f"{t_cold:.5f}",
            ms_l2_cold_range=spread, ms_l2_warm=f"{t_warm:.5f}", span_cold=f"{s_cold:.5f}",
            span_warm=f"{s_warm:.5f}", parent_sort_keys_cold=f"{k_cold:.5f}",
            parent_pass_a_cold=f"{a_cold:.5f}", parent_pass_b_cold=f"{b_cold:.5f}",
            parent_kernels_cold=f"{parent_cold:.5f}",
            parent_kernels_warm=f"{k_warm + a_warm + b_warm:.5f}",
            parent_span_cold=f"{p_cold:.5f}", parent_span_warm=f"{p_warm:.5f}",
            plain_ms=f"{t_p:.5f}", bound_ms=f"{bound:.7f}", bound_by="bytes",
            share_cold=f"{bound / t_cold:.5f}", library_ms=f"null ({no_lib})",
            aim_ms="-" if aim is None else f"{aim:.5f}",
            aim="-" if aim is None else ("held" if t_cold <= aim else "missed"))
        if main:
            report["merge_small"] = dict(
                max_abs_err=err, ms=t_cold, ms_l2_warm=t_warm, span_ms=s_cold,
                parent_route_ms=parent_cold, parent_span_ms=p_cold, plain_ms=t_p,
                bound_ms=bound, bound_by="bytes", library_ms=None, library_null_reason=no_lib,
                shape=label)
        del got, again, card, want, parent, large
    return report


def fused_inputs(device, sizes):
    """Yield (label, kind, operands, threshold, main) of each fused_shapes
    entry: a product's operands (product_operands) or a cleanup's planes
    with random coefficients (seed 1); the flagship's "budget" rows are
    cuda.FUSED_WORDS / W of them (at most cuda.SMALL_ROWS), "past" one
    more (none where that passes cuda.SMALL_ROWS)."""
    import torch

    from symmer_torch.kernels import cuda

    to = lambda v: torch.tensor(np.ascontiguousarray(v).view(np.int64), device=device)
    for kind, which in sizes["fused_shapes"]:
        main = (kind, which) == tuple(sizes["fused_main"])
        if kind == "product":
            label, ops = product_operands(device, which, sizes)
            yield label, kind, ops, 1e-15, main
            continue
        name, rows = which
        if rows in ("budget", "past"):
            _, xp, _ = planes_of(name, 1, sizes)
            rows = min(cuda.SMALL_ROWS, cuda.FUSED_WORDS // xp.shape[1]) + (rows == "past")
            if rows > cuda.SMALL_ROWS:
                continue
        label, xp, zp = planes_of(name, rows, sizes)
        x, z = to(xp), to(zp)
        c = np.random.default_rng(1).normal(size=(2, x.shape[0]))
        cr, ci = torch.tensor(c[0], device=device), torch.tensor(c[1], device=device)
        yield (f"cleanup_{label}_{x.shape[0]}x{x.shape[1]}words", kind, (x, z, cr, ci), 1e-15,
               main)


def phase_sign_merge_small(device, sizes):
    """Phase 2, the fused route (cleanup_small, product_small: merge_small.cu
    signing its slots) at fused_inputs: bit for bit its plain version on the
    CPU (row_signature or pair_products, then merge_small), the two launches
    it replaces on the card (K2 or K4, then K3's one-block route) and a
    second launch, its integers equal to the plain version's on the card and
    its sums within 1e-12 relative; one launch a call by its counter and one
    kernel node and nothing else in a captured graph of its C call.  Timed,
    L2 cold and warm, beside the two launches on the same inputs in the same
    call: the kernel as a bare C call against K2's or K4's and
    merge_small's (two_launch_call), and each route's wrapper span with its
    host read; the plain version, the bound (fused_bound) and the aims
    (FUSED_AIMS).  Returns the JSON entry at fused_main."""
    from symmer_torch.kernels import cuda, torch_core

    report = {}
    no_lib = ("no single torch call signs, groups, sums and compacts in first-occurrence "
              "order (the plain version is row_signature or pair_products, then merge_small)")
    for label, kind, ops, th, main in fused_inputs(device, sizes):
        wrapper = cuda.cleanup_small if kind == "cleanup" else cuda.product_small
        plain = torch_core.cleanup_small if kind == "cleanup" else torch_core.product_small
        key_fn = cuda.row_signature if kind == "cleanup" else cuda.pair_products
        T, W, M2 = fused_dims(kind, ops)
        rows = ops[:2] if kind == "cleanup" else (ops[0], ops[1], ops[4], ops[5])

        def two_launches():
            keys = key_fn(*ops[:2]) + tuple(ops[2:]) if kind == "cleanup" else key_fn(*ops)
            return cuda.merge_small(*keys, th, rows)

        sync(device)
        before = dict(cuda.launches)
        got, again = wrapper(*ops, th), wrapper(*ops, th)
        sync(device)
        made = {k: v - before[k] for k, v in cuda.launches.items() if v != before[k]}
        assert made == {"sign_merge_small": 2}, f"the fused route at {label} launched {made}"
        two = two_launches()
        card = plain(*ops, th)
        want = plain(*(t.cpu() for t in ops), th)
        sync(device)
        for g, a, w, q in zip(got, again, want, two):
            assert same_bits(g.cpu(), w), \
                f"the fused route differs from its plain version at {label}"
            assert same_bits(g, a), f"the fused route not repeatable at {label}"
            assert same_bits(g, q), f"the fused route differs from the two launches at {label}"
        assert same_bits(got[4], card[4]), f"the fused route's ka differs at {label}"
        same_terms(got, card, exact=False)
        err = max(float((g - p).abs().max()) if g.numel() else 0.0
                  for g, p in zip(got[2:4], card[2:4]))
        # (the call made inside the capture: it launches on the capture's stream)
        nodes = graph_nodes(lambda: fused_call(kind, ops, th, device)())
        call = fused_call(kind, ops, th, device)
        assert nodes == {"kernel": 1}, f"a fused call's graph holds {nodes} at {label}"
        n = got[0].shape[0]
        t_cold, t_warm, spread = cold_warm(call, device, 20)
        both, key_call, merge = two_launch_call(kind, ops, th, device)
        p_cold, p_warm, _ = cold_warm(both, device, 20)
        k_cold = launch_ms(key_call, device, cold=True)
        m_cold = launch_ms(merge, device, cold=True)
        s_cold, s_warm, _ = cold_warm(lambda: wrapper(*ops, th), device, 20)
        q_cold, q_warm, _ = cold_warm(two_launches, device, 20)
        t_p = device_ms(lambda: plain(*ops, th), device, reps=3)
        bound, bound_by = fused_bound(kind, ops, n)
        aim = next((v for k, v in FUSED_AIMS.items() if label.startswith(k)), None)
        say("2 kernels", kernel="sign_merge_small", shape=label, source=kind, slots=T, words=W,
            slot_words=T * W, cluster_signs=sign_blocks(T, W) > 1,
            fused_rule=cuda.small_fused(T, W),
            survivors=n, launches_per_call=1, graph_kernel_nodes=1, bit_for_bit_plain_cpu=True,
            bit_for_bit_two_launches=True, repeatable=True, max_abs_err_plain_card=f"{err:.3e}",
            ms_l2_cold=f"{t_cold:.5f}", ms_l2_cold_range=spread, ms_l2_warm=f"{t_warm:.5f}",
            two_launches_cold=f"{p_cold:.5f}", two_launches_warm=f"{p_warm:.5f}",
            key_kernel_cold=f"{k_cold:.5f}", merge_small_cold=f"{m_cold:.5f}",
            span_cold=f"{s_cold:.5f}", span_warm=f"{s_warm:.5f}",
            two_launch_span_cold=f"{q_cold:.5f}", two_launch_span_warm=f"{q_warm:.5f}",
            plain_ms=f"{t_p:.5f}", bound_ms=f"{bound:.3e}", bound_by=bound_by,
            share_cold=f"{bound / t_cold:.3e}", library_ms=f"null ({no_lib})",
            aim_ms="-" if aim is None else f"{aim:.5f}",
            aim="-" if aim is None else ("held" if t_cold <= aim else "missed"))
        if main:
            report["sign_merge_small"] = dict(
                max_abs_err=err, ms=t_cold, ms_l2_warm=t_warm, span_ms=s_cold,
                two_launch_ms=p_cold, two_launch_span_ms=q_cold, plain_ms=t_p, bound_ms=bound,
                bound_by=bound_by, library_ms=None, library_null_reason=no_lib, shape=label)
        del got, again, two, card, want
    return report


def phase_product_merge_kernels(device, sizes):
    """Phase 2, K4 (pair_products) at pair_shapes, each bit for bit its
    plain version on the card and the CPU and a second launch, timed cold
    and warm beside its bound and the plain version; K3 (merge_groups,
    merge_check) at every shape of merge_inputs: each K4 output through its
    pair row source, K2's shapes, repeating rows that cancel under a
    threshold that drops groups, one long group; then the calls' costs
    (cleanup_costs)."""
    from symmer_torch.kernels import cuda, torch_core

    report = {}
    for which in sizes["pair_shapes"]:
        label, ops = product_operands(device, which, sizes)
        M1, W = ops[0].shape
        M2 = ops[4].shape[0]
        got, again = cuda.pair_products(*ops), cuda.pair_products(*ops)
        plain = torch_core.pair_products(*ops)
        cpu = torch_core.pair_products(*(t.cpu() for t in ops))
        sync(device)
        for g, a, p, w in zip(got, again, plain, cpu):
            assert same_bits(g, p) and same_bits(g.cpu(), w), f"pair_products differs at {label}"
            assert same_bits(g, a), f"pair_products not repeatable at {label}"
        kernel = lambda: cuda.pair_products(*ops)
        t_cold, t_warm, spread = cold_warm(kernel, device, 20)
        t_p = device_ms(lambda: torch_core.pair_products(*ops), device, reps=3)
        bound, bound_by = pair_bound(M1, M2, W)
        no_lib = "no single torch call computes a product row's signature and phase"
        say("2 kernels", kernel="pair_products", shape=label, words=W, bit_for_bit_plain=True,
            repeatable=True, ms_l2_cold=f"{t_cold:.5f}", ms_l2_cold_range=spread,
            ms_l2_warm=f"{t_warm:.5f}", plain_ms=f"{t_p:.5f}", bound_ms=f"{bound:.5f}",
            bound_by=bound_by, share_cold=f"{bound / t_cold:.5f}",
            share_warm=f"{bound / t_warm:.5f}", library_ms=f"null ({no_lib})")
        if which == sizes["pair_main"]:
            report["pair_products"] = dict(
                max_abs_err=0, ms=t_cold, ms_l2_warm=t_warm, plain_ms=t_p, bound_ms=bound,
                bound_by=bound_by, library_ms=None, library_null_reason=no_lib, shape=label)
        del got, again, plain, cpu
    for shape, *args, main in merge_inputs(device, sizes):
        fields = merge_check(device, shape, *args)
        if main:
            report["merge_groups"] = fields
        del args
    cleanup_costs(device, sizes)
    return report


@contextlib.contextmanager
def captured_calls(module, name):
    """Yield a list that gets the arguments of each call of module.name made
    while the block runs."""
    seen = []
    fn = getattr(module, name)

    def wrapped(*args):
        seen.append(args)
        return fn(*args)

    setattr(module, name, wrapped)
    try:
        yield seen
    finally:
        setattr(module, name, fn)


def chain_operators(sizes):
    """(C1, C2, rotations) of phase 5's chain (seed 2): 1000-qubit operators
    of 2,000 and 200 terms, half of each I/Z-only, and five rotations."""
    rng = np.random.default_rng(2)
    nq, n1, n2 = sizes["chain"]
    C1 = random_operator(rng, nq, n1, 0.02, n_diagonal=n1 // 2)
    C2 = random_operator(rng, nq, n2, 0.02, n_diagonal=n2 // 2)
    return C1, C2, [(single_pauli(rng, nq, 0.02), a) for a in (0.3, None, np.pi, 0.7, -np.pi / 2)]


def rotation_inputs(device, which, sizes):
    """(label, (x, z, cr, ci, xr, zr, cos_t, sin_t), threshold) of a K6 shape
    on `device`: phase 5's rotation, 100,000 terms of a random 1000-qubit
    operator and a Pauli of density 0.3 at t = 0.3 ("mixed"), with Q the
    identity ("none") or a bit of each commuting term flipped so that every
    term anticommutes ("all"); "small", the same at rotation_small's 1,000
    terms; or "chain", the largest rotation of phase 5's chain, captured
    from torch_core.rotate_nonclifford_cleanup."""
    import torch

    from symmer_torch.kernels import torch_core

    if which == "chain":
        C1, C2, rots = chain_operators(sizes)
        with captured_calls(torch_core, "rotate_nonclifford_cleanup") as seen:
            C1.to_device().cleanup().multiply(C2.to_device()).perform_rotations(rots)
        args = max(seen, key=lambda a: a[0].shape[0])
        args = tuple(a.contiguous() if torch.is_tensor(a) else a for a in args)
        return f"chain_{args[0].shape[0]}x{args[0].shape[1]}words", args[:8], args[8]
    to = lambda v: torch.tensor(np.ascontiguousarray(v).view(np.int64), device=device)
    nq, nt = sizes["rotation_small" if which == "small" else "rotation"]
    rng = np.random.default_rng(6)
    B, r = random_operator(rng, nq, nt), single_pauli(rng, nq, 0.3)
    x, z, xr, zr = to(B.x_pack), to(B.z_pack), to(r.x_pack[0]), to(r.z_pack[0])
    if which == "none":
        xr, zr = torch.zeros_like(xr), torch.zeros_like(zr)
    if which == "all":  # flip x where zr has a bit and xr none: the parity flips
        w = int(torch.nonzero((zr & ~xr) != 0)[0])
        bit = (zr[w] & ~xr[w]) & -(zr[w] & ~xr[w])
        x[~torch_core.anticommutes_single(x, z, xr, zr), w] ^= bit
    c = B.coeff_vec
    cr, ci = (torch.tensor(np.ascontiguousarray(v), device=device) for v in (c.real, c.imag))
    label = f"rotation_{which}_{x.shape[0]}x{x.shape[1]}words"
    return label, (x, z, cr, ci, xr, zr, float(np.cos(0.3)), float(np.sin(0.3))), 1e-15


def projection_inputs(device, which, sizes):
    """(label, the arguments of torch_core.clifford_project_cleanup without
    its threshold, the threshold) captured from a resident taper on
    `device`: the flagship's (1000 qubits x 200,000 terms, 4 symmetries) or
    LiH's against its HF state."""
    import torch

    from symmer_torch import PauliwordOp, QubitTapering
    from symmer_torch.kernels import torch_core

    if which == "flagship":
        H = flagship_operator(tuple(sizes["flagship"]))
        ref = np.zeros(H.n_qubits, dtype=int)
    else:
        with open(LIH_FILE) as f:
            data = json.load(f)
        H = PauliwordOp.from_dictionary(data["hamiltonian"])
        ref = np.asarray(data["data"]["hf_array"])
    with captured_calls(torch_core, "clifford_project_cleanup") as seen:
        QubitTapering(H).taper_it(ref_state=ref, aux_operator=H.to_device())
    args = max(seen, key=lambda a: a[0].shape[0])
    args = tuple(a.contiguous() if torch.is_tensor(a) else a for a in args)
    return f"{which}_{args[0].shape[0]}x{args[0].shape[1]}words", args[:12], args[12]


def rows_kernel_check(device, name, label, args, bound):
    """K6 or K7 (cuda.<name>) at one shape: bit for bit its plain version on
    the card and on the CPU and a second launch, one launch a call; timed
    cold and warm beside its bound and the plain version.  Prints a line
    and returns the JSON entry's fields."""
    import torch

    from symmer_torch.kernels import cuda, torch_core

    kernel, plain = getattr(cuda, name), getattr(torch_core, name)
    before = cuda.launches[name]
    got = kernel(*args)
    per_call = cuda.launches[name] - before
    again, on_card = kernel(*args), plain(*args)
    cpu = plain(*(a.cpu() if torch.is_tensor(a) else a for a in args))
    sync(device)
    assert per_call == 1, f"{name} made {per_call} launches at {label}"
    for g, a, p, w in zip(got, again, on_card, cpu):
        assert same_bits(g, p) and same_bits(g.cpu(), w), f"{name} differs at {label}"
        assert same_bits(g, a), f"{name} not repeatable at {label}"
    t_cold, t_warm, spread = cold_warm(lambda: kernel(*args), device, 20)
    t_p = device_ms(lambda: plain(*args), device, reps=3)
    t_bound, bound_by = bound
    live = int(got[4].sum())
    no_lib = {"rotation_rows": "no torch call gives a term's and its P Q row's signatures and "
                               "coefficients",
              "project_rows": "no torch call gives a projected term's signature, sign and "
                              "stabilizer test"}[name]
    say("2 kernels", kernel=name, shape=label, slots=got[0].shape[0], live_slots=live,
        bit_for_bit_plain=True, repeatable=True, launches_per_call=per_call,
        ms_l2_cold=f"{t_cold:.5f}", ms_l2_cold_range=spread, ms_l2_warm=f"{t_warm:.5f}",
        plain_ms=f"{t_p:.5f}", bound_ms=f"{t_bound:.5f}", bound_by=bound_by,
        share_cold=f"{t_bound / t_cold:.5f}", share_warm=f"{t_bound / t_warm:.5f}",
        library_ms=f"null ({no_lib})")
    return got, dict(max_abs_err=0, ms=t_cold, ms_l2_warm=t_warm, plain_ms=t_p, bound_ms=t_bound,
                     bound_by=bound_by, library_ms=None, library_null_reason=no_lib, shape=label)


def phase_rotation_project_kernels(device, sizes):
    """Phase 2, K6 (rotation_rows) at rot_shapes and K7 (project_rows) at
    proj_shapes (rows_kernel_check; K7's inputs after K5 and K1 as the
    composite runs them), then K3 (merge_check) on each output with its
    live flags and its row source (the rotation's, the masked rows)."""
    import torch

    from symmer_torch.kernels import cuda, torch_core

    report = {}
    for which in sizes["rot_shapes"]:
        label, args, th = rotation_inputs(device, which, sizes)
        T, W = args[0].shape
        out, fields = rows_kernel_check(device, "rotation_rows", label, args, rotation_bound(T, W))
        if which == sizes["rot_main"]:
            report["rotation_rows"] = fields
        ka, kb, pr, pi, live = out
        merge_check(device, f"{label}_{2 * T}slots", ka, kb, pr, pi, th,
                    (args[0], args[1], args[4], args[5]), live)
        del args, out, ka, kb, pr, pi, live
    for which in sizes["proj_shapes"]:
        label, (x, z, cr, ci, rx, rz, rm, sx, sz, neg_x, neg_z, col_keep), th = \
            projection_inputs(device, which, sizes)
        if rx.shape[0]:
            x, z, cr, ci = cuda.clifford_scan(x, z, cr, ci, rx, rz, rm)
        ac = cuda.anticommutes(x, z, sx, sz)
        args = (x, z, cr, ci, ac, neg_x, neg_z, col_keep)
        T, W = x.shape
        label = f"{label}_{sx.shape[0]}stabilizers"
        out, fields = rows_kernel_check(device, "project_rows", label, args,
                                        project_bound(T, W, sx.shape[0]))
        if which == sizes["proj_main"]:
            report["project_rows"] = fields
        ka, kb, pr, pi, live = out
        merge_check(device, label, ka, kb, pr, pi, th, (x, z, col_keep), live)
        del args, out, x, z, ac
    torch.cuda.empty_cache()
    return report


def expval_inputs(device, sizes, which, B, rng):
    """Operator planes and a deduplicated state on `device` for K10, and a
    label of the shape.  B = "tapered_hf": the molecule tapered on the host
    against its tapered HF state (the main path's shape)."""
    import torch

    from symmer_torch.kernels import pack, torch_state

    if which == "flagship":
        H = flagship_operator(tuple(sizes["flagship"]))
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
        F, fixed, base, mS0, mCi, n_free = noref_search(noncontextual_part(entry[0]))
        g, b, off, n_cl = torch_noncon.kernel_inputs(F, fixed, base, mS0, mCi, device)
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


@contextlib.contextmanager
def counting_calls(module, name, shape=None):
    """Yield {"calls", "launches", "host_syncs", "shapes"}: the calls of
    module.name while the block runs, the kernel launches inside them
    (cuda.launches), their host synchronisations (host_syncs, on only
    inside the calls) and, given shape(args), a Counter of the calls'
    shapes."""
    import collections

    from symmer_torch.kernels import cuda

    seen = {"calls": 0, "launches": 0, "host_syncs": 0, "shapes": collections.Counter()}
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        if shape is not None:
            seen["shapes"][shape(args)] += 1
        before = sum(cuda.launches.values())
        try:
            with host_syncs() as syncs:
                return fn(*args, **kwargs)
        finally:
            seen["calls"] += 1
            seen["launches"] += sum(cuda.launches.values()) - before
            seen["host_syncs"] += len(syncs)

    setattr(module, name, wrapped)
    try:
        yield seen
    finally:
        setattr(module, name, fn)


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
        max_rel_err=f"{err:.2e}", device_best_ms=f"{t_dev:.2f}", host_best_ms=f"{t_host:.2f}",
        device_peak_allocated_mb=peak_allocated_mb(lambda: A * A, device))

    nq, nt = sizes["rotation"]
    B = random_operator(rng, nq, nt)
    r = single_pauli(rng, nq, 0.3)
    t_dev, dev_out, t_host, host_out = both(lambda: B.perform_rotations([(r, 0.3)]))
    err = compare_ops(dev_out, host_out)
    say("5 algebra", op=f"rotation_{nq}q_x_{B.n_terms}", out_terms=dev_out.n_terms,
        max_rel_err=f"{err:.2e}", device_best_ms=f"{t_dev:.2f}", host_best_ms=f"{t_host:.2f}",
        device_peak_allocated_mb=peak_allocated_mb(lambda: B.perform_rotations([(r, 0.3)]),
                                                   device))

    nq, n1, n2 = sizes["chain"]
    C1 = random_operator(rng, nq, n1, 0.02, n_diagonal=n1 // 2)
    C2 = random_operator(rng, nq, n2, 0.02, n_diagonal=n2 // 2)
    rots = [(single_pauli(rng, nq, 0.02), a) for a in (0.3, None, np.pi, 0.7, -np.pi / 2)]
    run_chain = lambda: C1.to_device().cleanup().multiply(C2.to_device()).perform_rotations(rots)
    t0 = time.perf_counter()
    chain = run_chain()
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
    t_warm, _ = best_of(run_chain, device)
    say("5 algebra", op=f"chain_{nq}q_{C1.n_terms}x{C2.n_terms}_rot{len(rots)}",
        out_terms=chain.n_terms, max_rel_err=f"{err:.2e}", expval_iz=repr(e_dev),
        wall_ms=f"{t_chain:.2f}", warm_best_ms=f"{t_warm:.2f}",
        device_peak_allocated_mb=peak_allocated_mb(run_chain, device))


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
        from symmer_torch.kernels import dispatch

        # the products' shapes: terms of each operand, words a row
        with counting_calls(dispatch, "multiply_cleanup",
                            lambda a: f"{a[0].shape[0]}x{a[3].shape[0]}x{a[0].shape[1]}w") as mul:
            cs_vqe_flow(name, n, True)
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
            device_run_device_calls=per_run["device"], device_run_host_calls=per_run["host"],
            multiply_cleanup_calls=mul["calls"],
            commonest_products=",".join(f"{k}:{v}" for k, v in mul["shapes"].most_common(3)),
            launches_per_multiply=f"{mul['launches'] / max(1, mul['calls']):.2f}",
            host_syncs_per_multiply=f"{mul['host_syncs'] / max(1, mul['calls']):.2f}")

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


def matvec_bound(G: int, T: int, n: int, b: int, rows: int = None, v_rows: int = None):
    """(ms, 'bytes' or 'operations', ms of the table design, ms of the
    recomputing design): the least card time of H @ V (b columns), or of
    `rows` of its output rows (a mesh's row block) that read `v_rows` rows
    of V (all 2^n by default).

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
    rows = 1 << n if rows is None else rows
    v_rows = 1 << n if v_rows is None else v_rows
    vec_bytes = 16 * b * (rows + v_rows)
    table = max((16 * G * rows + 8 * G + vec_bytes) / HBM_BYTES_PER_S,
                4 * G * rows * b / FP64_OPS_PER_S) * 1e3
    t_rec_ops = min(2 * T * rows / (1 << k) + G * rows * (2 * k + 4 * b)
                    for k in range(rows.bit_length())) / FP64_OPS_PER_S
    t_rec_bytes = (8 * G + 4 * (G + 1) + 20 * T + vec_bytes) / HBM_BYTES_PER_S
    recompute = max(t_rec_ops, t_rec_bytes) * 1e3
    if table <= recompute:
        return table, "bytes", table, recompute
    return recompute, ("operations" if t_rec_ops >= t_rec_bytes else "bytes"), table, recompute


def step_bound(dim: int):
    """(ms, 'bytes'): the least card time of one pass-1 step: hv, v_prev and
    v_cur read once, v_next written once (16 bytes a row each; hv is
    scratch, which the grid route also writes); its float64 operations
    (about 20 a row) take a sixteenth of that."""
    return 4 * 16 * dim / HBM_BYTES_PER_S * 1e3, "bytes"


def replay_bound(dim: int, m: int):
    """(ms, 'bytes'): the least card time of one pass-2 step with m Ritz
    vectors: hv, v_prev, v_cur and y read once, v_prev and y written once
    (16 bytes a row each); about 10 + 4 m float64 operations a row."""
    return (4 + 2 * m) * 16 * dim / HBM_BYTES_PER_S * 1e3, "bytes"


def ritz_bound(dim: int, k_eff: int, m: int):
    """(ms, 'bytes'): the least card time of pass 2 from a kept basis: k_eff
    basis rows and S read once, the m Ritz vectors written once; its 4
    float64 operations per (row, j, e) take a twentieth of that at m = 1."""
    return (16 * dim * (k_eff + m) + 8 * k_eff * m) / HBM_BYTES_PER_S * 1e3, "bytes"


def build_bound(G: int, T: int, n: int):
    """(ms, 'bytes' or 'operations'): the least card time of the table build:
    the table written once and the T terms (gidx, z_int, phase_c) read once,
    against n complex adds (2 float64 adds) per table entry."""
    dim = 1 << n
    t_bytes = (16 * G * dim + 32 * T) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * n * G * dim / FP64_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def csr_of(ux, D, r0: int = 0, r1: int = None):
    """torch CSR matrix (rows r, columns r ^ ux[g], values D[g, r]) of the
    X-grouped operator on D's device, columns sorted within each row; rows
    r0 .. r1 - 1 only (all by default)."""
    import torch

    G, dim = D.shape
    r1 = dim if r1 is None else r1
    rows = torch.arange(r0, r1, device=D.device)
    cols = rows[:, None] ^ ux[None, :]
    cols, order = torch.sort(cols, dim=1)
    vals = torch.gather(D[:, r0:r1].t(), 1, order)
    crow = torch.arange(0, r1 - r0 + 1, device=D.device) * G
    return torch.sparse_csr_tensor(crow, cols.reshape(-1), vals.reshape(-1), (r1 - r0, dim))


def phase_eigen_kernels(device, sizes):
    """Phase 7's kernel checks (before the counted run): K13's matvec and
    table build against their plain versions, timed."""
    import torch

    from symmer_torch.kernels import cuda, lanczos, torch_lanczos

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
        terms = lanczos.grouped_terms(ux, gidx, z_int, ph, device)
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
    # line's time) on the route its size rule takes, the other route where
    # it runs (the rule's evidence), the replay and pass 2 from a kept basis
    # at the drivers' k = 16 + 24 n (m = 1), each bit for bit its plain version
    bits = lambda t: torch.view_as_real(t).view(torch.int64) if t.is_complex() else t.view(torch.int64)
    blocks, cluster_rows = cuda.step_cluster()
    say("7 eigensolvers", step_cluster_blocks=blocks, step_cluster_max_rows=cluster_rows,
        step_routes=",".join(f"2^{n}:{cuda.lanczos_step_route(1 << n)}"
                             for n in sorted(set(dims))),
        basis_rule="(k + 1) 2^n x 16 B <= total_memory / 4")
    for n in sorted(set(dims), key=dims.index):
        dim = 1 << n
        vec = lambda: torch.tensor(rng.normal(size=dim) + 1j * rng.normal(size=dim), device=device)
        ops = (vec(), vec(), vec(), torch.zeros(8, dtype=torch.float64, device=device),
               torch.tensor(rng.random(8) + 0.5, device=device))
        S = torch.tensor(rng.normal(size=(8, 1)), device=device)
        y0 = torch.zeros((1, dim), dtype=torch.complex128, device=device)
        route = cuda.lanczos_step_route(dim)
        routes = [route] + [r for r in ("cluster", "grid")
                            if r != route and (r == "grid" or dim <= cluster_rows)]
        outs = {}
        for key, fn in ((r, functools.partial(cuda.lanczos_step, route=r)) for r in routes):
            for tag in (key, key + "_again", key + "_distinct"):
                hv, v_prev, v_cur, al, be = (t.clone() for t in ops)
                v_next = torch.full_like(v_prev, float("nan")) if tag.endswith("_distinct") else v_prev
                fn(hv, v_prev, v_cur, v_next, al, be, 3)
                outs[tag] = (hv, v_cur, v_next, al, be)
        hv, v_prev, v_cur, al, be = (t.clone() for t in ops)
        torch_lanczos.lanczos_step(hv, v_prev, v_cur, v_prev, al, be, 3)
        outs["plain"] = (hv, v_cur, v_prev, al, be)
        for key, fn in (("replay", cuda.lanczos_replay), ("replay_plain", torch_lanczos.lanczos_replay)):
            args = tuple(t.clone() for t in ops[:3]) + outs[route][3:]
            y = y0.clone()
            fn(*args, 3, S, y)
            outs[key] = (*args, y)
        sync(device)
        for key in outs:  # all but hv, the step's scratch
            if key.startswith(("cluster", "grid", "plain")):
                assert all(torch.equal(bits(a), bits(b))
                           for a, b in zip(outs[route][1:], outs[key][1:])), (
                    f"lanczos_step ({route}) differs from {key} at 2^{n}")
        assert all(torch.equal(bits(a), bits(b)) for a, b in zip(outs["replay"], outs["replay_plain"])), (
            f"lanczos_replay differs from its plain version at 2^{n}")
        assert torch.equal(bits(outs["replay"][1]), bits(outs[route][2])), (
            f"pass 2 does not rebuild pass 1's vector at 2^{n}")
        # pass 2 from a kept basis at the drivers' k
        k_eff = min(dim, 16 + 24 * n)
        gen = torch.Generator(device=device).manual_seed(n)
        basis = torch.randn((k_eff + 1, dim), dtype=torch.complex128, device=device, generator=gen)
        S_r = torch.tensor(rng.normal(size=(k_eff, 1)), device=device)
        got = cuda.lanczos_ritz(basis, S_r, k_eff)
        again = cuda.lanczos_ritz(basis, S_r, k_eff)
        want = torch_lanczos.ritz_from_basis(basis, S_r, k_eff)
        sync(device)
        assert torch.equal(bits(got), bits(want)) and torch.equal(bits(got), bits(again)), (
            f"lanczos_ritz differs from its plain version at 2^{n}, k_eff {k_eff}")
        del outs, got, again, want
        work = tuple(t.clone() for t in ops)
        y = y0.clone()
        label = f"2^{n}_rows"
        other = [r for r in routes if r != route]
        timed = [("lanczos_step", lambda: cuda.lanczos_step(*work[:3], work[1], *work[3:], 3),
                  lambda: torch_lanczos.lanczos_step(*work[:3], work[1], *work[3:], 3),
                  step_bound(dim), label, dict(step_route=route)),
                 ("lanczos_replay", lambda: cuda.lanczos_replay(*work, 3, S, y),
                  lambda: torch_lanczos.lanczos_replay(*work, 3, S, y), replay_bound(dim, 1),
                  label, {}),
                 ("lanczos_ritz", lambda: cuda.lanczos_ritz(basis, S_r, k_eff),
                  lambda: torch_lanczos.ritz_from_basis(basis, S_r, k_eff),
                  ritz_bound(dim, k_eff, 1), f"2^{n}_rows_k{k_eff}_m1", {})]
        for key, kernel, plain, (bound, bound_by), shape, extra in timed:
            t_cold, t_warm, spread = cold_warm(kernel, device, 20)
            t_p = device_ms(plain, device, reps=3)
            if key == "lanczos_step":
                for r in other:  # the same step forced onto the other route
                    oc, ow, _ = cold_warm(
                        lambda r=r: cuda.lanczos_step(*work[:3], work[1], *work[3:], 3, route=r),
                        device, 20)
                    extra.update({f"{r}_route_ms_l2_cold": f"{oc:.5f}",
                                  f"{r}_route_ms_l2_warm": f"{ow:.5f}"})
            say("7 eigensolvers", kernel=key, shape=shape, bitwise_equal=True, **extra,
                ms_l2_cold=f"{t_cold:.5f}", ms_l2_cold_range=spread, ms_l2_warm=f"{t_warm:.5f}",
                plain_ms=f"{t_p:.5f}", bound_ms=f"{bound:.5f}", bound_by=bound_by,
                share_cold=f"{bound / t_cold:.5f}", share_warm=f"{bound / t_warm:.5f}",
                library_ms="null (no single torch call)")
            if key not in report:
                report[key] = dict(
                    max_abs_err=0.0, ms=t_cold, ms_l2_warm=t_warm, plain_ms=t_p,
                    bound_ms=bound, bound_by=bound_by, library_ms=None, shape=shape,
                    library_null_reason=(
                        "no single torch call computes a Lanczos step" if key != "lanczos_ritz"
                        else "no single torch call adds the scaled rows in this order"), **extra)
        del work, ops, basis
        torch.cuda.empty_cache()

    # the scalar driver at tapered N2 (both passes, no state built) on both
    # pass-2 routes: the kept basis (the rule's at this size) and the replay
    # (the rule patched to refuse), bit for bit alike; the host time of one
    # call of each wrapper (enqueued, not waited on)
    H = tapered_molecule(sizes["eig_gs"])[0]
    planes = (H.x_pack, H.z_pack, H.coeff_vec, H.n_qubits)
    prep = lanczos.prepare_operator(*planes)
    keys = ("group_matvec", "lanczos_step", "lanczos_replay", "lanczos_ritz")
    runs = {}
    rule = lanczos.keeps_basis
    for pass2 in ("basis", "replay"):
        lanczos.keeps_basis = rule if pass2 == "basis" else (lambda *a: False)
        try:
            c0 = {k: cuda.launches[k] for k in keys}
            t_loop, out = best_of(lambda: lanczos.lanczos_ground_state(*planes, prepared=prep), device)
            per_run = {k: (cuda.launches[k] - c0[k]) // 4 for k in keys}
        finally:
            lanczos.keeps_basis = rule
        runs[pass2] = (t_loop, out, per_run)
    (e_b, v_b), (e_r, v_r) = runs["basis"][1], runs["replay"][1]
    assert np.array_equal(np.asarray(e_b).view(np.int64), np.asarray(e_r).view(np.int64)) and (
        np.array_equal(np.ascontiguousarray(v_b).view(np.int64),
                       np.ascontiguousarray(v_r).view(np.int64))), (
        "lanczos_ground_state: the basis and replay routes differ")
    assert runs["basis"][2]["lanczos_replay"] == 0 and runs["basis"][2]["lanczos_ritz"] == 1, (
        "tapered N2's pass 2 did not take the kept basis")
    dim = 1 << H.n_qubits
    V = torch.tensor(rng.normal(size=(1, dim)) + 0j, device=device)
    out = torch.empty_like(V)
    vecs = [V[0].clone() for _ in range(3)]
    scal = (torch.zeros(8, dtype=torch.float64, device=device),
            torch.ones(8, dtype=torch.float64, device=device))
    host = {"group_matvec": lambda: cuda.group_matvec(prep.ux, prep.off, prep.z, prep.ph, V, out=out),
            "lanczos_step": lambda: cuda.lanczos_step(*vecs, vecs[1], *scal, 3),
            "grid_step": lambda: cuda.lanczos_step(*vecs, vecs[1], *scal, 3, route="grid")}
    host_us = {}
    for k, fn in host.items():
        fn()
        sync(device)
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        host_us[k] = (time.perf_counter() - t0) / 200 * 1e6
        sync(device)
    for pass2, (t_loop, _, per_run) in runs.items():
        steps = per_run["lanczos_step"] + per_run["lanczos_replay"]
        say("7 eigensolvers", driver="lanczos_ground_state",
            system=f"tapered_{sizes['eig_gs'].split('_')[0]}_{H.n_qubits}q", pass2=pass2, step_route=cuda.lanczos_step_route(dim),
            pass1_steps_per_run=per_run["lanczos_step"],
            replay_steps_per_run=per_run["lanczos_replay"],
            ritz_launches_per_run=per_run["lanczos_ritz"],
            matvec_launches_per_run=per_run["group_matvec"], best_ms=f"{t_loop:.2f}",
            ms_per_pass1_step=f"{t_loop / max(1, per_run['lanczos_step']):.4f}",
            ms_per_step=f"{t_loop / max(1, steps):.4f}", bit_for_bit_across_routes=True,
            host_us_per_matvec_call=f"{host_us['group_matvec']:.1f}",
            host_us_per_step_call=f"{host_us['lanczos_step']:.1f}",
            host_us_per_grid_route_step_call=f"{host_us['grid_step']:.1f}")
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
    keys = ("group_matvec", "lanczos_step", "lanczos_replay", "lanczos_ritz")
    m0, s0, r0, z0 = (cuda.launches.get(k, 0) for k in keys)
    t_dev, (e_dev, psi) = best_of(lambda: exact_gs_energy_device(H), device)
    per_run = (cuda.launches.get("group_matvec", 0) - m0) // 4
    steps_per_run = (cuda.launches.get("lanczos_step", 0) - s0) // 4
    replays_per_run = (cuda.launches.get("lanczos_replay", 0) - r0) // 4
    ritz_per_run = (cuda.launches.get("lanczos_ritz", 0) - z0) // 4
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
        ritz_launches_per_run=ritz_per_run, device_best_ms=f"{t_dev:.1f}",
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
            m0, s0, r0, z0 = (cuda.launches.get(k, 0) for k in (
                "group_matvec", "lanczos_step", "lanczos_replay", "lanczos_ritz"))
            t0 = time.perf_counter()
            qsm, red = flow()
            sync(device)
            t_card = (time.perf_counter() - t0) * 1e3
            launched = cuda.launches.get("group_matvec", 0) - m0
            steps = cuda.launches.get("lanczos_step", 0) - s0
            replays = cuda.launches.get("lanczos_replay", 0) - r0
            ritz = cuda.launches.get("lanczos_ritz", 0) - z0
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
        replay_launches=replays, ritz_launches=ritz,
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


def rref_stack(entry, sizes):
    """(label, uint64[R, W]) for K11: rows of the 1000-qubit flagship's joint
    planes (bench.py:647-664 generator, W = 32), tapered N2's, or the
    symmetry search's transposed stack (symmetry_search_stack)."""
    from symmer_torch.kernels import pack

    what, arg = entry
    if what == "symmetry_search":
        nq, T = sizes["evo_symmetry"]
        M = symmetry_search_stack(nq, T, arg)
        label = f"symmetry_search_{nq}q_{T}terms_{'sketched' if arg else 'unsketched'}"
        return f"{label}_{M.shape[0]}x{M.shape[1]}", M
    if what == "flagship":
        op = synthetic_taper_operator(1000, arg, 4, 1)
        label = f"flagship_{op.n_terms}x32"
    else:
        op = tapered_molecule(what)[0]
        label = f"tapered_{what.split('_')[0]}_{op.n_terms}terms"
    M = pack.hstack_words(op.x_pack, op.z_pack)
    return f"{label}_W{M.shape[1]}", M


class _Captured(Exception):
    pass


@functools.lru_cache(maxsize=None)
def symmetry_search_stack(n_qubits: int, n_terms: int, sketch: bool):
    """uint64[2n, W]: the transposed stack [M; I] that
    IndependentOp.symmetry_generators hands to gf2.rref_packed for the
    synthetic taper operator, M the sketch's folded rows (sketch) or the
    operator's [Z|X] rows (gf2.kernel_basis_packed without the sketch),
    captured at that call."""
    from symmer_torch.kernels import gf2, pack

    op = synthetic_taper_operator(n_qubits, n_terms, 4, 1)
    real, box = gf2.rref_packed, []

    def capture(M, inplace=False):
        if M.shape[0] != 2 * n_qubits:
            return real(M, inplace)
        box.append(np.array(M, dtype=np.uint64))
        raise _Captured

    gf2.rref_packed = capture
    try:
        if sketch:
            gf2.kernel_basis_symplectic(op.z_pack, n_qubits, op.x_pack, n_qubits)
        else:
            gf2.kernel_basis_packed(pack.concat_bit_planes(op.z_pack, n_qubits, op.x_pack,
                                                           n_qubits), 2 * n_qubits, sketch=False)
    except _Captured:
        pass
    finally:
        gf2.rref_packed = real
    return box[0]


def phase_rref_kernels(device, sizes):
    """Phase 9's K11 checks: gf2_rref at each evo_rref shape bit for bit its
    plain version, the host's gf2core.rref_inplace and a second launch;
    passes and launches a call; L2-cold and warm times, the bound and the
    host crossover.  tools/ab_compare.py rref runs it on an older tree too,
    whose wrapper may not report passes (the per-pivot first cut's)."""
    import inspect

    import torch

    from symmer_torch.kernels import cuda, torch_gf2
    from symmer_torch.native import gf2core

    counts_passes = "stats" in inspect.signature(cuda.gf2_rref).parameters
    report, crossover = {}, []
    for entry in sizes["evo_rref"]:
        label, M = rref_stack(entry, sizes)
        R, W = M.shape
        host = M.copy()
        t0 = time.perf_counter()
        gf2core.rref_inplace(host)
        t_host = (time.perf_counter() - t0) * 1e3
        rank = int(host.any(axis=1).sum())
        M0 = torch.tensor(M.view(np.int64), device=device)
        want = torch_gf2.rref(M0.clone())
        sync(device)
        assert np.array_equal(want.cpu().numpy().view(np.uint64), host), (
            f"torch_gf2.rref differs from gf2core at {label}")
        reps = 20 if R * W < (1 << 20) else 5
        stats = {}
        l0 = cuda.launches["gf2_rref"]
        got = cuda.gf2_rref(M0.clone(), **({"stats": stats} if counts_passes else {}))
        launched = cuda.launches["gf2_rref"] - l0
        again = cuda.gf2_rref(M0.clone())
        sync(device)
        assert torch.equal(got, want), f"gf2_rref differs from its plain version at {label}"
        assert torch.equal(got, again), f"gf2_rref not repeatable at {label}"
        passes = int(stats["passes"]) if counts_passes else None
        copies = iter([M0.clone() for _ in range(2 * reps + 2)])
        cold, warm, spread = cold_warm(lambda: cuda.gf2_rref(next(copies)), device, reps)
        del copies, got, again
        t_p = device_ms(lambda: torch_gf2.rref(M0.clone()), device, reps=1)
        # the wrapper's route from host planes: upload, kernel, download
        t0 = time.perf_counter()
        cuda.gf2_rref(torch.from_numpy(M.view(np.int64)).to(device)).cpu()
        t_route = (time.perf_counter() - t0) * 1e3
        bound, bound_by = rref_bound(R, W, rank)
        crossover.append((label, t_route, t_host))
        say("9 evolution", kernel="gf2_rref", shape=label, rank=rank,
            bitwise_equal=True, passes_a_call=passes, launches_a_call=launched,
            ms_l2_cold=f"{cold:.5f}", ms_l2_cold_range=spread,
            ms_l2_warm=f"{warm:.5f}", plain_ms=f"{t_p:.5f}",
            bound_ms=f"{bound:.5f}", bound_by=bound_by, share_cold=f"{bound / cold:.5f}",
            host_gf2core_ms=f"{t_host:.3f}", card_route_with_copies_ms=f"{t_route:.3f}",
            library_ms="null (no single torch call)")
        if label.startswith(f"flagship_{sizes['evo_generators']}x"):
            report["gf2_rref"] = dict(
                max_abs_err=0.0, ms=cold, ms_l2_warm=warm, plain_ms=t_p,
                bound_ms=bound, bound_by=bound_by, library_ms=None,
                library_null_reason="no single torch call row-reduces over GF(2)",
                passes_a_call=passes, launches_a_call=launched,
                host_gf2core_ms=t_host, shape=label)
        del M0, want
        torch.cuda.empty_cache()
    say("9 evolution", k11_crossover=";".join(
        f"{l}:card_route_{c:.3f}ms_host_{h:.3f}ms" for l, c, h in crossover))
    return report


def phase_evolution_kernels(device, sizes):
    """Phase 9's kernel checks (before the counted run): K15a, K15c and K11
    against their plain versions, timed, with K11's host crossover."""
    import torch

    from symmer_torch.kernels import cuda, torch_vqe

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

    report.update(phase_rref_kernels(device, sizes))
    say("9 evolution", kernel_checks_wall_s=f"{time.perf_counter() - t_phase:.1f}")
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
    CircuitSymmerlator at the BASELINE Clifford shape, the generators of a
    flagship operator and the symmetry generators of a 1,100-qubit one, on
    the card."""
    import torch

    from symmer_torch import PauliwordOp
    from symmer_torch.operators import IndependentOp
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
    prep = lanczos.PreparedOperator(*lanczos.grouped_terms(ux, gidx, z_int, phc, device), None, n,
                                    0)
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

    # IndependentOp.symmetry_generators past 1,024 qubits: K11 on the
    # sketch's transposed stack (2n rows)
    nq, T = sizes["evo_symmetry"]
    op = synthetic_taper_operator(nq, T, 4, 1)
    t0 = time.perf_counter()
    sym, per_sym = counted(lambda: IndependentOp.symmetry_generators(op))
    walls["symmetry_card"] = (time.perf_counter() - t0) * 1e3
    config.backend = "host"
    t0 = time.perf_counter()
    sym_host = IndependentOp.symmetry_generators(op)
    walls["symmetry_host"] = (time.perf_counter() - t0) * 1e3
    config.backend = "device"
    assert np.array_equal(sym.x_pack, sym_host.x_pack) and np.array_equal(sym.z_pack, sym_host.z_pack)
    assert "gf2_rref:" in per_sym[0], f"symmetry_generators did not reach K11: {per_sym[0]}"
    say("9 evolution", flow="IndependentOp.symmetry_generators", terms=op.n_terms, qubits=nq,
        symmetries=sym.n_terms, equal_to_host=True, launches=per_sym[0],
        card_ms=f"{walls['symmetry_card']:.1f}", host_ms=f"{walls['symmetry_host']:.1f}")
    say("9 evolution", counted_flows_wall_s=f"{time.perf_counter() - t_phase:.1f}")


def route_bound(n: int, W: int):
    """(ms, 'bytes'): K16 reads every row once and writes it once (two
    planes of W words and two float64 coefficients, 16 W + 16 bytes each
    way) and reads its key (8 bytes); it does no arithmetic to speak of."""
    return (2 * (16 * W + 16) + 8) * n / HBM_BYTES_PER_S * 1e3, "bytes"


def same_bits(a, b) -> bool:
    """Equal shapes and equal bits (float64 compared as int64)."""
    import torch

    view = lambda t: t.view(torch.int64) if t.is_floating_point() else t
    return a.shape == b.shape and bool((view(a) == view(b)).all())


def phase_mesh_kernels(device, sizes):
    """Phase 10's kernel check, outside the counted run: K16 (route_rows) at
    the flagship's shard shape (its first 1/mesh_shards of the rows, keyed
    by their signatures, as round 0 of shard 0 routes them) bit for bit its
    plain version and a second launch, timed cold and warm beside its bound
    and the plain version."""
    import torch

    from symmer_torch.kernels import cuda, torch_core

    H = flagship_operator(tuple(sizes["flagship"]))
    n = -(-H.n_terms // sizes["mesh_shards"])
    to = lambda v: torch.tensor(np.ascontiguousarray(v).view(np.int64), device=device)
    f = lambda v: torch.tensor(np.ascontiguousarray(v, dtype=np.float64), device=device)
    x, z = to(H.x_pack[:n]), to(H.z_pack[:n])
    cr, ci = f(H.coeff_vec[:n].real), f(H.coeff_vec[:n].imag)
    key, _ = torch_core.row_signature(x, z)
    n, W = x.shape
    bufs = lambda: [tuple(torch.empty_like(t) for t in (x, z, cr, ci)) for _ in range(2)]
    got, again, plain = bufs(), bufs(), bufs()
    counts = [cuda.route_rows(x, z, cr, ci, key, 0, 0, *got),
              cuda.route_rows(x, z, cr, ci, key, 0, 0, *again),
              torch_core.route_rows(x, z, cr, ci, key, 0, 0, *plain)]
    sync(device)
    counts = [c.tolist() for c in counts]
    assert counts[0] == counts[1] == counts[2], f"route_rows counts {counts}"
    kept, sent = counts[0]
    for side, m in ((0, kept), (1, sent)):
        for a, b, c in zip(got[side], again[side], plain[side]):
            assert same_bits(a[:m], c[:m]), "route_rows differs from its plain version"
            assert same_bits(a[:m], b[:m]), "route_rows not repeatable"
    kernel = lambda: cuda.route_rows(x, z, cr, ci, key, 0, 0, *got)
    before = cuda.launches["route_rows"]
    kernel()
    per_call = cuda.launches["route_rows"] - before
    assert per_call == 1, f"route_rows launched {per_call} times a call"
    sync(device)
    t0 = time.perf_counter()
    for _ in range(200):  # nothing synchronised between the calls: the wrapper's host time
        kernel()
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    sync(device)
    t_cold, t_warm, spread = cold_warm(kernel, device, 20)
    t_p = device_ms(lambda: torch_core.route_rows(x, z, cr, ci, key, 0, 0, *plain), device,
                    reps=3)
    bound, bound_by = route_bound(n, W)
    no_lib = "no single torch call computes a stable partition into two buffers"
    shape = f"flagship_shard_{n}rows_{W}words"
    say("10 mesh", kernel="route_rows", shape=shape, kept=kept, sent=sent,
        bit_for_bit_plain=True, launches_per_call=per_call, wrapper_host_us=f"{host_us:.1f}",
        ms_l2_cold=f"{t_cold:.5f}", ms_l2_cold_range=spread,
        ms_l2_warm=f"{t_warm:.5f}", plain_ms=f"{t_p:.5f}", bound_ms=f"{bound:.5f}",
        bound_by=bound_by, share_cold=f"{bound / t_cold:.5f}",
        share_warm=f"{bound / t_warm:.5f}", library_ms=f"null ({no_lib})")
    report = {"route_rows": dict(max_abs_err=0.0, ms=t_cold, ms_l2_warm=t_warm, plain_ms=t_p,
                                 bound_ms=bound, bound_by=bound_by, library_ms=None,
                                 library_null_reason=no_lib, shape=shape)}
    for name in sizes["mesh_lanczos"]:
        row_range_kernel(device, name, sizes["mesh_shards"])
    return report


def row_range_kernel(device, name, n_shards):
    """K13 with a row range (a mesh shard's rows of the Lanczos matvec) at a
    tapered molecule, b = 1: each of the n_shards row blocks bit for bit
    the launch over every row and a second launch, and within 1e-13 of
    ||out|| of the plain version's rows (the kernel adds in another order,
    with FMAs), whose row block is bit for bit its own whole product's;
    the first block timed cold and warm beside its bound (the output rows'
    operations, the rows of V its X patterns reach), the plain version and
    cuSPARSE's CSR product on the block's rows of the table."""
    import torch

    from symmer_torch.kernels import cuda, lanczos, torch_lanczos

    H, ux, gidx, z_int, ph = grouped_inputs(name, True)
    G, T, n = ux.shape[0], gidx.shape[0], H.n_qubits
    dim = 1 << n
    step = dim // n_shards
    terms = lanczos.grouped_terms(ux, gidx, z_int, ph, device)
    V = torch.tensor(np.random.default_rng(11).normal(size=(1, dim)) + 0j, device=device)
    whole = cuda.group_matvec(*terms, V)
    plain_whole = torch_lanczos.terms_matvec(*terms, V)
    err = 0.0
    for s in range(n_shards):
        rows = (s * step, (s + 1) * step)
        got = cuda.group_matvec(*terms, V, rows=rows)
        again = cuda.group_matvec(*terms, V, rows=rows)
        plain = torch_lanczos.terms_matvec(*terms, V, rows=rows)
        sync(device)
        assert same_bits(torch.view_as_real(got), torch.view_as_real(whole[:, rows[0]:rows[1]])), (
            f"group_matvec rows {rows} differ from the whole launch's at {name}")
        assert same_bits(torch.view_as_real(got), torch.view_as_real(again)), (
            f"group_matvec rows {rows} not repeatable at {name}")
        assert same_bits(torch.view_as_real(plain),
                         torch.view_as_real(plain_whole[:, rows[0]:rows[1]])), (
            f"the plain row block {rows} differs from its whole product's at {name}")
        e = float((got - plain).abs().max() / torch.linalg.vector_norm(plain))
        assert e <= 1e-13, f"group_matvec rows {rows} vs plain at {name}: {e:.2e}"
        err = max(err, e)
    rows = (0, step)
    kernel = lambda: cuda.group_matvec(*terms, V, rows=rows)
    t_cold, t_warm, spread = cold_warm(kernel, device, 20)
    t_whole = launch_ms(lambda: cuda.group_matvec(*terms, V), device, cold=True)
    t_p = device_ms(lambda: torch_lanczos.terms_matvec(*terms, V, rows=rows), device, reps=1)
    as_t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)
    D = cuda.build_group_diagonals(as_t(gidx, torch.int64), as_t(z_int, torch.int64),
                                   as_t(ph, torch.complex128), G, n)
    csr = csr_of(terms[0], D, *rows)
    del D
    Vt = V.t().contiguous()
    lib = csr @ Vt
    sync(device)
    lib_err = float((lib.t() - whole[:, :step]).abs().max()
                    / torch.linalg.vector_norm(plain_whole[:, :step]))
    assert lib_err <= 1e-13, f"CSR yardstick of rows {rows} differs at {name}: {lib_err:.2e}"
    t_lib = launch_ms(lambda: csr @ Vt, device, cold=True)
    del csr
    # the rows of V the block reads: the blocks its X patterns' high bits reach
    reached = len(set((ux >> (n - (n_shards.bit_length() - 1))).tolist())) * step
    bound, bound_by, _, _ = matvec_bound(G, T, n, 1, rows=step, v_rows=reached)
    label = f"tapered_{name.split('_')[0]}_{G}x2^{n}_rows_{rows[0]}-{rows[1]}_of_{n_shards}_b1"
    say("10 mesh", kernel="group_matvec", rows=label, bit_for_bit_whole_launch=True,
        bit_for_bit_second_launch=True, plain_rel_err=f"{err:.2e}",
        plain_block_bit_for_bit_its_whole=True, ms_l2_cold=f"{t_cold:.5f}",
        ms_l2_cold_range=spread, ms_l2_warm=f"{t_warm:.5f}", whole_ms_l2_cold=f"{t_whole:.5f}",
        plain_ms=f"{t_p:.5f}", bound_ms=f"{bound:.5f}", bound_by=bound_by,
        v_rows_read=reached, share_cold=f"{bound / t_cold:.5f}",
        share_warm=f"{bound / t_warm:.5f}", library_ms=f"{t_lib:.5f}",
        library_rel_err=f"{lib_err:.2e}")
    torch.cuda.empty_cache()


def noncontextual_part(name):
    """The noncontextual part of the tapered molecule
    (NoncontextualOp.from_hamiltonian, "SingleSweep_magnitude", as
    ContextualSubspace builds it), built on the host."""
    from symmer_torch import config
    from symmer_torch.operators import NoncontextualOp

    H_taper, _ = tapered_molecule(name)
    backend, config.backend = config.backend, "host"
    try:
        return NoncontextualOp.from_hamiltonian(H_taper, strategy="SingleSweep_magnitude")
    finally:
        config.backend = backend


def noref_search(nc):
    """The arguments of torch_noncon.brute_force_minimise for a
    NoncontextualOp with every generator free (brute_inputs' search)."""
    F = (nc.G_indices == 1).astype(np.float64)
    return (F, np.zeros(F.shape[0]), (nc.coeff_vec * nc.pauli_mult_signs).real,
            nc.mask_S0.astype(np.float64), nc.mask_Ci.astype(np.float64), F.shape[1])


# each mesh driver of parallel/sharded.py (the dispatch route's kind in
# kernel_stats.mesh_calls) and the hand kernels it must launch itself
MESH_ROUTES = {
    "cleanup": ("cleanup", ("route_rows", "row_signature", "sort_keys", "merge_groups")),
    "multiply_cleanup": ("multiply", ("route_rows", "row_signature", "pair_products",
                                      "sort_keys", "merge_groups")),
    "perform_rotations": ("perform_rotations", ("route_rows", "row_signature", "sort_keys",
                                                "merge_groups", "rotation_rows")),
    "clifford_rotate_project": ("clifford_rotate_project",
                                ("route_rows", "anticommutes", "clifford_scan", "row_signature",
                                 "sort_keys", "merge_groups", "project_rows")),
    "expval": ("expval", ("expval",)),
}


@contextlib.contextmanager
def launches_inside_mesh_drivers():
    """Yield {driver: {kernel: launches}}, the launches made inside each
    mesh driver of parallel/sharded.py while the block runs (dispatch calls
    them through the module, so wrapping its attributes sees every call)."""
    from symmer_torch.kernels import cuda
    from symmer_torch.parallel import sharded

    inside = {name: dict.fromkeys(cuda.launches, 0) for name in MESH_ROUTES}

    def counting(name, driver):
        def wrapped(*args, **kwargs):
            before = dict(cuda.launches)
            try:
                return driver(*args, **kwargs)
            finally:
                for k, v in cuda.launches.items():
                    inside[name][k] += v - before[k]
        return wrapped

    drivers = {name: getattr(sharded, name) for name in MESH_ROUTES}
    for name, driver in drivers.items():
        setattr(sharded, name, counting(name, driver))
    try:
        yield inside
    finally:
        for name, driver in drivers.items():
            setattr(sharded, name, driver)


def mesh_cleanup_walls(device, sizes) -> None:
    """Phase 10's cleanup workload alone (mesh_cleanup: 200,000 rows of
    1000 qubits, each term 4 times; seed 3) on one device and on
    mesh_shards shards of the card, best of 3 warm runs each, the term sets
    alike (tools/ab_compare.py mesh runs it on each tree)."""
    from symmer_torch import PauliwordOp, use_mesh
    from symmer_torch.parallel.mesh import Mesh

    rng = np.random.default_rng(3)
    nq, nt, copies = sizes["mesh_cleanup"]
    base = random_operator(rng, nq, nt // copies)
    idx = rng.integers(0, base.n_terms, nt)
    D = PauliwordOp.from_planes(base.x_pack[idx], base.z_pack[idx],
                                rng.normal(size=nt) + 1j * rng.normal(size=nt), nq)
    t_one, single = best_of(lambda: D.cleanup(), device)
    with use_mesh(mesh=Mesh([device] * sizes["mesh_shards"])):
        t_mesh, sharded = best_of(lambda: D.cleanup(), device)
    err = compare_ops(sharded, single)
    say("10 mesh", op=f"cleanup_{nq}q_x_{nt}_{copies}copies", out_terms=sharded.n_terms,
        max_rel_err=f"{err:.2e}", one_device_best_ms=f"{t_one:.3f}",
        mesh_best_ms=f"{t_mesh:.3f}", mesh_over_one=f"{t_mesh / t_one:.3f}")


def phase_mesh(device, sizes, config, rng):
    """Phase 10, counted: the mesh routes on mesh_shards shards of the card
    (a Mesh of one device repeated), each flow against the port's
    one-device route (operators: term sets and 1e-12 relative; energies
    1e-10; the noncontextual search bit for bit) and timed both ways (best
    of 3 warm runs); then, with two cards or more, a cleanup over all of
    them.  The one-device runs come first and outside the count: returns
    the launches and wrapper calls made under use_mesh only, and asserts that each mesh
    driver launched its own kernels and that the search made one K12
    launch a shard."""
    import torch

    from symmer_torch import PauliwordOp, QuantumState, QubitTapering, use_mesh
    from symmer_torch.kernels import cuda, torch_noncon
    from symmer_torch.parallel.mesh import Mesh
    from symmer_torch.profiling import kernel_stats

    n_shards = sizes["mesh_shards"]
    mesh = Mesh([device] * n_shards)
    on_mesh = dict.fromkeys(cuda.launches, 0)  # this path's count
    mesh_calls = dict.fromkeys(cuda.calls, 0)  # and its wrapper calls

    def under_mesh(fn, on):
        before, called = dict(cuda.launches), dict(cuda.calls)
        with use_mesh(mesh=on):
            out = best_of(fn, device)
        for k, v in cuda.launches.items():
            on_mesh[k] += v - before[k]
            mesh_calls[k] += cuda.calls[k] - called[k]
        return out

    def both(kind, fn, on=mesh):
        t_one, single = best_of(fn, device)
        before = kernel_stats.mesh_calls[kind]
        with launches_inside_mesh_drivers() as inside:
            t_mesh, sharded = under_mesh(fn, on)
        assert kernel_stats.mesh_calls[kind] > before, f"{kind} did not run on the mesh"
        for name, (route, kernels) in MESH_ROUTES.items():
            if route == kind:
                idle = [k for k in kernels if inside[name][k] == 0]
                assert not idle, f"mesh driver {name} launched none of {idle}"
        return t_one, single, t_mesh, sharded

    def report(kind, label, single, sharded, t_one, t_mesh, **extra):
        err = compare_ops(sharded, single)
        say("10 mesh", route=kind, op=label, out_terms=sharded.n_terms, shards=n_shards,
            same_term_set=True, max_rel_err=f"{err:.2e}", one_device_best_ms=f"{t_one:.2f}",
            mesh_best_ms=f"{t_mesh:.2f}", mesh_over_one=f"{t_mesh / t_one:.3f}", **extra)

    nq, nt, ns, seed = sizes["flagship"]
    H = synthetic_taper_operator(nq, nt, ns, seed)
    qt = QubitTapering(H)
    ref = np.zeros(nq, dtype=int)
    t_one, single, t_mesh, sharded = both(
        "clifford_rotate_project", lambda: qt.taper_it(ref_state=ref))
    report("clifford_rotate_project", f"taper_{nq}q_x_{H.n_terms}", single, sharded, t_one,
           t_mesh)

    nq, nt = sizes["square"]
    A = random_operator(rng, nq, nt)
    t_one, single, t_mesh, sharded = both("multiply", lambda: A * A)
    report("multiply", f"square_{nq}q_x_{A.n_terms}", single, sharded, t_one, t_mesh)

    nq, nt = sizes["rotation"]
    B = random_operator(rng, nq, nt)
    r = single_pauli(rng, nq, 0.3)
    t_one, single, t_mesh, sharded = both(
        "perform_rotations", lambda: B.perform_rotations([(r, 0.3)]))
    report("perform_rotations", f"rotation_{nq}q_x_{B.n_terms}", single, sharded, t_one,
           t_mesh)

    nq, nt, copies = sizes["mesh_cleanup"]
    base = random_operator(rng, nq, nt // copies)
    idx = rng.integers(0, base.n_terms, nt)
    D = PauliwordOp.from_planes(base.x_pack[idx], base.z_pack[idx],
                                rng.normal(size=nt) + 1j * rng.normal(size=nt), nq)
    t_one, single, t_mesh, sharded = both("cleanup", lambda: D.cleanup())
    report("cleanup", f"cleanup_{nq}q_x_{nt}_{copies}copies", single, sharded, t_one, t_mesh)

    # the flagship against 1,024 rows spanned by 10 of its terms' X parts
    B_rows = sizes["mesh_expval"]
    gens = H.x_pack[rng.choice(H.n_terms, 10, replace=False)]
    s = rand_planes(rng, 1, H.n_qubits).repeat(B_rows, axis=0)
    for j in range(10):
        s[(np.arange(B_rows) >> j) & 1 == 1] ^= gens[j]
    amps = rng.normal(size=B_rows) + 1j * rng.normal(size=B_rows)
    psi = QuantumState.from_planes(s, amps / np.linalg.norm(amps), H.n_qubits)
    t_one, e_one, t_mesh, e_mesh = both("expval", lambda: H.expval(psi))
    err = rel_err(e_mesh, e_one)
    assert err <= ENERGY_TOL and abs(e_one) > 0, f"expval {e_mesh!r} vs {e_one!r}"
    say("10 mesh", route="expval", op=f"flagship_{H.n_terms}x{B_rows}rows", shards=n_shards,
        value=repr(e_mesh),
        one_device_value=repr(e_one), rel_err=f"{err:.2e}", one_device_best_ms=f"{t_one:.2f}",
        mesh_best_ms=f"{t_mesh:.2f}", mesh_over_one=f"{t_mesh / t_one:.3f}")

    # tapered N2's search over every assignment of its free generators
    # through NoncontextualOp.solve, split into one range a shard: the same
    # assignment and energy as the one-device search, one K12 launch a shard
    name = sizes["brute_main"][0]
    nc = noncontextual_part(name)

    def solve():
        nc.solve()
        return nc.energy, nc.symmetry_generators.coeff_vec.copy()

    before = cuda.launches["brute_force_minimise"]
    t_one, (e1, nu1) = best_of(solve, device)
    one_launches = cuda.launches["brute_force_minimise"] - before
    assert one_launches == 4, f"one-device solve: {one_launches} K12 launches in 4 solves"
    before = cuda.launches["brute_force_minimise"]
    t_mesh, (eN, nuN) = under_mesh(solve, mesh)
    per_solve = (cuda.launches["brute_force_minimise"] - before) / 4
    assert per_solve == n_shards, f"sharded solve: {per_solve} K12 launches a solve"
    assert np.array_equal(nuN, nu1) and np.float64(eN).view(np.int64) == np.float64(e1).view(
        np.int64), f"sharded solve ({eN!r}, {nuN}) vs one device ({e1!r}, {nu1})"
    # the kernel's own (energy, index), outside the count: bit for bit
    args = noref_search(nc)
    k1 = torch_noncon.brute_force_minimise(*args, device)
    kN = torch_noncon.brute_force_minimise(*args, device, mesh)
    assert kN[1] == k1[1] and np.float64(kN[0]).view(np.int64) == np.float64(k1[0]).view(
        np.int64), f"sharded brute force {kN!r} vs one device {k1!r}"
    say("10 mesh", route="brute_force_minimise", flow="NoncontextualOp.solve",
        op=f"tapered_{name.split('_')[0]}_noref", free_generators=args[-1], shards=n_shards,
        launches_a_solve=int(per_solve), energy=repr(eN), kernel_energy=repr(kN[0]),
        index=kN[1], bit_for_bit_one_device=True, one_device_best_ms=f"{t_one:.3f}",
        mesh_best_ms=f"{t_mesh:.3f}", mesh_over_one=f"{t_mesh / t_one:.3f}")

    mesh_solvers(device, sizes, mesh, under_mesh)

    cards = torch.cuda.device_count()
    if cards >= 2:
        n = 1 << (cards.bit_length() - 1)
        all_cards = Mesh([torch.device("cuda", i) for i in range(n)])
        t_one, single, t_mesh, sharded = both("cleanup", lambda: D.cleanup(), on=all_cards)
        report("cleanup", f"cleanup_{nq}q_x_{nt}_over_{n}_cards", single, sharded, t_one,
               t_mesh)
    else:
        say("10 mesh", all_cards="not run: one card (the shards above share cuda:0)")
    return on_mesh, mesh_calls


@contextlib.contextmanager
def counting_mesh_matvecs():
    """Yield {'calls': n}: the row-sharded matvecs (kernels/lanczos.py's
    _matvec_mesh, which the drivers call through the module) made while the
    block runs."""
    from symmer_torch.kernels import lanczos

    seen = {"calls": 0}
    plain = lanczos._matvec_mesh

    def wrapped(*args, **kwargs):
        seen["calls"] += 1
        return plain(*args, **kwargs)

    lanczos._matvec_mesh = wrapped
    try:
        yield seen
    finally:
        lanczos._matvec_mesh = plain


def mesh_solvers(device, sizes, mesh, under_mesh):
    """Phase 10's eigensolver and VQE flows: exact_gs_energy_device of the
    mesh_lanczos molecules (tapered N2; tapered MgH2, whose counted table,
    4 GiB, only the mesh's budget admits: the one-device route raises
    MemoryError, and its reference solve runs with the budget raised for
    that call only) and tapered MgH2's VQE energy and gradient (1,316
    generators, phase 9's inputs), each against the one-device route
    (1e-10) and timed both ways; each sharded matvec must make one K13
    launch (and its slice sum) a shard."""
    from symmer_torch.evolution import VQE_Driver
    from symmer_torch.kernels import cuda, lanczos
    from symmer_torch.profiling import kernel_stats
    from symmer_torch.utils import exact_gs_energy_device

    n_shards = mesh.size
    for i, name in enumerate(sizes["mesh_lanczos"]):
        H = tapered_molecule(name)[0]
        solve = lambda: exact_gs_energy_device(H)[0]
        refused = None
        budget = lanczos._D_BUDGET_BYTES
        if i == 1:  # the operator only the mesh's budget admits
            try:
                solve()
            except MemoryError as exc:
                refused = str(exc)
            assert refused, f"{name}: the one-device route solved without the mesh's budget"
            lanczos._D_BUDGET_BYTES = budget * n_shards
        try:
            t_one, e_one = best_of(solve, device)
        finally:
            lanczos._D_BUDGET_BYTES = budget
        before = cuda.launches["group_matvec"]
        calls = kernel_stats.mesh_calls["lanczos_ground_state"]
        with counting_mesh_matvecs() as seen:
            t_mesh, e_mesh = under_mesh(solve, mesh)
        assert kernel_stats.mesh_calls["lanczos_ground_state"] > calls, f"{name}: not on the mesh"
        per_matvec = (cuda.launches["group_matvec"] - before) / max(1, seen["calls"])
        slices = cuda._matvec_slices(1 << H.n_qubits, 1)
        want = n_shards * (1 + (slices > 1))
        assert seen["calls"] > 0 and per_matvec == want, (
            f"{name}: {per_matvec} K13 launches a sharded matvec, expected {want}")
        assert abs(e_mesh - e_one) <= ENERGY_TOL, f"{name}: mesh {e_mesh!r} vs one device {e_one!r}"
        say("10 mesh", flow="exact_gs_energy_device", system=f"tapered_{name.split('_')[0]}",
            qubits=H.n_qubits, shards=n_shards, energy=repr(float(e_mesh)),
            one_device_energy=repr(float(e_one)), abs_err=f"{abs(e_mesh - e_one):.2e}",
            bit_for_bit=bool(np.float64(e_mesh).view(np.int64) == np.float64(e_one).view(np.int64)),
            sharded_matvecs_in_4_runs=seen["calls"], k13_launches_a_matvec=int(per_matvec),
            one_device=(f"MemoryError without the mesh ({refused}); timed with the budget x"
                        f"{n_shards}" if refused else "solved"),
            one_device_best_ms=f"{t_one:.2f}", mesh_best_ms=f"{t_mesh:.2f}",
            mesh_over_one=f"{t_mesh / t_one:.3f}")

    name = sizes["evo_vqe"]
    H, cc, ref, _ = tapered_with_uccsd(name)
    drv = VQE_Driver(H, excitation_ops=cc, ref_state=ref)
    drv.verbose = False
    drv.expectation_eval = "device_array"
    x = 0.05 * np.random.default_rng(23).normal(size=drv.n_params)
    walls = {}
    for kind, fn in (("energy", lambda: drv.f(x)), ("gradient", lambda: drv.gradient(x))):
        walls[kind] = (best_of(fn, device), under_mesh(lambda: (fn(), drv._dev_engine.mesh), mesh))
    (t_e1, e1), (t_eN, (eN, m_e)) = walls["energy"]
    (t_g1, g1), (t_gN, (gN, m_g)) = walls["gradient"]
    assert m_e is mesh and m_g is mesh, f"VQE {name}: the engine did not take the mesh"
    g_err = float(np.abs(gN - g1).max())
    assert abs(eN - e1) <= ENERGY_TOL and g_err <= 1e-10, (
        f"VQE {name} on the mesh: energy {eN!r} vs {e1!r}, gradient {g_err:.2e}")
    say("10 mesh", flow="VQE_Driver(device_array)", system=f"tapered_{name.split('_')[0]}",
        generators=drv.n_params, terms=H.n_terms, shards=n_shards, energy=repr(eN),
        energy_abs_err=f"{abs(eN - e1):.2e}", gradient_max_abs_err=f"{g_err:.2e}",
        energy_one_device_best_ms=f"{t_e1:.3f}", energy_mesh_best_ms=f"{t_eN:.3f}",
        energy_mesh_over_one=f"{t_eN / t_e1:.3f}", gradient_one_device_best_ms=f"{t_g1:.3f}",
        gradient_mesh_best_ms=f"{t_gN:.3f}", gradient_mesh_over_one=f"{t_gN / t_g1:.3f}")


# the kernels of each counted path: phases 3-6 (taper, algebra, CS-VQE),
# phase 7 (the eigensolvers), phase 9 (the evolution slice) and phase 10
# (the mesh); the JSON line gives each kernel's launches on its first path
PATH_KERNELS = {
    "3-6": ("anticommutes", "clifford_scan", "expval", "brute_force_minimise", "row_signature",
            "pair_products", "sort_keys", "merge_groups", "rotation_rows", "project_rows",
            "merge_small", "sign_merge_small"),
    "7": ("group_matvec", "lanczos_step", "lanczos_ritz"),
    "9": ("vqe_rotate", "vqe_adjoint", "pauli_overlaps", "gf2_rref"),
    "10": ("route_rows", "anticommutes", "clifford_scan", "brute_force_minimise", "group_matvec",
           "lanczos_step", "lanczos_ritz", "vqe_rotate", "vqe_adjoint", "pauli_overlaps",
           "row_signature", "pair_products", "sort_keys", "merge_groups", "rotation_rows",
           "project_rows"),
}
# kept, built and held against their plain versions in phase 7, but off
# every path the drivers run at these sizes: the table build since the
# matvec recomputes the diagonals; the replay wherever keeps_basis admits
# the Krylov basis (every solve here; phase 7 times the replay route apart)
OFF_PATH = {"build_group_diagonals": "7", "lanczos_replay": "7"}


def run(device, sizes, config):
    """Phases 2-10 on the CUDA `device`; returns (kernel report, launch counts:
    each kernel's launches on its own path, each path counted from zero)."""
    import torch

    from symmer_torch.kernels import cuda
    from symmer_torch.profiling import kernel_stats

    rng = np.random.default_rng(0)
    config.device = device
    report = phase_kernels(device, sizes, rng)
    report.update(phase_signature_kernel(device, sizes))
    report.update(phase_sort_kernel(device, sizes))
    phase_composite_sorts(device, sizes)
    report.update(phase_product_merge_kernels(device, sizes))
    report.update(phase_merge_small(device, sizes))
    report.update(phase_sign_merge_small(device, sizes))
    report.update(phase_rotation_project_kernels(device, sizes))
    report.update(phase_state_kernels(device, sizes, rng))
    report.update(phase_eigen_kernels(device, sizes))
    report.update(phase_evolution_kernels(device, sizes))
    report.update(phase_mesh_kernels(device, sizes))
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
    calls = {"3-6": dict(cuda.calls)}
    repairs = {"3-6": cuda.sort_repairs}
    print(kernel_stats.summary(), flush=True)
    cuda.reset_launches()
    kernel_stats.reset()
    phase_eigensolvers(device, sizes, config)
    counts["7"] = dict(cuda.launches)
    calls["7"] = dict(cuda.calls)
    repairs["7"] = cuda.sort_repairs
    print(kernel_stats.summary(), flush=True)
    torch.cuda.empty_cache()
    cuda.reset_launches()
    kernel_stats.reset()
    phase_evolution(device, sizes, config)
    counts["9"] = dict(cuda.launches)
    calls["9"] = dict(cuda.calls)
    repairs["9"] = cuda.sort_repairs
    print(kernel_stats.summary(), flush=True)
    torch.cuda.empty_cache()
    cuda.reset_launches()
    kernel_stats.reset()
    counts["10"], calls["10"] = phase_mesh(device, sizes, config, rng)
    repairs["10"] = cuda.sort_repairs
    print(kernel_stats.summary(), flush=True)
    for path, c in counts.items():
        say("8 coverage", phases=path, sort_repairs=repairs[path],
            **{f"launches_{k}": v for k, v in c.items()})
        # K3's calls by route: the fused route (its slots signed in the
        # launch), one block after K2 or K4 and the other key kernels
        # (merge_small), or K17 and two passes
        say("8 coverage", phases=path, k3_calls_fused=calls[path]["sign_merge_small"],
            k3_calls_one_block=calls[path]["merge_small"],
            k3_calls_two_pass=calls[path]["merge_groups"],
            k17_calls=calls[path]["sort_keys"], k2_calls=calls[path]["row_signature"],
            k4_calls=calls[path]["pair_products"])
    # a repair runs only where two signatures share ka (about T^2 / 2^65)
    assert not any(repairs.values()), f"the sort by ka was repaired on the main path: {repairs}"
    assert counts["7"]["build_group_diagonals"] == 0, "the drivers built a group-diagonal table"
    missing = [f"{k} (phases {path})" for path, names in PATH_KERNELS.items() for k in names
               if counts[path][k] == 0]
    assert not missing, f"kernels not launched on their path: {missing}"
    launches = {}
    for path, names in PATH_KERNELS.items():
        for k in names:
            launches.setdefault(k, counts[path][k])
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
        "lanczos_ritz": ("symmer_torch/csrc/lanczos_step.cu",
                         "symmer_tpu/kernels/jx_lanczos.py:682 (_ritz_segment_fn's "
                         "accumulation of the Ritz vectors, its accum at :673)"),
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
        "route_rows": ("symmer_torch/csrc/route_rows.cu",
                       "symmer_tpu/parallel/distributed.py:68 (_exchange_round's keep/send "
                       "split and _compact, :48)"),
        "row_signature": ("symmer_torch/csrc/row_signature.cu",
                          "symmer_tpu/kernels/jx_core.py:205 (row_hashes, the cleanup's "
                          "grouping signature)"),
        "pair_products": ("symmer_torch/csrc/pair_products.cu",
                          "symmer_tpu/kernels/jx_core.py:531 (mul_pairs_cleanup's product "
                          "half, :531-559; mul_pairs, :171)"),
        "merge_groups": ("symmer_torch/csrc/merge_groups.cu",
                         "symmer_tpu/kernels/jx_core.py:255 (cleanup_sorted's default route: "
                         "_cleanup_from_hashes, :416, its segmented sum, :390)"),
        "merge_small": ("symmer_torch/csrc/merge_small.cu",
                        "symmer_tpu/kernels/jx_core.py:255 (cleanup_sorted's default route: "
                        "the sort of :303 and _cleanup_from_hashes, :416, its segmented sum, "
                        ":390, at up to 4,096 slots; the row sources of :531, :682, :728)"),
        "sign_merge_small": ("symmer_torch/csrc/merge_small.cu",
                             "symmer_tpu/kernels/jx_core.py:205 (row_hashes, K2's), :255 and "
                             ":416 (cleanup_sorted and _cleanup_from_hashes, K3's) and :531 "
                             "(mul_pairs_cleanup's product half, K4's), for a cleanup or a "
                             "product within cuda.small_fused"),
        "rotation_rows": ("symmer_torch/csrc/rotation_rows.cu",
                          "symmer_tpu/kernels/jx_core.py:682 (rotate_nonclifford_cleanup's "
                          "rotation half: _rotate_nc_parts, the two hash passes h_first and "
                          "h_second)"),
        "sort_keys": ("symmer_torch/csrc/sort_keys.cu",
                      "symmer_tpu/kernels/jx_core.py:303 (cleanup_sorted's jnp.lexsort of the "
                      "row hashes; its lax.sort calls at :448-517)"),
        "project_rows": ("symmer_torch/csrc/project_rows.cu",
                         "symmer_tpu/kernels/jx_core.py:728 (clifford_project_cleanup after its "
                         "scan and filter: the sign flips, the column mask, the hashes and the "
                         "live flags)"),
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
