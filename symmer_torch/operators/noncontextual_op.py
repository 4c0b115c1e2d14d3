"""Noncontextual Hamiltonians and their classical optimisation.

API parity with symmer ``operators/noncontextual_op.py``.  The classical
objective over nu-assignments is evaluated in dense float64 contractions
(sign-parity, symmetry and clique sums), replacing the reference's
per-assignment process-pool map (reference :686-738).  Large brute-force
searches enumerate the assignments ON THE DEVICE in the
``brute_force_minimise`` kernel (kernels/torch_noncon.py,
csrc/noncon_brute.cu); nothing of the search space is materialised.
"""
from __future__ import annotations

import itertools
import warnings
from functools import cached_property, reduce
from time import time
from typing import List, Optional, Tuple, Union

import numpy as np

from ..config import config
from .base import PauliwordOp, QuantumState
from .independent_op import IndependentOp
from .anticommuting_op import AntiCommutingOp
from .utils import binomial_coefficient, perform_noncontextual_sweep


class NoncontextualOp(PauliwordOp):
    """H = sum(G-part) + sum_i C_i (G-part), arXiv:1904.02260.

    (reference noncontextual_op.py:16-654)
    """

    up_method = "seq_rot"

    def __init__(self, symp_matrix, coeff_vec):
        super().__init__(symp_matrix, coeff_vec)
        self._post_init()

    def _post_init(self):
        assert self.is_noncontextual, "Specified operator is contextual."
        self.noncontextual_generators()
        self.noncontextual_reconstruction()

    @classmethod
    def from_planes(cls, x_pack, z_pack, coeff_vec, n_qubits) -> "NoncontextualOp":
        op = cls.__new__(cls)
        op._init_from_planes(x_pack, z_pack, coeff_vec, n_qubits)
        op._post_init()
        return op

    @classmethod
    def from_PauliwordOp(cls, H) -> "NoncontextualOp":
        return cls.from_planes(H.x_pack, H.z_pack, H.coeff_vec, H.n_qubits)

    @classmethod
    def from_hamiltonian(
        cls,
        H: PauliwordOp,
        strategy: str = "diag",
        generators: PauliwordOp = None,
        stabilizers: IndependentOp = None,
        DFS_runtime: int = 10,
        use_jordan_product=False,
        override_noncontextuality_check: bool = False,
    ) -> "NoncontextualOp":
        """Extract a noncontextual sub-Hamiltonian (reference :63-106).

        ``override_noncontextuality_check`` defaults to False as in the
        reference: an already-noncontextual H short-circuits with a warning.
        Pass True to skip the O(M^2) check when H is known to be contextual.
        """
        if not override_noncontextuality_check:
            if H.is_noncontextual:
                warnings.warn("input H is already noncontextual ignoring strategy")
                return cls.from_PauliwordOp(H)
        if strategy == "diag":
            return cls._diag_noncontextual_op(H)
        elif strategy == "generators":
            return cls._from_generators_noncontextual_op(
                H, generators, use_jordan_product=use_jordan_product
            )
        elif strategy == "stabilizers":
            return cls._from_stabilizers_noncontextual_op(
                H, stabilizers, use_jordan_product=use_jordan_product
            )
        elif strategy.find("DFS") != -1:
            _, strategy = strategy.split("_")
            return cls._dfs_noncontextual_op(H, strategy=strategy, runtime=DFS_runtime)
        elif strategy.find("SingleSweep") != -1:
            _, strategy = strategy.split("_")
            return cls._single_sweep_noncontextual_operator(H, strategy=strategy)
        raise ValueError(f"Unrecognised noncontextual operator strategy {strategy}")

    @classmethod
    def _diag_noncontextual_op(cls, H: PauliwordOp) -> "NoncontextualOp":
        mask_diag = ~np.any(H.X_block, axis=1)
        return cls.from_planes(
            H.x_pack[mask_diag], H.z_pack[mask_diag], H.coeff_vec[mask_diag], H.n_qubits
        )

    @classmethod
    def _dfs_noncontextual_op(cls, H: PauliwordOp, runtime=10, strategy="magnitude"):
        """Rolled noncontextual sweeps within a time budget (reference :126-169)."""
        operator = H.sort(by="magnitude")
        noncontextual_ops = []
        n = 0
        start_time = time()
        while n < H.n_terms and time() - start_time < runtime:
            order = np.roll(np.arange(H.n_terms), -n)
            ordered_operator = PauliwordOp.from_planes(
                operator.x_pack[order], operator.z_pack[order],
                operator.coeff_vec[order], operator.n_qubits,
            )
            noncontextual_ops.append(perform_noncontextual_sweep(ordered_operator))
            n += 1
        if strategy == "magnitude":
            best = sorted(noncontextual_ops, key=lambda x: -np.sum(abs(x.coeff_vec)))[0]
        elif strategy == "largest":
            best = sorted(noncontextual_ops, key=lambda x: -x.n_terms)[0]
        else:
            raise ValueError("Unrecognised noncontextual operator strategy.")
        return cls.from_PauliwordOp(best)

    @classmethod
    def _diag_first_noncontextual_op(cls, H: PauliwordOp):
        noncontextual_operator = cls._diag_noncontextual_op(H)
        off_diag_terms = (H - noncontextual_operator).sort(by="magnitude")
        for term in off_diag_terms:
            if (noncontextual_operator + term).is_noncontextual:
                noncontextual_operator += term
        return cls.from_PauliwordOp(noncontextual_operator)

    @classmethod
    def _single_sweep_noncontextual_operator(cls, H, strategy="magnitude"):
        if strategy == "magnitude":
            operator = H.sort(by="magnitude")
        elif strategy == "random":
            order = np.arange(H.n_terms)
            np.random.shuffle(order)
            operator = PauliwordOp.from_planes(
                H.x_pack[order], H.z_pack[order], H.coeff_vec[order], H.n_qubits
            )
        elif strategy == "CurrentOrder":
            operator = H
        else:
            raise ValueError(
                "Unrecognised strategy, must be one of magnitude, random or CurrentOrder"
            )
        return cls.from_PauliwordOp(perform_noncontextual_sweep(operator))

    @classmethod
    def _from_generators_noncontextual_op(
        cls, H: PauliwordOp, generators: PauliwordOp, use_jordan_product: bool = False
    ):
        assert generators is not None, "Must specify a noncontextual generating set."
        assert generators.is_noncontextual, "Generating set is contextual."
        if use_jordan_product:
            _, noncontextual_terms_mask = H.jordan_generator_reconstruction(generators)
        else:
            _, noncontextual_terms_mask = H.generator_reconstruction(
                generators, override_independence_check=True
            )
        return cls.from_PauliwordOp(H[noncontextual_terms_mask])

    @classmethod
    def random(
        cls,
        n_qubits: int,
        n_cliques: Optional[int] = 3,
        complex_coeffs: Optional[bool] = False,
        n_commuting_terms: Optional[int] = None,
        apply_clifford: Optional[bool] = True,
    ) -> "NoncontextualOp":
        """Random noncontextual operator with clique structure (reference :253-353)."""
        from ..utils import random_anitcomm_2n_1_PauliwordOp

        assert n_cliques > 1 or n_cliques == 0, (
            "number of cliques must be zero or set to 2 or more "
            "(cannot have one anticommuting term)"
        )
        n_clique_qubits = int(np.ceil((n_cliques - 1) / 2))
        assert n_clique_qubits <= n_qubits, (
            f"cannot have {n_cliques} anticommuting cliques on {n_qubits} qubits"
        )
        remaining_qubits = n_qubits - n_clique_qubits
        if n_commuting_terms:
            assert n_commuting_terms <= 2**remaining_qubits, (
                f"cannot have {n_commuting_terms} commuting operators "
                f"on {remaining_qubits} qubits"
            )
        elif n_qubits == n_clique_qubits:
            n_commuting_terms = 0

        if remaining_qubits >= 1:
            if n_commuting_terms is None:
                n_commuting_terms = 2**remaining_qubits
                XZ_block = (
                    (np.arange(n_commuting_terms)[:, None]
                     & (1 << np.arange(2 * remaining_qubits))[::-1]) > 0
                ).astype(bool)
            elif n_commuting_terms == 0:
                XZ_block = np.zeros(2 * remaining_qubits, dtype=bool).reshape([1, -1])
            else:
                indices = np.random.choice(
                    np.arange(0, 2**remaining_qubits), size=n_commuting_terms, replace=False
                )
                XZ_block = (
                    (indices[:, None] & (1 << np.arange(2 * remaining_qubits))[::-1]) > 0
                ).astype(bool)

        if n_cliques == 0:
            H_nc = PauliwordOp(XZ_block, np.ones(XZ_block.shape[0]))
        else:
            AC = random_anitcomm_2n_1_PauliwordOp(n_clique_qubits, apply_clifford=True)[
                : n_cliques
            ]
            AC.coeff_vec = np.ones_like(AC.coeff_vec)
            if remaining_qubits >= 1:
                diag_H = PauliwordOp(XZ_block, np.ones(XZ_block.shape[0]))
            else:
                diag_H = PauliwordOp.from_list(["I" * remaining_qubits])
            AC_full = PauliwordOp.from_list(["I" * remaining_qubits]).tensor(AC)
            H_sym = diag_H.tensor(PauliwordOp.from_list(["I" * n_clique_qubits]))
            H_nc = AC_full * H_sym + H_sym
            if n_commuting_terms > 0:
                assert n_commuting_terms * n_cliques + n_commuting_terms == H_nc.n_terms, (
                    "operator not largest it can be"
                )
            else:
                assert AC.n_terms + 1 == H_nc.n_terms, "operator not largest it can be"

        coeff_vec = np.random.randn(H_nc.n_terms).astype(complex)
        if complex_coeffs:
            coeff_vec += 1j * np.random.randn(H_nc.n_terms)

        if apply_clifford:
            U_cliff_rotations = []
            for _ in range(n_qubits * 5):
                P_rand = PauliwordOp.random(H_nc.n_qubits, n_terms=1)
                P_rand.coeff_vec = np.array([1])
                U_cliff_rotations.append((P_rand, (np.pi / 2) * np.random.choice([1, 3])))
            H_nc = H_nc.perform_rotations(U_cliff_rotations)

        return cls.from_planes(H_nc.x_pack, H_nc.z_pack, coeff_vec, H_nc.n_qubits)

    @classmethod
    def _from_stabilizers_noncontextual_op(
        cls, H: PauliwordOp, stabilizers: IndependentOp, use_jordan_product=False
    ) -> "NoncontextualOp":
        symmetries = IndependentOp.symmetry_generators(stabilizers, commuting_override=True)
        # the symmetries are pairwise commuting by construction: skip the
        # noncontextuality early-exit (it would warn and bypass the strategy)
        noncon = NoncontextualOp.from_hamiltonian(
            symmetries, strategy="DFS_magnitude",
            override_noncontextuality_check=True,
        )
        generators = noncon.symmetry_generators
        if noncon.clique_operator.n_terms > 0:
            generators += noncon.clique_operator
            use_jordan_product = True
        return cls._from_generators_noncontextual_op(
            H=H, generators=generators, use_jordan_product=use_jordan_product
        )

    def draw_graph_structure(
        self,
        clique_lw=1,
        symmetry_lw=0.25,
        node_colour="black",
        node_size=20,
        seed=None,
        axis=None,
        include_symmetries=True,
    ):
        """(reference :378-416)"""
        import networkx as nx

        adjmat = self.adjacency_matrix.copy()
        index_symmetries = np.where(np.all(adjmat, axis=1))[0]
        np.fill_diagonal(adjmat, False)
        G = nx.Graph()
        for i, j in list(zip(*np.where(adjmat))):
            if i in index_symmetries or j in index_symmetries:
                if include_symmetries:
                    G.add_edge(i, j, color="grey", weight=symmetry_lw)
            else:
                G.add_edge(i, j, color="black", weight=clique_lw)
        pos = nx.spring_layout(G, seed=seed)
        edges = G.edges()
        colors = [G[u][v]["color"] for u, v in edges]
        weights = [G[u][v]["weight"] for u, v in edges]
        nx.draw(
            G, pos, edge_color=colors, width=weights,
            node_color=node_colour, node_size=node_size, ax=axis,
        )

    def noncontextual_generators(self) -> None:
        """Symmetry generators + anticommuting clique decomposition.

        (reference :418-500)
        """
        Z2_general = IndependentOp.symmetry_generators(self, commuting_override=True)
        # NB: reconstruction over an EMPTY generating set still succeeds for
        # all-identity terms (their rows reduce to zero), which must land in
        # the symmetry component rather than the clique decomposition
        _, Z2_mask = self.generator_reconstruction(
            Z2_general, override_independence_check=True
        )
        Z2_symmetries = self[Z2_mask].generators

        if Z2_symmetries.n_terms > 0 and not np.all(
            Z2_symmetries.commutes_termwise(Z2_symmetries)
        ):
            # Z2 symmetries do not commute among themselves (edge case :436-453)
            sym_gens = self.generators
            z2_mask = (
                np.sum(sym_gens.commutes_termwise(sym_gens), axis=1) == sym_gens.n_terms
            )
            Z2_incomplete = sym_gens[z2_mask]
            _, missing_mask = sym_gens.generator_reconstruction(Z2_incomplete)
            Z2_missing = sym_gens[~missing_mask]
            cover = Z2_missing.clique_cover("C")
            clique_rep_list = [C.sort()[0] for C in cover.values()]
            sym_from_cliques = sum(
                (cover[n] - C_rep) * C_rep
                for n, C_rep in enumerate(clique_rep_list)
                if cover[n].n_terms > 1
            )
            Z2_symmetries = (sym_from_cliques + Z2_incomplete).generators
            _, z2_mask = self.generator_reconstruction(Z2_symmetries)
        else:
            _, z2_mask = self.generator_reconstruction(
                Z2_symmetries, override_independence_check=True
            )

        remaining = self[~z2_mask]

        if remaining.n_terms > 0:
            # remaining terms form a disjoint union of commuting cliques:
            # identical adjacency rows <=> same clique
            adjmat = remaining.adjacency_matrix
            clique_rows = np.unique(adjmat, axis=0)
            self.decomposed = {
                ind: remaining[clique_rows[ind]] for ind in range(clique_rows.shape[0])
            }
            self.n_cliques = len(self.decomposed)
            if self.n_cliques > 0:
                clique_rep_list = [C.sort()[0] for C in self.decomposed.values()]
                self.clique_operator = AntiCommutingOp.from_PauliwordOp(
                    sum(clique_rep_list)
                )
                self.clique_operator.coeff_vec = np.ones_like(
                    self.clique_operator.coeff_vec
                )
                sym_from_cliques = sum(
                    (self.decomposed[n] - C_rep) * C_rep
                    for n, C_rep in enumerate(clique_rep_list)
                    if self.decomposed[n].n_terms > 1
                )
                if sym_from_cliques:
                    if Z2_symmetries.n_terms > 0:
                        Z2_symmetries = (sym_from_cliques + Z2_symmetries).generators
                    else:
                        Z2_symmetries = sym_from_cliques.generators
        else:
            self.clique_operator = PauliwordOp.empty(self.n_qubits).cleanup()
            self.decomposed = dict()
            self.n_cliques = 0

        self.symmetry_generators = IndependentOp.from_PauliwordOp(Z2_symmetries)
        _, Z2_mask = self.generator_reconstruction(
            Z2_symmetries, override_independence_check=True
        )
        self.decomposed["symmetry"] = self[Z2_mask]

    def noncontextual_reconstruction(self) -> None:
        """Jordan reconstruction over G u {C_i} (reference :502-531)."""
        noncon_generators = PauliwordOp.from_planes(
            np.vstack([self.symmetry_generators.x_pack, self.clique_operator.x_pack]),
            np.vstack([self.symmetry_generators.z_pack, self.clique_operator.z_pack]),
            np.ones(self.symmetry_generators.n_terms + self.clique_operator.n_terms),
            self.n_qubits,
        ) if self.n_cliques > 0 else PauliwordOp.from_planes(
            self.symmetry_generators.x_pack, self.symmetry_generators.z_pack,
            np.ones(self.symmetry_generators.n_terms), self.n_qubits,
        )
        jordan_recon_matrix, successful = self.jordan_generator_reconstruction(
            noncon_generators
        )
        assert np.all(successful), (
            "The generating set is not sufficient to reconstruct "
            "the noncontextual Hamiltonian"
        )
        self.G_indices = jordan_recon_matrix[:, : self.symmetry_generators.n_terms]
        self.C_indices = jordan_recon_matrix[:, self.symmetry_generators.n_terms :]
        self.mask_S0 = ~np.any(self.C_indices, axis=1)
        self.mask_Ci = self.C_indices.astype(bool).T

        def multiply_indices(inds):
            factors = [noncon_generators[int(i)] for i in np.where(inds)[0]]
            prod = reduce(
                lambda x, y: x * y, factors, PauliwordOp.from_list(["I" * self.n_qubits])
            )
            return prod.coeff_vec[0].real

        self.pauli_mult_signs = np.array(
            [multiply_indices(row) for row in jordan_recon_matrix.astype(bool)]
        ).astype(int)

    # -- classical objective -------------------------------------------------

    def get_symmetry_contributions(self, nu: np.ndarray) -> Tuple[float, np.ndarray]:
        """(reference :533-547)"""
        nu = np.asarray(nu)
        coeff_mod = (
            self.coeff_vec
            * self.pauli_mult_signs
            * (-1) ** np.count_nonzero(
                np.logical_and(self.G_indices == 1, nu == -1), axis=1
            )
        )
        s0 = np.sum(coeff_mod[self.mask_S0]).real
        si = np.array([np.sum(coeff_mod[mask]).real for mask in self.mask_Ci])
        return s0, si

    def get_energy(self, nu: np.ndarray, AC_ev: int = -1) -> float:
        s0, si = self.get_symmetry_contributions(nu)
        return s0 + AC_ev * np.linalg.norm(si, ord=2)

    def get_energies_batch(self, nu_list: np.ndarray, AC_ev: int = -1) -> np.ndarray:
        """Energies of MANY nu assignments at once as dense contractions.

        E(nu) = s0(nu) + AC_ev * ||s_i(nu)||_2 with
        s0 = m_S0 . (c * sign * (-1)^{F nu^-}),  F = [G_indices == 1].

        Contraction over an explicit nu-matrix (host numpy, or float64
        ``torch.matmul`` on ``config.device``).  The never-materialised search
        lives in ``NoncontextualSolver._brute_force_device`` /
        ``kernels.torch_noncon`` (replacing the reference's parallel per-nu
        map, :686-738).
        """
        nu_list = np.atleast_2d(np.asarray(nu_list))
        F = (self.G_indices == 1).astype(np.float32)          # (M, G)
        neg = (nu_list == -1).astype(np.float32)              # (K, G)
        base = (self.coeff_vec * self.pauli_mult_signs).real  # (M,)
        K = nu_list.shape[0]
        use_dev = config.use_device_io(F.size * K // 64) and K >= 1024
        if use_dev:
            import torch

            # float64 products on the device (a float32 one would need TF32
            # off, and its parity sums are exact only below 2^24 terms)
            dev = config.torch_device()
            f64 = lambda a: torch.tensor(np.asarray(a, np.float64), device=dev)
            parity = torch.remainder(f64(F) @ f64(neg).T, 2.0)  # (M, K)
            signed = f64(base)[:, None] * (1.0 - 2.0 * parity)
            s0 = f64(self.mask_S0) @ signed                     # (K,)
            si = f64(self.mask_Ci).reshape(-1, len(base)) @ signed  # (n_cliques, K)
            return (s0 + AC_ev * torch.linalg.norm(si, dim=0)).cpu().numpy()
        parity = (F @ neg.T) % 2
        signed = base[:, None] * (1 - 2 * parity)
        s0 = self.mask_S0.astype(float) @ signed
        si = self.mask_Ci.astype(float) @ signed
        if si.shape[0] == 0:
            return s0
        return s0 + AC_ev * np.linalg.norm(si, axis=0)

    def update_clique_representative_operator(
        self, clique_index: int = None
    ) -> List[Tuple[PauliwordOp, float]]:
        _, si = self.get_symmetry_contributions(self.symmetry_generators.coeff_vec)
        self.clique_operator.coeff_vec = si.astype(complex)
        # clique_index=None lets unitary_partitioning auto-select the least
        # dense NONZERO-coefficient term; the reference hardwires index 0
        # (noncontextual_op.py:556), which warns and re-selects whenever the
        # solved ground state zeroes that clique's contribution
        (
            self.mapped_clique_rep,
            self.unitary_partitioning_rotations,
            self.clique_normalization,
            self.clique_operator,
        ) = self.clique_operator.unitary_partitioning(
            up_method=self.up_method, s_index=clique_index
        )

    def solve(self, strategy: str = "brute_force", ref_state: np.ndarray = None) -> None:
        """Minimise the classical objective (reference :568-603)."""
        if ref_state is not None:
            self.symmetry_generators.update_sector(ref_state)
            ev_assignment = self.symmetry_generators.coeff_vec
            fixed_ev_mask = ev_assignment != 0
            fixed_eigvals = (ev_assignment[fixed_ev_mask]).astype(int)
            NC_solver = NoncontextualSolver(self, fixed_ev_mask, fixed_eigvals)
        else:
            NC_solver = NoncontextualSolver(self)

        if strategy == "brute_force":
            self.energy, nu = NC_solver.energy_via_brute_force()
        elif strategy == "binary_relaxation":
            self.energy, nu = NC_solver.energy_via_relaxation()
        else:
            raise ValueError(f"Unknown optimization strategy: {strategy}")

        self.symmetry_generators.coeff_vec = nu.astype(int)
        if self.n_cliques > 0:
            self.update_clique_representative_operator()

    def noncon_state(self, UP_method="LCU") -> Tuple[QuantumState, np.ndarray]:
        """Noncontextual ground state construction (reference :605-654)."""
        from ..evolution.exponentiation import exponentiate_single_Pop

        nu_assignment = self.symmetry_generators.coeff_vec.copy()
        _, si = self.get_symmetry_contributions(nu_assignment)
        assert UP_method in ["LCU", "seq_rot"]
        if self.n_cliques > 0:
            self.clique_operator.coeff_vec = si.astype(complex)
            if UP_method == "LCU":
                Ps, rotations_LCU, gamma_l, AC_normed = self.clique_operator.unitary_partitioning(
                    s_index=0, up_method="LCU"
                )
            else:
                Ps, rotations_SEQ, gamma_l, AC_normed = self.clique_operator.unitary_partitioning(
                    s_index=0, up_method="seq_rot"
                )
            # enforce <c P_s> = -1, i.e. the bare Pauli P_s takes value -sign(c)
            # (the reference hardcodes -1, wrong when the clique collapsed to a
            # single negative-coefficient term, noncontextual_op.py:629)
            Ps.coeff_vec[0] = -np.sign(Ps.coeff_vec[0].real)
            independent_stabilizers = self.symmetry_generators + IndependentOp.from_PauliwordOp(Ps)
        else:
            independent_stabilizers = self.symmetry_generators

        independent_stabilizers.target_sqp = "Z"
        rotated_stabs = independent_stabilizers.rotate_onto_single_qubit_paulis()
        clifford_rots = independent_stabilizers.stabilizer_rotations

        nc_vec = np.zeros(self.n_qubits, dtype=int)
        for val, row in zip(rotated_stabs.coeff_vec, rotated_stabs.Z_block):
            assert np.count_nonzero(row) == 1
            nc_vec[row] = (1 - val) / 2
        state = QuantumState(nc_vec)

        for op, _ in clifford_rots[::-1]:
            rot = exponentiate_single_Pop(op.multiply_by_constant(1j * np.pi / 4))
            state = rot.dagger * state
        if self.n_cliques > 0:
            if UP_method == "LCU":
                state = self.clique_operator.R_LCU.dagger * state
            else:
                for op, angle in rotations_SEQ[::-1]:
                    state = (
                        exponentiate_single_Pop(op.multiply_by_constant(1j * angle / 2)).dagger
                        * state
                    )
        return state, nu_assignment


###############################################################################
#                        NONCONTEXTUAL SOLVERS                                #
###############################################################################


class NoncontextualSolver:
    """(reference noncontextual_op.py:660-730)"""

    method: str = "brute_force"
    _nu = None

    def __init__(self, NC_op: NoncontextualOp, fixed_ev_mask=None, fixed_eigvals=None):
        self.NC_op = NC_op
        if fixed_ev_mask is not None:
            assert fixed_eigvals is not None, "Must specify the fixed eigenvalues"
            assert np.sum(fixed_ev_mask) == len(fixed_eigvals), (
                "Number of non-zero elements in mask does not match the "
                "number of fixed eigenvalues"
            )
            self.fixed_ev_mask = fixed_ev_mask
            self.fixed_eigvals = fixed_eigvals
        else:
            self.fixed_ev_mask = np.zeros(NC_op.symmetry_generators.n_terms, dtype=bool)
            self.fixed_eigvals = np.array([], dtype=int)

    def energy_via_brute_force(self) -> Tuple[float, np.ndarray]:
        """All 2^|unfixed G| assignments.

        Small searches run as chunked host contractions; large ones are
        enumerated ON THE DEVICE by the ``brute_force_minimise`` kernel (the
        nu-matrix is never materialised -- host memory is flat in the search
        size), replacing the reference's process-pool streaming
        (noncontextual_op.py:686-738).
        """
        if np.all(self.fixed_ev_mask):
            nu_list = self.fixed_eigvals.reshape([1, -1])
            energies = self.NC_op.get_energies_batch(nu_list)
            return float(energies[0]), nu_list[0]

        free = int(np.sum(~self.fixed_ev_mask))
        if free > 31:
            raise ValueError(
                f"brute force over 2^{free} assignments is infeasible; "
                "fix more symmetry eigenvalues (reference state) or use "
                "strategy='binary_relaxation'"
            )
        search_size = 2**free
        M = self.NC_op.n_terms
        # the device search uploads only the per-term inputs and downloads
        # one (E, index) pair; it pays a few launches and syncs, so small
        # searches stay on the host (free > 20 would take the host minutes)
        use_dev = config.backend != "host" and (
            free > 20
            or (search_size >= 1024 and config.use_device_io(search_size * M))
        )
        if use_dev:
            return self._brute_force_device(free)

        # host path, chunked so memory stays bounded even when backend='host'
        # forces large searches through here
        n_sym = self.NC_op.symmetry_generators.n_terms
        chunk = min(search_size, config.brute_force_host_chunk)
        best_e, best_nu = np.inf, None
        shifts = np.arange(free - 1, -1, -1)
        for start in range(0, search_size, chunk):
            idx = np.arange(start, min(start + chunk, search_size))
            nu_list = np.ones([len(idx), n_sym], dtype=int)
            nu_list[:, self.fixed_ev_mask] = np.tile(self.fixed_eigvals, [len(idx), 1])
            # enumeration order matches itertools.product([-1, 1], repeat=free)
            grid = (idx[:, None] >> shifts) & 1
            nu_list[:, ~self.fixed_ev_mask] = 2 * grid - 1
            energies = self.NC_op.get_energies_batch(nu_list)
            k = int(np.argmin(energies))
            if energies[k] < best_e:
                best_e, best_nu = float(energies[k]), nu_list[k]
        return best_e, best_nu

    def _brute_force_device(self, free: int) -> Tuple[float, np.ndarray]:
        """Device-enumerated assignment search (the ``brute_force_minimise``
        kernel); under ``use_mesh`` the assignments split over the mesh's
        shards, one launch a shard."""
        from ..kernels.torch_noncon import brute_force_minimise, nu_from_index

        F = (self.NC_op.G_indices == 1).astype(np.float64)
        fixed_neg = (np.asarray(self.fixed_eigvals) == -1).astype(np.float64)
        fixed_parity = (F[:, self.fixed_ev_mask] @ fixed_neg) % 2
        base = (self.NC_op.coeff_vec * self.NC_op.pauli_mult_signs).real
        _, idx = brute_force_minimise(
            F[:, ~self.fixed_ev_mask],
            fixed_parity,
            base,
            self.NC_op.mask_S0.astype(np.float64),
            self.NC_op.mask_Ci.astype(np.float64),
            free,
            config.torch_device(),
            config.mesh,
        )
        nu = np.ones(self.NC_op.symmetry_generators.n_terms, dtype=int)
        nu[self.fixed_ev_mask] = self.fixed_eigvals
        nu[~self.fixed_ev_mask] = nu_from_index(idx, free)
        # the argmin came off the device, summed in another order than the
        # host's: the reported energy is recomputed for that assignment on
        # the host
        return float(self.NC_op.get_energy(nu)), nu

    def energy_via_relaxation(self) -> Tuple[float, np.ndarray]:
        """Continuous relaxation optimised by scipy shgo (reference :710-730)."""
        from scipy.optimize import shgo

        nu_bounds = [(0, np.pi)] * (
            self.NC_op.symmetry_generators.n_terms - np.sum(self.fixed_ev_mask)
        )

        def get_nu(angles):
            nu = np.ones(self.NC_op.symmetry_generators.n_terms)
            nu[self.fixed_ev_mask] = self.fixed_eigvals
            nu[~self.fixed_ev_mask] = np.cos(angles)
            return nu

        optimizer_output = shgo(
            func=lambda angles: self.NC_op.get_energy(get_nu(angles)), bounds=nu_bounds
        )
        fix_nu = np.sign(np.array(get_nu(np.cos(optimizer_output["x"])))).astype(int)
        self.NC_op.symmetry_generators.coeff_vec = fix_nu
        return optimizer_output["fun"], fix_nu


def get_noncon_energy(nu_list: np.ndarray, noncon_H: NoncontextualOp):
    """Batch energies (API analogue of the reference's parallel map :733-738)."""
    energies = noncon_H.get_energies_batch(np.atleast_2d(nu_list))
    return list(zip(energies, np.atleast_2d(nu_list)))
