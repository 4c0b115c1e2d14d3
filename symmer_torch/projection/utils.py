"""Projection utilities: stabilizer identification and biasing.

Behavioural parity surface of symmer ``projection/utils.py`` (norms :8-31,
basis_score :33-61, update_eigenvalues :63-83, StabilizerIdentification
:85-154, ObservableBiasing :156-230, stabilizer_walk :232-273,
get_noncon_generators_from_commuting_stabilizers :275-339), re-expressed on
the packed symplectic planes: the prefix bisection is an iterative loop, the
diagonal-stabilizer filter and qubit-support masks are plane popcounts, and
term weighting happens without materialising boolean blocks.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np

from ..kernels import pack
from ..operators import IndependentOp, PauliwordOp


def norm(vector: np.ndarray) -> float:
    return float(np.sqrt(np.vdot(vector, vector).real))


def lp_norm(vector: np.ndarray, p: int = 2) -> float:
    return float(np.sum(np.abs(vector) ** p) ** (1.0 / p))


def one_qubit_noncontextual_gs(op: PauliwordOp):
    """Ground energy and state of a single-qubit operator (any 1-qubit
    operator is noncontextual), by dense 2x2 diagonalisation.

    The reference declares this helper with an unfinished body
    (reference projection/utils.py:29-31, ``op.to``); the evident intent is
    implemented here.
    """
    assert op.n_qubits == 1, "Operator consists of more than one qubit"
    from ..operators import QuantumState

    evals, evecs = np.linalg.eigh(op.to_dense_matrix())
    return float(evals[0]), QuantumState.from_array(evecs[:, [0]])


def basis_score(
    weighting_operator: PauliwordOp, basis: IndependentOp, p: int = 1
) -> float:
    """Fraction of the weighting operator's coefficient p-norm carried by
    terms that commute with EVERY basis element (those survive the stabilizer
    projection; reference projection/utils.py:33-61)."""
    survives = ~weighting_operator.anticommutes_termwise(basis).any(axis=1)
    total = lp_norm(weighting_operator.coeff_vec, p=p)
    return lp_norm(weighting_operator.coeff_vec[survives], p=p) / total


def update_eigenvalues(generators: IndependentOp, stabilizers: IndependentOp) -> None:
    """Propagate +/-1 sector assignments through a generator reconstruction:
    each stabilizer's eigenvalue is the product of the assignments of the
    generators composing it (reference projection/utils.py:63-83)."""
    recon, complete = stabilizers.generator_reconstruction(generators)
    if not np.all(complete):
        raise ValueError("Generators not sufficient to reconstruct symmetry operators")
    negatives = np.asarray(generators.coeff_vec) == -1
    parity = (recon.astype(bool) & negatives[None, :]).sum(axis=1) & 1
    stabilizers.coeff_vec = 1 - 2 * parity


class StabilizerIdentification:
    """Find a diagonal-symmetry basis whose projection hits a target qubit
    count, by bisecting over magnitude-ordered term prefixes.

    The more terms a prefix keeps, the fewer symmetries survive -- the
    surviving-qubit count is monotone in the prefix length, so a bisection
    over [0, n_terms] lands on the requested subspace dimension
    (reference projection/utils.py:85-154).
    """

    def __init__(self, weighting_operator: PauliwordOp, use_X_only: bool = False) -> None:
        self.use_X_only = use_X_only
        self.weighting_operator = weighting_operator
        self.build_basis_weighting_operator()

    def build_basis_weighting_operator(self) -> None:
        """(Re)derive the magnitude-sorted weighting operator; under
        ``use_X_only`` weight by X-support alone -- keep the x planes, zero
        the z planes (packed, no boolean block/hstack round trip)
        (reference projection/utils.py:99-107)."""
        if self.use_X_only:
            self.weighting_operator = PauliwordOp.from_planes(
                self.weighting_operator.x_pack,
                np.zeros_like(self.weighting_operator.z_pack),
                np.abs(self.weighting_operator.coeff_vec),
                self.weighting_operator.n_qubits,
            ).cleanup()
        self.basis_weighting = self.weighting_operator.sort(by="magnitude")
        self.qubit_positions = np.arange(self.weighting_operator.n_qubits)
        self.term_region = [0, self.basis_weighting.n_terms]

    def symmetry_generators_by_term_significance(self, n_preserved: int) -> IndependentOp:
        """Largest DIAGONAL symmetry basis preserving the ``n_preserved``
        largest-magnitude terms."""
        prefix = self.basis_weighting[:n_preserved]
        sym = IndependentOp.symmetry_generators(prefix, commuting_override=True)
        diagonal = pack.popcount_rows(sym.x_pack) == 0
        return IndependentOp.from_planes(
            sym.x_pack[diagonal], sym.z_pack[diagonal],
            sym.coeff_vec[diagonal], sym.n_qubits,
        )

    def symmetry_generators_by_subspace_dimension(
        self, n_sim_qubits: int, region=None
    ) -> IndependentOp:
        assert n_sim_qubits < self.basis_weighting.n_qubits, (
            "Number of qubits to simulate exceeds those in the operator"
        )
        lo, hi = self.term_region if region is None else region
        while True:
            assert hi - lo > 1, (
                "Search region collapsed without identifying any stabilizers"
            )
            mid = (lo + hi) // 2
            stabilizers = self.symmetry_generators_by_term_significance(mid)
            remaining = self.basis_weighting.n_qubits - stabilizers.n_terms
            if remaining == n_sim_qubits:
                return stabilizers
            if remaining > n_sim_qubits:
                hi = mid  # too few stabilizers: shrink the preserved prefix
            else:
                lo = mid


class ObservableBiasing:
    """Double-Gaussian HOMO/LUMO re-weighting of operator terms by X-support
    position (reference projection/utils.py:156-230).

    Bias parameters in [0, 1) map to Gaussian widths via tan(pi/2 * (1-b)):
    bias 0 is flat, bias -> 1 collapses onto the single HOMO/LUMO qubit.
    """

    HOMO_bias = 0.2
    LUMO_bias = 0.2
    # number of qubits the two Gaussians sit away from the gap mid-point
    separation = 1

    def __init__(self, base_operator: PauliwordOp, HOMO_LUMO_gap) -> None:
        # gap - int(gap) rejects NEGATIVE mid-points (a fully-unoccupied
        # reference gives -0.5, for which Python's `% 1` is also 0.5 but the
        # bias curve would index negatively and wrap onto the last qubit)
        assert HOMO_LUMO_gap >= 0 and HOMO_LUMO_gap - int(HOMO_LUMO_gap) == 0.5, (
            "HOMO_LUMO_gap should be specified as the (non-negative) "
            "mid-point between the HOMO and LUMO indices"
        )
        self.base_operator = base_operator
        self.HOMO_LUMO_gap = HOMO_LUMO_gap
        self.shifted_q_pos = np.arange(base_operator.n_qubits) - HOMO_LUMO_gap

    def _half_curve(self, bias: float, offset: float) -> np.ndarray:
        """One Gaussian centred ``offset`` qubits from the gap mid-point; the
        bias -> 1 limit degenerates to a delta on that qubit."""
        sigma = np.tan((1 - bias) * np.pi / 2)
        if sigma == 0:
            curve = np.zeros(self.base_operator.n_qubits)
            curve[int(self.HOMO_LUMO_gap + offset)] = 1.0
            return curve
        return np.exp(-0.5 * ((self.shifted_q_pos - offset) / sigma) ** 2)

    def HOMO_LUMO_bias_curve(self) -> np.ndarray:
        offset = self.separation - 0.5
        homo = self._half_curve(self.HOMO_bias, -offset)
        lumo = self._half_curve(self.LUMO_bias, +offset)
        return (homo + lumo) / 2

    def HOMO_LUMO_biased_operator(self) -> PauliwordOp:
        curve = self.HOMO_LUMO_bias_curve()
        x_support = pack.unpack_bits(
            self.base_operator.x_pack, self.base_operator.n_qubits
        )
        return PauliwordOp.from_planes(
            self.base_operator.x_pack,
            self.base_operator.z_pack,
            (x_support @ curve) * self.base_operator.coeff_vec,
            self.base_operator.n_qubits,
        )


def stabilizer_walk(
    n_sim_qubits,
    biasing_operator: ObservableBiasing,
    weighting_operator: PauliwordOp = None,
    print_info: bool = False,
    use_X_only: bool = False,
) -> IndependentOp:
    """Optimise the two bias parameters by differential evolution, scoring
    each candidate basis on the weighting operator (reference utils.py:232-273)."""
    from scipy.optimize import differential_evolution

    score_against = (
        weighting_operator if weighting_operator is not None
        else biasing_operator.base_operator
    )

    def stabilizers_for(bias_pair):
        biasing_operator.HOMO_bias, biasing_operator.LUMO_bias = bias_pair
        reweighted = biasing_operator.HOMO_LUMO_biased_operator()
        search = StabilizerIdentification(reweighted, use_X_only=use_X_only)
        return search.symmetry_generators_by_subspace_dimension(n_sim_qubits)

    result = differential_evolution(
        lambda x: -basis_score(score_against, stabilizers_for(x)),
        bounds=[(0, 1), (0, 1)],
    )
    S = stabilizers_for(result["x"])
    if print_info:
        print(
            f"Optimal score w(S)={-result['fun']} for HOMO/LUMO bias {result['x']}"
        )
    return S


def _anticommuting_basis_on(support_mask: np.ndarray, n_qubits: int) -> PauliwordOp:
    """A 2k-element pairwise-anticommuting set supported on the masked qubits
    (the structured 2n+1 construction minus its first element, embedded into
    the full register)."""
    from ..utils import random_anitcomm_2n_1_PauliwordOp

    k = int(support_mask.sum())
    local = random_anitcomm_2n_1_PauliwordOp(k, apply_clifford=False)[1:]
    symp = np.zeros((2 * k, 2 * n_qubits), dtype=bool)
    symp[:, np.concatenate([support_mask, support_mask])] = local.symp_matrix
    return PauliwordOp(symp, np.ones(2 * k))


def get_noncon_generators_from_commuting_stabilizers(
    stabilizers: Union[PauliwordOp, IndependentOp],
    weighting_operator: PauliwordOp,
    return_clique_only: Optional[bool] = False,
):
    """Swap one commuting generator for an anticommuting clique, choosing the
    replacement that lets the weighting operator reconstruct the most
    coefficient weight (reference projection/utils.py:275-339)."""
    from ..utils import product_list

    if not np.all(stabilizers.commutes_termwise(stabilizers)):
        return stabilizers  # already noncontextual: nothing to augment
    generators = stabilizers.generators

    # qubits where exactly ONE generator acts with X xor Z: replacing that
    # generator by a clique on those qubits cannot disturb the others
    xz = generators.X_block ^ generators.Z_block
    singly_covered = xz.sum(axis=0) == 1

    best = {"l1": -1.0, "stabilizers": None, "swapped_out": None}
    for idx in range(generators.n_terms):
        gen = generators[idx]
        support = (gen.X_block ^ gen.Z_block)[0] & singly_covered
        clique = _anticommuting_basis_on(support, gen.n_qubits)

        # ensure the swapped-out generator is reconstructible from the clique
        # (multiply the needed product through, reference :311-318)
        recon, _ = gen.generator_reconstruction(clique)
        needed = recon[0].nonzero()[0][1:]
        if len(needed):
            clique = (clique * product_list([clique[int(i)] for i in needed])).cleanup()
        clique.coeff_vec = np.ones_like(clique.coeff_vec)

        _, reconstructible = weighting_operator.generator_reconstruction(clique)
        l1 = float(np.abs(weighting_operator.coeff_vec[reconstructible]).sum())
        if l1 > best["l1"]:
            best = {
                "l1": l1,
                "stabilizers": generators - gen + clique,
                "swapped_out": gen.copy(),
            }

    new_stabilizers = best["stabilizers"]
    assert new_stabilizers.is_noncontextual, "new stabilizers are not noncontextual"
    if return_clique_only:
        return (
            IndependentOp.from_PauliwordOp(new_stabilizers) - generators,
            best["swapped_out"],
        )
    return IndependentOp.from_PauliwordOp(new_stabilizers)
