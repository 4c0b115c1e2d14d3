"""VQE and ADAPT-VQE drivers.

Parity surface of symmer ``evolution/variational_optimization.py``.  The
reference prepares ansatz states by binding a qiskit circuit and calling
``qiskit.quantum_info.Statevector`` (:88); here state preparation is native:

    |psi(x)> = prod_k exp(i x_k P_k) |ref>      (P_0 applied first)

evaluated exactly with the packed one-sparse Pauli action -- identical to the
trotterized circuit the reference builds (rz(-2 angle) convention,
decomposition.py:110-203).  qiskit remains an optional export target.
"""
from __future__ import annotations

from copy import deepcopy
from functools import cached_property
from typing import List, Tuple, Union

import numpy as np

from .. import process
from ..operators import PauliwordOp, QuantumState
from ..operators.utils import safe_QuantumState_to_dict, symplectic_to_string
from .exponentiation import exponentiate_single_Pop
from .utils import get_CNOT_connectivity_graph, topology_match_score


def evolve_state(
    excitation_generators: PauliwordOp,
    x: np.ndarray,
    ref_state: QuantumState,
) -> QuantumState:
    """|psi(x)> = e^{i x_{n-1} P_{n-1}} ... e^{i x_0 P_0} |ref>."""
    assert len(x) == excitation_generators.n_terms, (
        "parameter count does not match the number of excitation generators"
    )
    state = ref_state
    for k in range(excitation_generators.n_terms):
        if x[k] == 0:
            continue
        expP = exponentiate_single_Pop(
            excitation_generators[k].multiply_by_constant(1j * x[k])
        )
        state = (expP * state).cleanup(zero_threshold=1e-14)
    return state


class VQE_Driver:
    """(reference variational_optimization.py:17-225)

    expectation_eval choices:
      - symbolic_direct:    <psi|H|psi> via QuantumState algebra
      - symbolic_projector: per-term projector expectation values
      - observable_rotation: rotations applied to the observable
      - sparse_array:       sparse matrix-vector contraction (default)
      - dense_array:        dense matrix contraction
      - device_array:       the dense statevector on ``config.device``
        (evolution/device_vqe.py): the ansatz and the energy on hand CUDA
        kernels, the gradient from one adjoint sweep (a
        torch.autograd.Function) instead of 2 * n_params parameter-shift
        evaluations (values identical: the +-pi/4 shift rule is exact for
        Pauli generators)
    """

    expectation_eval = "sparse_array"
    verbose = True

    def __init__(
        self,
        observable: PauliwordOp,
        ansatz_circuit=None,
        excitation_ops: PauliwordOp = None,
        ref_state: QuantumState = None,
    ) -> None:
        self.observable = observable
        if ref_state is None:
            ref_state = QuantumState.zero(observable.n_qubits)
        elif not isinstance(ref_state, QuantumState):
            ref_state = QuantumState(np.asarray(ref_state).reshape(1, -1))
        self.ref_state = ref_state
        assert np.all(self.observable.coeff_vec.imag == 0), "Observable not Hermitian"
        self.circuit = ansatz_circuit  # qiskit circuit, optional
        if excitation_ops is not None:
            self.prepare_for_evolution(excitation_ops)

    def prepare_for_evolution(self, excitation_ops: PauliwordOp) -> None:
        # identity terms contribute only a global phase and carry no parameter
        # (the reference's circuit builder drops them too, decomposition.py:152)
        non_identity = np.any(excitation_ops.symp_matrix, axis=1)
        self.excitation_generators = PauliwordOp.from_planes(
            excitation_ops.x_pack[non_identity], excitation_ops.z_pack[non_identity],
            np.ones(int(non_identity.sum())), excitation_ops.n_qubits,
        )
        self.n_params = self.excitation_generators.n_terms

    def get_state(self, evolution_obj, x: np.ndarray):
        """State-type object for the active expectation method.

        (reference :71-94; native evolution replaces qiskit Statevector)
        """
        if self.expectation_eval == "observable_rotation":
            return list(zip(evolution_obj, -2 * np.asarray(x)))
        state = evolve_state(evolution_obj, np.asarray(x), self.ref_state)
        if self.expectation_eval == "dense_array":
            return state.to_sparse_matrix.toarray()
        elif self.expectation_eval == "sparse_array":
            return state.to_sparse_matrix
        return state

    def _f(self, observable: PauliwordOp, state) -> float:
        """(reference :96-123)"""
        if self.expectation_eval == "dense_array":
            return (state.conjugate().T @ observable.to_sparse_matrix.toarray() @ state)[
                0, 0
            ].real
        elif self.expectation_eval == "sparse_array":
            return (state.conjugate().T @ (observable.to_sparse_matrix @ state)).toarray()[
                0, 0
            ].real
        elif self.expectation_eval == "symbolic_projector":
            return observable.expval(state).real
        elif self.expectation_eval == "symbolic_direct":
            return complex(state.dagger * (observable * state)).real
        elif self.expectation_eval == "observable_rotation":
            return complex(
                self.ref_state.dagger * (observable.perform_rotations(state) * self.ref_state)
            ).real
        elif self.expectation_eval == "device_array":
            # arbitrary-observable path (ADAPT pool scoring): state arrives as
            # a symbolically evolved QuantumState; the fixed-ansatz objective
            # and gradient bypass this via the fused device engine (f/gradient)
            return observable.expval(state).real
        raise ValueError(f"Unknown expectation_eval {self.expectation_eval}")

    def _device_engine(self):
        """Cached device_vqe engine bound to the current (H, generators, ref).

        Identity is checked by object ids first (the optimizer hot loop calls
        this per objective/gradient evaluation; hashing multi-MB planes each
        time would dominate) and falls back to the content key only when an
        id changed -- e.g. ADAPT replacing excitation_generators each cycle.
        """
        from . import device_vqe

        # content key only: an id()-based fast path can alias a recycled
        # CPython address and silently serve an engine built for different
        # generators (the key is byte-hashing of small arrays -- microseconds
        # at ADAPT scales, not worth the hazard)
        key = device_vqe.DeviceVQEEngine.key(
            self.observable, self.excitation_generators, self.ref_state
        )
        if getattr(self, "_dev_engine_key", None) != key:
            self._dev_engine = device_vqe.DeviceVQEEngine(
                self.observable, self.excitation_generators, self.ref_state
            )
            self._dev_engine_key = key
        return self._dev_engine

    def f(self, x: np.ndarray) -> float:
        if self.expectation_eval == "device_array":
            return self._device_engine().loss(x)
        state = self.get_state(self.excitation_generators, x)
        return self._f(self.observable, state)

    def partial_derivative(self, x: np.ndarray, param_index: int) -> float:
        """Parameter-shift rule at +-pi/4 (reference :141-155)."""
        x_upper = x.copy(); x_upper[param_index] += np.pi / 4
        x_lower = x.copy(); x_lower[param_index] -= np.pi / 4
        return self.f(x_upper) - self.f(x_lower)

    def gradient(self, x: np.ndarray) -> np.ndarray:
        if self.expectation_eval == "device_array":
            return self._device_engine().gradient(x)

        @process.parallelize
        def deriv(index, param):
            return self.partial_derivative(param, index)

        return np.asarray(deriv(range(self.n_params), np.asarray(x)))

    def run(self, x0: np.ndarray = None, **kwargs):
        """scipy.minimize wrapper with history capture (reference :178-225)."""
        from scipy.optimize import minimize

        if x0 is None:
            x0 = np.random.random(self.n_params)

        vqe_history = {"params": {}, "energy": {}, "gradient": {}}
        counter = {"n": -1}

        def fun(x):
            counter["n"] += 1
            energy = self.f(x)
            vqe_history["params"][counter["n"]] = tuple(x)
            vqe_history["energy"][counter["n"]] = energy
            if self.verbose:
                print(f"Optimization step {counter['n']: <2}:\n\t Energy = {energy}")
            return energy

        def jac(x):
            grad = self.gradient(x)
            vqe_history["gradient"][counter["n"]] = tuple(grad)
            if self.verbose:
                print(f"\t    |∆| = {np.linalg.norm(grad)}")
            return grad

        if self.verbose:
            print("VQE simulation commencing...\n")
        opt_out = minimize(fun=fun, jac=jac, x0=x0, **kwargs)
        return serialize_opt_data(opt_out), vqe_history


class ADAPT_VQE(VQE_Driver):
    """qubit-ADAPT-VQE (arXiv:2006.09414 / PRXQuantum.2.020310).

    (reference variational_optimization.py:227-466) including TETRIS batching
    (arXiv:2209.10562) and hardware-topology-aware pool scoring.
    """

    derivative_eval = "commutators"
    TETRIS = False
    topology_aware = False
    topology_bias = 1
    topology = None
    subgraph_match_depth = 3

    def __init__(
        self,
        observable: PauliwordOp,
        excitation_pool: PauliwordOp = None,
        ref_state: QuantumState = None,
    ) -> None:
        super().__init__(
            observable=observable,
            excitation_ops=PauliwordOp.empty(observable.n_qubits),
            ref_state=ref_state,
        )
        self.excitation_pool = PauliwordOp.from_planes(
            excitation_pool.x_pack, excitation_pool.z_pack,
            np.ones(excitation_pool.n_terms), excitation_pool.n_qubits,
        )
        self.adapt_operator = PauliwordOp.empty(observable.n_qubits)
        self.opt_parameters = []
        self.current_state = None

    @cached_property
    def commutators(self) -> List[PauliwordOp]:
        """i[H, P] per pool element (reference :276-288)."""
        @process.parallelize
        def f(P, obs):
            return obs.commutator(P) * 1j

        return f(list(self.excitation_pool), self.observable)

    def _derivative_from_commutators(self, index: int) -> float:
        assert self.current_state is not None
        return self._f(observable=self.commutators[index], state=self.current_state)

    def _derivative_from_param_shift(self, index: int) -> float:
        adapt_op_temp = self.adapt_operator.append(self.excitation_pool[index])
        non_identity = np.any(adapt_op_temp.symp_matrix, axis=1)
        gen = PauliwordOp.from_planes(
            adapt_op_temp.x_pack[non_identity], adapt_op_temp.z_pack[non_identity],
            np.ones(int(non_identity.sum())), adapt_op_temp.n_qubits,
        )
        upper_state = self.get_state(gen, np.append(self.opt_parameters, +np.pi / 4))
        lower_state = self.get_state(gen, np.append(self.opt_parameters, -np.pi / 4))
        return self._f(self.observable, upper_state) - self._f(self.observable, lower_state)

    def pool_gradient(self) -> np.ndarray:
        """(reference :320-355)"""
        if (
            self.derivative_eval == "commutators"
            and self.expectation_eval == "device_array"
        ):
            # ALL pool derivatives d_i = <psi|i[H,P_i]|psi> in one device
            # program (|psi> and H|psi> built once; the reference caches a
            # full commutator operator per pool element instead)
            from . import device_vqe

            non_identity = np.any(self.adapt_operator.symp_matrix, axis=1)
            gen = PauliwordOp.from_planes(
                self.adapt_operator.x_pack[non_identity],
                self.adapt_operator.z_pack[non_identity],
                np.ones(int(non_identity.sum())), self.adapt_operator.n_qubits,
            )
            return device_vqe.device_pool_gradient(
                self.observable, gen, self.ref_state, self.excitation_pool,
                np.asarray(self.opt_parameters, dtype=float),
            )
        if self.derivative_eval == "commutators":
            self.commutators  # ensure cached
            if self.expectation_eval == "observable_rotation":
                self.current_state = self.get_state(self.adapt_operator, self.opt_parameters)
            else:
                non_identity = np.any(self.adapt_operator.symp_matrix, axis=1)
                gen = PauliwordOp.from_planes(
                    self.adapt_operator.x_pack[non_identity],
                    self.adapt_operator.z_pack[non_identity],
                    np.ones(int(non_identity.sum())), self.adapt_operator.n_qubits,
                )
                self.current_state = self.get_state(gen, np.asarray(self.opt_parameters))
            gradient = [
                self._derivative_from_commutators(i)
                for i in range(self.excitation_pool.n_terms)
            ]
        elif self.derivative_eval == "param_shift":
            gradient = [
                self._derivative_from_param_shift(i)
                for i in range(self.excitation_pool.n_terms)
            ]
        else:
            raise ValueError("Unrecognised derivative_eval method")
        return np.asarray(gradient)

    def pool_score(self) -> np.ndarray:
        """(reference :357-374)"""
        scores = abs(self.pool_gradient())
        if self.topology_aware:
            assert self.topology is not None, "No hardware topology specified"
            topology_scores = []
            for index in range(self.excitation_pool.n_terms):
                adapt_op_temp = self.adapt_operator.append(self.excitation_pool[index])
                topology_scores.append(
                    topology_match_score(
                        adapt_op_temp, self.topology, max_depth=self.subgraph_match_depth
                    )
                )
            scores *= np.power(np.array(topology_scores), self.topology_bias)
        return scores

    def append_to_adapt_operator(self, excitations_to_append: List[PauliwordOp]):
        for excitation in excitations_to_append:
            if not np.any(self.adapt_operator.symp_matrix):
                self.adapt_operator += excitation
            else:
                self.adapt_operator = self.adapt_operator.append(excitation)

    def optimize(
        self, max_cycles: int = 10, gtol: float = 1e-3, atol: float = 1e-10,
        target: float = 0, target_error: float = 1e-3,
    ):
        """ADAPT loop (reference :386-459)."""
        interim_data = {"history": []}
        adapt_cycle = 1
        gmax = 1
        anew = 1
        aold = 0
        opt_out = {"fun": None, "x": []}

        while (
            gmax > gtol and adapt_cycle <= max_cycles
            and abs(anew - aold) > atol and abs(anew - target) > target_error
        ):
            aold = deepcopy(anew)
            scores = self.pool_score()
            grad_rank = list(map(int, np.argsort(scores)[::-1]))
            gmax = scores[grad_rank[0]]

            if self.TETRIS:
                new_excitation_list = []
                support_mask = np.zeros(self.observable.n_qubits, dtype=bool)
                for i in grad_rank:
                    new_excitation = self.excitation_pool[i]
                    support = (new_excitation.X_block | new_excitation.Z_block)[0]
                    if not np.any(support & support_mask):
                        new_excitation_list.append(new_excitation)
                        support_mask = support_mask | support
                    if np.all(support_mask) or scores[i] < gtol:
                        break
            else:
                new_excitation_list = [self.excitation_pool[grad_rank[0]]]

            n_new_terms = len(new_excitation_list)
            self.append_to_adapt_operator(new_excitation_list)

            if self.verbose:
                print("-" * 39)
                print(f"ADAPT cycle {adapt_cycle}\n")
                print(f"Largest pool derivative ∂P∂θ = {gmax: .5f}\n")
                print("Selected excitation generator(s):\n")
                for op in new_excitation_list:
                    print(f"\t{symplectic_to_string(op.symp_matrix[0])}")
                print("\n", "-" * 39)

            self.prepare_for_evolution(self.adapt_operator)
            opt_out, vqe_hist = self.run(
                x0=np.append(self.opt_parameters, [0] * n_new_terms), method="BFGS"
            )
            interim_data[adapt_cycle] = {
                "output": opt_out, "history": vqe_hist, "gmax": gmax,
                "excitation": [
                    symplectic_to_string(t.symp_matrix[0]) for t in new_excitation_list
                ],
            }
            anew = opt_out["fun"]
            interim_data["history"].append(anew)
            if self.verbose:
                print(f"\nEnergy at ADAPT cycle {adapt_cycle}: {anew: .5f}\n")
            self.opt_parameters = opt_out["x"]
            adapt_cycle += 1

        return {
            "result": opt_out,
            "interim_data": interim_data,
            "ref_state": safe_QuantumState_to_dict(self.ref_state),
            "adapt_operator": [
                symplectic_to_string(t) for t in self.adapt_operator.symp_matrix
            ],
        }


def serialize_opt_data(opt_data):
    return {
        "message": opt_data.message, "success": opt_data.success, "status": opt_data.status,
        "fun": opt_data.fun, "x": tuple(opt_data.x), "jac": tuple(opt_data.jac),
        "nit": opt_data.nit, "nfev": opt_data.nfev, "njev": opt_data.njev,
    }
