"""Hardware-topology scores of an ansatz (parity surface of symmer
``evolution/utils.py``; same results as ``symmer_tpu/evolution/utils.py``).

A trotterized exponential of a Pauli term entangles its support as a CNOT
ladder: neighbouring support qubits, in descending index order, are coupled
twice (down and back up the ladder).  The coupling graph of an ansatz is the
multigraph of those ladders, weighted by the CNOT count on each pair; its
distance to a device topology is the CNOT weight that must be cut (by
removing as few qubits as possible, the most connected first) before the
rest embeds in the topology.
"""
from __future__ import annotations

from collections import Counter
from itertools import combinations

import numpy as np

from ..kernels import pack
from ..operators import PauliwordOp


def _ladder_edges(op: PauliwordOp) -> Counter:
    """CNOT count per (qubit, qubit) pair over the terms' ladders."""
    support = pack.unpack_bits(op.x_pack | op.z_pack, op.n_qubits)
    edges = Counter()
    for row in support:
        qubits = op.n_qubits - 1 - np.flatnonzero(row)  # descending
        edges.update(zip(qubits[:-1].tolist(), qubits[1:].tolist()))
    return Counter({e: 2 * n for e, n in edges.items()})


def get_CNOT_connectivity_graph(evolution_obj, print_graph=False):
    """networkx Graph of the entangling pairs of a trotterized evolution,
    each edge weighted by its CNOT count.

    Takes a PauliwordOp, or a qiskit QuantumCircuit (its multi-qubit gates,
    barriers excluded) where qiskit is installed."""
    import networkx as nx

    if isinstance(evolution_obj, PauliwordOp):
        weights = _ladder_edges(evolution_obj)
    else:
        weights = Counter(
            tuple(q._index for q in qubits)
            for gate, qubits, *_ in evolution_obj.data
            if gate.name != "barrier" and len(qubits) > 1
        )
    graph = nx.Graph()
    graph.add_weighted_edges_from((u, v, w) for (u, v), w in weights.items())
    if print_graph:
        nx.draw_spring(graph)
    return graph


def subgraph_isomorphism_distance(G, target, max_depth=3):
    """CNOT weight cut from G before it embeds in ``target``: for depth =
    0 .. max_depth - 1, the node sets of that size are tried most connected
    first (edge count), and the first whose removal leaves a graph that a
    subgraph of ``target`` is isomorphic to gives the weight of the edges
    at those nodes (an edge between two removed nodes counts twice).  None
    when no removal of fewer than max_depth nodes works."""
    from networkx.algorithms.isomorphism import GraphMatcher

    for depth in range(max_depth):
        candidates = sorted(combinations(G.nodes, depth),
                            key=lambda nodes: -sum(G.degree(n) for n in nodes))
        for nodes in candidates:
            rest = G.copy()
            rest.remove_nodes_from(nodes)
            if GraphMatcher(target, rest).subgraph_is_isomorphic():
                return sum(G.degree(n, weight="weight") for n in nodes)
    return None


def topology_match_score(ansatz_operator, topology, max_depth=3):
    """1 - (CNOT weight cut) / (the ansatz's CNOT count): 1 for an ansatz
    with no entangling gate or one that embeds as it is, 0 when no cut of
    fewer than max_depth qubits embeds it."""
    support = pack.unpack_bits(ansatz_operator.x_pack | ansatz_operator.z_pack,
                               ansatz_operator.n_qubits)
    # (support - 1) CNOTs down each term's ladder and as many back up
    n_cnots = 2 * (int(support.sum()) - ansatz_operator.n_terms)
    if n_cnots == 0:
        return 1
    cost = subgraph_isomorphism_distance(
        get_CNOT_connectivity_graph(ansatz_operator), topology, max_depth=max_depth)
    if cost is None:
        return 0
    return 1 - cost / n_cnots
