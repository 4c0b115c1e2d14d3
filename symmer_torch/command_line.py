"""Command-line interface of symmer_torch.

The counterpart of ``symmer_tpu/command_line.py``: a config-driven CLI for
the flagship flows (the reference's ``command_line.py`` is broken: it imports
a nonexistent ``CS_VQE`` class and reads an argument key that is never
populated -- see symmer command_line.py:6 and :140).

Usage:
    python -m symmer_torch.command_line taper -H hamiltonian.json --taper-reference 1,1,0,0 -o out/
    python -m symmer_torch.command_line contextual_subspace -H hamiltonian.json --n-qubits 3 -o out/
    python -m symmer_torch.command_line reduce -H hamiltonian.json --n-qubits 4 -o out/
    python -m symmer_torch.command_line vqe -H hamiltonian.json --taper-reference 1,1,0,0
    python -m symmer_torch.command_line --config job.yaml

``--device`` (default ``cuda``) sets ``config.device``: the device path runs
there, and a missing card raises at once; ``--device cpu`` runs the device
path's plain versions on the CPU.

The Hamiltonian JSON may be a flat {pauli: coeff} dictionary, a
{pauli: [re, im]} dictionary, or a reference-format file with a
top-level "hamiltonian" key.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
from typing import Dict, Optional


def load_hamiltonian_dict(path: str) -> Dict[str, complex]:
    with open(path) as f:
        data = json.load(f)
    if "hamiltonian" in data:
        data = data["hamiltonian"]
    out = {}
    for k, v in data.items():
        if isinstance(v, (list, tuple)):
            out[k] = complex(v[0], v[1] if len(v) > 1 else 0.0)
        elif isinstance(v, str):
            out[k] = complex(v)
        else:
            out[k] = complex(v)
    return out


def _serialize(obj):
    from .operators import PauliwordOp, QuantumState
    from .operators.utils import safe_PauliwordOp_to_dict, safe_QuantumState_to_dict

    if isinstance(obj, QuantumState):
        return safe_QuantumState_to_dict(obj)
    if isinstance(obj, PauliwordOp):
        return safe_PauliwordOp_to_dict(obj)
    return obj


def cmd_taper(args) -> dict:
    import numpy as np

    from .operators import PauliwordOp, QuantumState
    from .projection import QubitTapering
    from .utils import exact_gs_energy

    H = PauliwordOp.from_dictionary(load_hamiltonian_dict(args.hamiltonian))
    QT = QubitTapering(H)
    out = {
        "n_qubits_before": H.n_qubits,
        "symmetry_generators": _serialize(QT.symmetry_generators),
    }
    ref = None
    if args.taper_reference:
        ref = np.array([int(b) for b in args.taper_reference.split(",")])
    sector = None
    if args.sector:
        sector = np.array([int(b) for b in args.sector.split(",")])
    if ref is None and sector is None:
        print("warning: no reference state or sector given; using exact ground state",
              file=sys.stderr)
        _, ref_qs = exact_gs_energy(H.to_sparse_matrix)
        ref_qs = ref_qs.cleanup(zero_threshold=1e-4).normalize
        H_taper = QT.taper_it(ref_state=ref_qs)
    else:
        H_taper = QT.taper_it(ref_state=ref, sector=sector)
    out["tapered_hamiltonian"] = _serialize(H_taper)
    out["n_qubits_after"] = H_taper.n_qubits
    out["sector"] = [int(v) for v in QT.stabilizers.coeff_vec]
    if args.exact_energies:
        out["gs_energy_before"] = float(exact_gs_energy(H.to_sparse_matrix)[0])
        out["gs_energy_after"] = float(exact_gs_energy(H_taper.to_sparse_matrix)[0])
    return out


def cmd_contextual_subspace(args) -> dict:
    import numpy as np

    from .operators import PauliwordOp
    from .projection import ContextualSubspace
    from .utils import exact_gs_energy

    H = PauliwordOp.from_dictionary(load_hamiltonian_dict(args.hamiltonian))
    ref = None
    if args.taper_reference:
        ref = np.array([int(b) for b in args.taper_reference.split(",")])
    CS = ContextualSubspace(
        H,
        noncontextual_strategy=args.noncontextual_strategy,
        reference_state=ref,
    )
    CS.update_stabilizers(args.n_qubits, strategy=args.stabilizer_strategy)
    H_cs = CS.project_onto_subspace()
    out = {
        "n_qubits_before": H.n_qubits,
        "noncontextual_energy": float(CS.noncontextual_operator.energy),
        "noncontextual_hamiltonian": _serialize(CS.noncontextual_operator),
    }
    if isinstance(H_cs, float):
        out["reduced_energy"] = H_cs
    else:
        out["reduced_hamiltonian"] = _serialize(H_cs)
        out["n_qubits_after"] = H_cs.n_qubits
        if args.exact_energies:
            out["gs_energy_before"] = float(exact_gs_energy(H.to_sparse_matrix)[0])
            out["gs_energy_after"] = float(exact_gs_energy(H_cs.to_sparse_matrix)[0])
    return out


def cmd_reduce(args) -> dict:
    import numpy as np

    from .operators import PauliwordOp
    from .projection import QubitSubspaceManager
    from .utils import exact_gs_energy

    H = PauliwordOp.from_dictionary(load_hamiltonian_dict(args.hamiltonian))
    ref = None
    if args.taper_reference:
        ref = np.array([int(b) for b in args.taper_reference.split(",")])
    QSM = QubitSubspaceManager(H, ref_state=ref)
    H_red = QSM.get_reduced_hamiltonian(args.n_qubits)
    out = {
        "n_qubits_before": H.n_qubits,
        "n_qubits_after": H_red.n_qubits,
        "reduced_hamiltonian": _serialize(H_red),
    }
    if args.exact_energies:
        out["gs_energy_before"] = float(exact_gs_energy(H.to_sparse_matrix)[0])
        out["gs_energy_after"] = float(exact_gs_energy(H_red.to_sparse_matrix)[0])
    return out


def cmd_vqe(args) -> dict:
    """Taper (optional) then ADAPT-VQE with the fused device backend --
    end-to-end ground-state estimation from a Hamiltonian JSON (a capability
    the reference CLI never had)."""
    import numpy as np

    from .evolution.variational_optimization import ADAPT_VQE
    from .operators import PauliwordOp
    from .projection import QubitTapering
    from .utils import exact_gs_energy

    H = PauliwordOp.from_dictionary(load_hamiltonian_dict(args.hamiltonian))
    out = {"n_qubits_before": H.n_qubits}
    ref_state = None
    if args.taper_reference:
        ref_bits = np.array([int(b) for b in args.taper_reference.split(",")])
        qt = QubitTapering(H)
        H = qt.taper_it(ref_state=ref_bits)
        ref_state = qt.tapered_ref_state.normalize
        out["n_qubits_after_taper"] = H.n_qubits

    pool = None
    if args.pool == "random":
        np.random.seed(0)
        pool = PauliwordOp.random(H.n_qubits, args.pool_size, density=0.5).cleanup()
        pool.coeff_vec[:] = 1
    if pool is None:
        # single-qubit + nearest-neighbour two-qubit Pauli pool (qubit-ADAPT)
        strings = []
        for q in range(H.n_qubits):
            for p in "XYZ":
                strings.append("I" * q + p + "I" * (H.n_qubits - q - 1))
        for q in range(H.n_qubits - 1):
            for p1 in "XY":
                for p2 in "XY":
                    strings.append(
                        "I" * q + p1 + p2 + "I" * (H.n_qubits - q - 2)
                    )
        pool = PauliwordOp.from_list(strings)

    if args.max_cycles < 1:
        raise SystemExit("--max-cycles must be >= 1 (the ADAPT loop needs at least one cycle)")
    adapt = ADAPT_VQE(H, excitation_pool=pool, ref_state=ref_state)
    adapt.verbose = False
    adapt.expectation_eval = args.expectation_eval
    res = adapt.optimize(max_cycles=args.max_cycles, gtol=args.gtol)
    out["vqe_energy"] = float(res["result"]["fun"])
    out["n_excitations"] = len(res["adapt_operator"])
    out["adapt_operator"] = res["adapt_operator"]
    if args.exact_energies:
        out["gs_energy_exact"] = float(exact_gs_energy(H.to_sparse_matrix)[0])
        out["vqe_error"] = out["vqe_energy"] - out["gs_energy_exact"]
    return out


COMMANDS = {
    "taper": cmd_taper,
    "contextual_subspace": cmd_contextual_subspace,
    "reduce": cmd_reduce,
    "vqe": cmd_vqe,
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="symmer_torch.command_line",
        description="qubit-subspace reduction toolkit on PyTorch / CUDA"
    )
    parser.add_argument("command", nargs="?", choices=list(COMMANDS), help="flow to run")
    parser.add_argument("--config", type=str, help="YAML config file (overrides flags)")
    parser.add_argument("--hamiltonian", "-H", type=str, help="Hamiltonian JSON path")
    parser.add_argument(
        "--output-dir", "-o", type=str, default=None,
        help="output directory (default: print to stdout)",
    )
    parser.add_argument(
        "--taper-reference", "-tr", type=str, default=None,
        help="comma-separated reference bitstring, e.g. 1,1,0,0",
    )
    parser.add_argument("--sector", type=str, default=None,
                        help="comma-separated +-1 sector assignment")
    parser.add_argument("--n-qubits", type=int, default=None,
                        help="target qubit count (contextual_subspace / reduce)")
    parser.add_argument("--noncontextual-strategy", type=str,
                        default="SingleSweep_magnitude")
    parser.add_argument("--stabilizer-strategy", type=str, default="aux_preserving")
    parser.add_argument("--exact-energies", action="store_true",
                        help="diagonalise before/after (small systems only)")
    parser.add_argument("--expectation-eval", type=str, default="device_array",
                        help="VQE backend (device_array = the statevector on --device)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the device path (cuda or cpu)")
    parser.add_argument("--pool", type=str, default="qubit",
                        choices=["qubit", "random"],
                        help="ADAPT excitation pool (vqe command)")
    parser.add_argument("--pool-size", type=int, default=20,
                        help="pool size for --pool random")
    parser.add_argument("--max-cycles", type=int, default=10,
                        help="ADAPT cycles (vqe command)")
    parser.add_argument("--gtol", type=float, default=1e-3,
                        help="ADAPT pool-gradient stopping norm")
    return parser


def check_path_to_dir(potential_path: str) -> str:
    """argparse ``type=`` validator: the path must be an existing directory
    (reference command_line.py:9-21)."""
    if not os.path.isdir(potential_path):
        raise argparse.ArgumentTypeError("directory path defined is not valid")
    return potential_path


def check_path_to_file(potential_path: str) -> str:
    """argparse ``type=`` validator: the path must be an existing file
    (reference command_line.py:24-36)."""
    if not os.path.isfile(potential_path):
        raise argparse.ArgumentTypeError("file path defined is not valid")
    return potential_path


def cli() -> None:
    parser = build_parser()
    args = parser.parse_args()
    if args.config:
        import yaml

        with open(args.config) as f:
            cfg = yaml.safe_load(f)
        for key, value in cfg.items():
            setattr(args, key.replace("-", "_"), value)
    if not args.command:
        parser.error("no command given (and none found in --config)")
    if not args.hamiltonian:
        parser.error("must supply --hamiltonian")
    from .config import config

    config.device = args.device
    config.torch_device()  # a missing card raises here, not halfway through a flow

    result = COMMANDS[args.command](args)

    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)
        suffix = datetime.datetime.now().strftime("%y%m%d_%H%M%S")
        outloc = os.path.join(args.output_dir, f"{args.command}_{suffix}.json")
        with open(outloc, "w") as f:
            json.dump(result, f, indent=2, default=str)
        print(f"file saved at: {outloc}")
    else:
        json.dump(result, sys.stdout, indent=2, default=str)
        print()


# the reference's entry-point name (reference command_line.py:39; its parser
# is broken there -- undefined CS_VQE import at :6 and an unclosed handler at
# :140 -- so parity here is the working argparse pipeline under both names)
command_interface = cli


if __name__ == "__main__":
    cli()
