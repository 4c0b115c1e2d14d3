"""The port's CLI, checkpoints and trace against symmer_tpu.

The four subcommands run on H2 (contextual_subspace on H3+, since H2 is
noncontextual).  The port's CLI runs as ``python -m symmer_torch.command_line ... --device
cpu`` in a child process in which ``import jax`` fails; symmer_tpu's
command functions run in this process (x64 on, as its CLI tests set
SYMMER_TPU_X64).  The JSON results must be equal: the same keys, strings
and integers, floats within 1e-10 (the same host arithmetic; the exact
energies come from two eigensolver calls).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from symmer_tpu import PauliwordOp as JOp
from symmer_tpu import QuantumState as JState
from symmer_tpu import command_line as jcli
from symmer_tpu import io as jio

from symmer_torch import io as tio
from symmer_torch.operators import from_numpy_planes, from_numpy_state

from .conftest import H2_JW_DICT, VENDORED_HAM_DIR, _REPO_ROOT

# H2 is noncontextual (its contextual subspace is empty): H3+ (6 q) there
H3_JSON = os.path.join(VENDORED_HAM_DIR, "H3+_STO-3G_SINGLET_JW.json")

# the child runs the port's CLI with jax made unimportable
_CHILD = ("import runpy, sys; sys.modules['jax'] = None; sys.argv = sys.argv[1:]; "
          "runpy.run_module('symmer_torch.command_line', run_name='__main__')")


@pytest.fixture
def h2_json(tmp_path):
    path = tmp_path / "h2.json"
    with open(path, "w") as f:
        json.dump({k: [v.real, v.imag] for k, v in H2_JW_DICT.items()}, f)
    return str(path)


def run_port_cli(args):
    env = dict(os.environ, PYTHONPATH=_REPO_ROOT)
    return subprocess.run([sys.executable, "-c", _CHILD, "symmer_torch", *args],
                          capture_output=True, text=True, env=env, timeout=300)


def run_reference(args) -> dict:
    parsed = jcli.build_parser().parse_args(args)
    return json.loads(json.dumps(jcli.COMMANDS[parsed.command](parsed), default=str))


def assert_same_json(a, b, path="$"):
    assert type(a) is type(b) or {type(a), type(b)} == {int, float}, path
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_same_json(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            assert_same_json(u, v, f"{path}[{i}]")
    elif isinstance(a, float):
        assert abs(a - b) <= 1e-10, (path, a, b)
    else:
        assert a == b, path


CLI_CASES = {
    "taper": ["taper", "--taper-reference", "1,1,0,0", "--exact-energies"],
    "contextual_subspace": ["contextual_subspace", "-H", H3_JSON, "--taper-reference",
                            "1,1,0,0,0,0", "--n-qubits", "3", "--exact-energies"],
    "reduce": ["reduce", "--taper-reference", "1,1,0,0", "--n-qubits", "1",
               "--exact-energies"],
    "vqe": ["vqe", "--taper-reference", "1,1,0,0", "--max-cycles", "3", "--exact-energies"],
}


@pytest.mark.parametrize("command", sorted(CLI_CASES))
def test_cli_matches_reference(command, h2_json):
    args = CLI_CASES[command]
    if "-H" not in args:
        args = args + ["-H", h2_json]
    out = run_port_cli(args + ["--device", "cpu"])
    assert out.returncode == 0, out.stderr
    assert_same_json(json.loads(out.stdout), run_reference(args))


def test_cli_config_file_and_output_dir(h2_json, tmp_path):
    cfg = tmp_path / "job.yaml"
    cfg.write_text(f"command: taper\nhamiltonian: {h2_json}\ntaper-reference: 1,1,0,0\n"
                   f"output-dir: {tmp_path / 'out'}\ndevice: cpu\n")
    out = run_port_cli(["--config", str(cfg)])
    assert out.returncode == 0, out.stderr
    (name,) = os.listdir(tmp_path / "out")
    with open(tmp_path / "out" / name) as f:
        got = json.load(f)
    assert_same_json(got, run_reference(CLI_CASES["taper"][:3] + ["-H", h2_json]))


def test_cli_without_card_or_arguments_fails(h2_json):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = run_port_cli(["taper", "-H", h2_json, "--device", "cuda"])
    assert out.returncode != 0 and "is_available" in out.stderr
    assert run_port_cli(["taper", "--device", "cpu"]).returncode != 0


def test_cli_compat_names(tmp_path):
    import argparse

    from symmer_torch.command_line import check_path_to_dir, check_path_to_file, cli
    from symmer_torch.command_line import command_interface

    assert command_interface is cli
    f = tmp_path / "x.json"
    f.write_text("{}")
    assert check_path_to_dir(str(tmp_path)) == str(tmp_path)
    assert check_path_to_file(str(f)) == str(f)
    with pytest.raises(argparse.ArgumentTypeError):
        check_path_to_dir(str(f))
    with pytest.raises(argparse.ArgumentTypeError):
        check_path_to_file(str(tmp_path))


@pytest.mark.parametrize("seed", range(3))
def test_io_round_trips_across_packages(seed, tmp_path):
    np.random.seed(seed)
    op = JOp.random(5, 9).cleanup()
    psi = JState.random(5, 6)
    t_op = from_numpy_planes(op.x_pack, op.z_pack, op.coeff_vec, op.n_qubits)
    t_psi = from_numpy_state(psi._s_pack, psi._amps, psi.n_qubits)
    # written by one package, read by the other
    jio.save_operator(op, str(tmp_path / "j_op.json"))
    tio.save_operator(t_op, str(tmp_path / "t_op.json"))
    assert tio.load_operator(str(tmp_path / "j_op.json")).to_dictionary == op.to_dictionary
    assert jio.load_operator(str(tmp_path / "t_op.json")) == op
    jio.save_state(psi, str(tmp_path / "j_psi.json"))
    tio.save_state(t_psi, str(tmp_path / "t_psi.json"))
    loaded = tio.load_state(str(tmp_path / "j_psi.json"))
    assert loaded.to_dictionary == psi.to_dictionary and loaded.vec_type == psi.vec_type
    assert jio.load_state(str(tmp_path / "t_psi.json")) == psi
    with open(tmp_path / "j_op.json") as a, open(tmp_path / "t_op.json") as b:
        assert json.load(a) == json.load(b)


def test_trace_writes_a_trace(tmp_path):
    import torch

    from symmer_torch import PauliwordOp, config
    from symmer_torch.profiling import trace

    old = (config.backend, config.device)
    config.backend, config.device = "device", "cpu"
    try:
        with trace(str(tmp_path)) as prof:
            PauliwordOp.random(6, 40).cleanup()
            torch.ones(8).sum()
    finally:
        config.backend, config.device = old
    (name,) = os.listdir(tmp_path)
    assert name.endswith(".pt.trace.json")
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::sum" for e in events)
    assert prof.key_averages()
