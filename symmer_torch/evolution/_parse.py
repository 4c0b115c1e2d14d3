"""Restricted arithmetic evaluation for QASM angle expressions.

QASM emitted by qiskit routinely carries symbolic angles (``pi/4``,
``3*pi/2``, ``-pi``).  A builtins-stripped ``eval`` is NOT a sandbox --
attribute traversal from literals still reaches arbitrary code -- so angle
strings from untrusted circuit files are parsed with ``ast`` and only plain
arithmetic nodes are interpreted (reference parses with bare ``eval``,
circuit_symmerlator.py:168-197; this is the hardened equivalent).
"""
import ast

import numpy as np

_BINOPS = {
    ast.Add: lambda a, b: a + b,
    ast.Sub: lambda a, b: a - b,
    ast.Mult: lambda a, b: a * b,
    ast.Div: lambda a, b: a / b,
    ast.Pow: lambda a, b: a ** b,
}
_UNARYOPS = {
    ast.UAdd: lambda a: a,
    ast.USub: lambda a: -a,
}


def _eval_node(node) -> float:
    if isinstance(node, ast.Expression):
        return _eval_node(node.body)
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
        return float(node.value)
    if isinstance(node, ast.Name) and node.id == "pi":
        return float(np.pi)
    if isinstance(node, ast.BinOp) and type(node.op) in _BINOPS:
        return _BINOPS[type(node.op)](_eval_node(node.left), _eval_node(node.right))
    if isinstance(node, ast.UnaryOp) and type(node.op) in _UNARYOPS:
        return _UNARYOPS[type(node.op)](_eval_node(node.operand))
    raise ValueError(
        f"disallowed construct in angle expression: {ast.dump(node)}"
    )


def safe_angle_eval(expr: str) -> float:
    """Evaluate a QASM angle expression (numbers, ``pi``, + - * / ** and
    unary sign only); raises ValueError on anything else."""
    try:
        tree = ast.parse(expr.strip(), mode="eval")
    except SyntaxError as exc:
        raise ValueError(f"unparsable angle expression {expr!r}") from exc
    try:
        # all operands are converted to float up front, so `**` is float pow
        # (an overflowing exponent raises instead of building a bigint)
        return _eval_node(tree)
    except (OverflowError, ZeroDivisionError) as exc:
        raise ValueError(f"angle expression {expr!r} does not evaluate") from exc
