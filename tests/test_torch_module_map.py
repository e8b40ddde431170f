"""The port's module map: every file, public top-level name and top-level
function parameter of the JAX package has a counterpart in the port or a
row in ``docs/PORT_MAP.md`` that says why not.

Both trees are parsed with ``ast``; neither package is imported.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX = ROOT / "svt_speechbrain_tpu"
PORT = ROOT / "svt_speechbrain_tpu_torch"
MAP = ROOT / "docs" / "PORT_MAP.md"


def _files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*.py"))


def _top_level(path):
    """{name: node} of what a module defines or imports at its top, also
    under a top-level ``if`` or ``try``."""
    names = {}

    def visit(body, first):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                names.setdefault(node.name, node)
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            names.setdefault(n.id, node)
            elif isinstance(node, ast.AnnAssign) and isinstance(
                    node.target, ast.Name):
                names.setdefault(node.target.id, node)
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                for a in node.names:
                    names.setdefault((a.asname or a.name).split(".")[0],
                                     node)
            elif isinstance(node, (ast.If, ast.Try)) and first:
                visit(node.body, False)
                visit(getattr(node, "orelse", []), False)
                for h in getattr(node, "handlers", []):
                    visit(h.body, False)

    visit(ast.parse(path.read_text()).body, True)
    return names


def _params(fn):
    a = fn.args
    out = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    out += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return out


def _map_rows():
    """The first cell of every table row: files, names and parameters."""
    files, names, params = set(), set(), set()
    for line in MAP.read_text().splitlines():
        m = re.match(r"\|\s*`([^`]+)`", line)
        if not m:
            continue
        key = m.group(1)
        if "::" not in key:
            files.add(key)
            continue
        file, rest = key.split("::", 1)
        call = re.fullmatch(r"(\w+)\(([^)]*)\)", rest)
        if call:
            for p in call.group(2).split(","):
                params.add((file, call.group(1), p.strip()))
        else:
            names.add((file, rest))
    return files, names, params


def _jax_public(path):
    return {name: node for name, node in _top_level(path).items()
            if not name.startswith("_")
            and not isinstance(node, (ast.Import, ast.ImportFrom))}


def test_the_map_parses_and_names_only_what_the_jax_package_has():
    files, names, params = _map_rows()
    assert files and names and params
    jax_files = set(_files(JAX))
    for f in files:
        assert f in jax_files, f"map row for a file the JAX package lacks: {f}"
    for f, name in names:
        assert name in _jax_public(JAX / f), f"{f}::{name}"
    for f, fn, p in params:
        node = _top_level(JAX / f)[fn]
        assert p in _params(node), f"{f}::{fn}({p})"


def test_every_jax_file_has_a_counterpart_or_a_row():
    files, _, _ = _map_rows()
    port = set(_files(PORT))
    missing = [f for f in _files(JAX) if f not in port and f not in files]
    assert not missing, f"JAX files with no port and no map row: {missing}"


def test_every_public_name_has_a_counterpart_or_a_row():
    _, names, _ = _map_rows()
    port = set(_files(PORT))
    missing = []
    for f in _files(JAX):
        if f not in port:
            continue
        have = _top_level(PORT / f)
        missing += [f"{f}::{n}" for n in _jax_public(JAX / f)
                    if n not in have and (f, n) not in names]
    assert not missing, f"public names with no port and no map row: {missing}"


def test_every_parameter_has_a_counterpart_or_a_row():
    _, _, params = _map_rows()
    port = set(_files(PORT))
    missing = []
    for f in _files(JAX):
        if f not in port:
            continue
        have = _top_level(PORT / f)
        for name, node in _jax_public(JAX / f).items():
            mine = have.get(name)
            if not isinstance(node, ast.FunctionDef) or not isinstance(
                    mine, ast.FunctionDef):
                continue
            missing += [f"{f}::{name}({p})" for p in _params(node)
                        if p not in _params(mine)
                        and (f, name, p) not in params]
    assert not missing, f"parameters with no port and no map row: {missing}"


@pytest.mark.parametrize("name", ["native/__init__.py", "utils/accuracy.py",
                                  "utils/bleu.py", "utils/der.py",
                                  "utils/flops.py", "utils/hpopt.py",
                                  "utils/profiling.py"])
def test_the_last_modules_are_ported(name):
    assert (PORT / name).is_file()
