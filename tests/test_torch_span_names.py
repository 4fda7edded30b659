"""Every literal span name in ``mpitest_tpu_torch/`` is registered in the
port's ``utils/span_schema.py`` (the reference's sortlint rule SL003, for
the port's own files).

The scan reads every ``mpitest_tpu_torch/**/*.py`` and takes the name
argument of ``<x>.span(``, ``<x>.maybe_span(`` / ``maybe_span(``,
``<spans|log|slog|span_log>.event|record|emit(``, and ``emit(`` /
``maybe_span(`` imported from ``utils/spans.py`` and
``_emit_collective(`` (span names), and ``<x>.phase(`` (phase names).  A
name that is not a string literal must resolve, inside its function, to
an assignment of literals (``_traced_call``'s
``"jit_compile_execute" if first else "jit_execute"``), or sit in one of
the pass-through sites that are the mechanism itself.  The port's span
names are also the reference's: the registry adds none of its own.
"""

from __future__ import annotations

import ast
import pathlib

import pytest

from mpitest_tpu.utils import span_schema as ref_schema
from mpitest_tpu_torch.utils import span_schema

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = REPO / "mpitest_tpu_torch"

_SPAN_ATTRS = ("span", "maybe_span")
_POINT_ATTRS = ("event", "record", "emit")
_POINT_BASES = ("spans", "log", "slog", "span_log")
_BARE = ("emit", "maybe_span", "_emit_collective")

#: (file, function) sites that pass a caller's name through: the span
#: mechanism itself and the collectives' one emitter, whose callers pass
#: literals (checked as such).
_PASS_THROUGH = {
    ("mpitest_tpu_torch/utils/spans.py", "emit"),
    ("mpitest_tpu_torch/utils/spans.py", "maybe_span"),
    ("mpitest_tpu_torch/utils/trace.py", "phase"),
    ("mpitest_tpu_torch/utils/trace.py", "span"),
    ("mpitest_tpu_torch/parallel/collectives.py", "_emit_collective"),
}


def _kind(call: ast.Call, bare: set[str]) -> str | None:
    f = call.func
    if isinstance(f, ast.Name):
        return "span" if f.id in bare else None
    if not isinstance(f, ast.Attribute):
        return None
    if f.attr in _SPAN_ATTRS:
        return "span"
    if f.attr == "phase":
        return "phase"
    if f.attr in _POINT_ATTRS:
        base = f.value
        name = base.id if isinstance(base, ast.Name) else \
            base.attr if isinstance(base, ast.Attribute) else ""
        if name in _POINT_BASES:
            return "span"
    return None


def _literals(node: ast.AST) -> list[str] | None:
    """The string literals an expression can take: a constant, or an
    if-expression of constants; None for anything else."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, ast.IfExp):
        a, b = _literals(node.body), _literals(node.orelse)
        return a + b if a is not None and b is not None else None
    return None


def scan(rel: str, src: str) -> tuple[list[tuple[int, str, str]], list[str]]:
    """``(names, problems)``: each ``(line, kind, name)`` found, and the
    sites whose name is neither literal nor resolvable."""
    tree = ast.parse(src)
    # bare names match only where they are the span module's own (a local
    # helper called emit, such as a sink, is not a span call)
    bare = {a.asname or a.name for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom)
            and node.module == "mpitest_tpu_torch.utils.spans"
            for a in node.names if a.name in _BARE}
    bare |= {node.name for node in ast.walk(tree)
             if isinstance(node, ast.FunctionDef)
             and node.name == "_emit_collective"}
    names: list[tuple[int, str, str]] = []
    problems: list[str] = []

    def visit(node: ast.AST, func: ast.AST | None) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            func = node
        if isinstance(node, ast.Call):
            kind = _kind(node, bare)
            if kind is not None and node.args:
                arg = node.args[0]
                lits = _literals(arg)
                if lits is None and isinstance(arg, ast.Name) and func is not None:
                    found: list[str] = []
                    for sub in ast.walk(func):
                        if isinstance(sub, ast.Assign) and any(
                                isinstance(t, ast.Name) and t.id == arg.id
                                for t in sub.targets):
                            got = _literals(sub.value)
                            if got is None:
                                found = []
                                break
                            found += got
                    lits = found or None
                fname = getattr(func, "name", None)
                if lits is not None:
                    names.extend((node.lineno, kind, n) for n in lits)
                elif (rel, fname) not in _PASS_THROUGH:
                    problems.append(f"{rel}:{node.lineno}: span name is not a "
                                    "literal and does not resolve to literals")
        for child in ast.iter_child_nodes(node):
            visit(child, func)

    visit(tree, None)
    return names, problems


def _registered(kind: str, name: str) -> bool:
    return (name in span_schema.PHASE_NAMES if kind == "phase"
            else span_schema.is_registered(name))


def _package_names() -> tuple[dict[str, list], list[str]]:
    out, problems = {}, []
    for f in sorted(PACKAGE.rglob("*.py")):
        rel = f.relative_to(REPO).as_posix()
        names, probs = scan(rel, f.read_text())
        out[rel] = names
        problems += probs
    return out, problems


def test_every_literal_span_name_is_registered():
    found, problems = _package_names()
    assert not problems, problems
    bad = [f"{rel}:{line}: {kind} name {name!r}"
           for rel, names in found.items() for line, kind, name in names
           if not _registered(kind, name)]
    assert not bad, bad
    seen = {name for names in found.values() for _, kind, name in names
            if kind == "span"}
    # the scan reaches every producer layer of the slice
    assert {"sort", "ingest", "jit_compile_execute", "jit_execute", "radix_pass",
            "splitter_round", "negotiate_probe", "all_gather", "psum", "pmax",
            "ragged_all_to_all", "verify", "exchange_balance", "restage",
            "external.run", "external.merge", "ingest.parse",
            "egress.decode"} <= seen


@pytest.mark.parametrize("src,ok", [
    ("def f(t):\n    with t.spans.span('sort'):\n        pass\n", True),
    ("def f(t):\n    with t.spans.span('sortt'):\n        pass\n", False),
    ("def f(spans):\n    spans.event('radix_passes')\n", False),
    ("def f(spans):\n    spans.record('ingest.parse', 0.0, 0.0)\n", True),
    ("from mpitest_tpu_torch.utils.spans import emit\n"
     "def f():\n    emit('ragged_all_to_all', bytes=1)\n", True),
    ("from mpitest_tpu_torch.utils.spans import maybe_span\n"
     "def f():\n    with maybe_span('negotiate'):\n        pass\n", False),
    ("def f(t):\n    with t.phase('sorting'):\n        pass\n", False),
    ("def f(t):\n    with t.phase('decode'):\n        pass\n", True),
    ("def f(t, first):\n    name = 'jit_execute' if first else 'jit_bogus'\n"
     "    with t.spans.span(name):\n        pass\n", False),
    ("def f(t, nm):\n    with t.spans.span(nm):\n        pass\n", None),
], ids=["registered", "typo", "point-typo", "record", "emit", "maybe-span",
        "phase-typo", "phase", "resolved-ifexp", "unresolved"])
def test_scan_catches_unregistered_names(src, ok):
    """The scanner itself: a planted unregistered name fails, a computed
    name that does not resolve is a problem."""
    names, problems = scan("x.py", src)
    if ok is None:
        assert problems and not names
        return
    assert not problems
    assert all(_registered(k, n) for _, k, n in names) is ok


def test_registry_is_the_reference_registry():
    """The port adds no span name of its own: the same names, phases and
    constants as the reference's schema."""
    assert span_schema.SPAN_NAMES.keys() == ref_schema.SPAN_NAMES.keys()
    assert span_schema.PHASE_NAMES == ref_schema.PHASE_NAMES
    assert span_schema.all_names() == ref_schema.all_names()
    for const in ("PHASE_PREFIX", "INGEST_HOST_STAGES", "INGEST_XFER_STAGES",
                  "FAULT_SPAN", "RETRY_SPAN", "VERIFY_SPAN", "BALANCE_SPAN",
                  "RESTAGE_SPAN", "PLAN_SPAN", "EXTERNAL_RUN_SPAN",
                  "EXTERNAL_MERGE_SPAN", "TRACE_ID_ATTR", "BATCH_ID_ATTR"):
        assert getattr(span_schema, const) == getattr(ref_schema, const)
