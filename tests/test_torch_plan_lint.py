"""Every literal plan decision, planner policy and doctor rule name in
``mpitest_tpu_torch/`` is registered (the reference's sortlint rules
SL005, SL006 and SL007, for the port's own files), and the port's three
vocabularies are the reference's.

The scan reads every ``mpitest_tpu_torch/**/*.py`` and checks:

* SL005: the first argument of ``<plan>.decide|actual|bump(`` (receivers
  named ``plan``, ``sort_plan``, ``bplan``, ``splan``, or an attribute
  ``.plan``) is a literal in ``models/plan.PLAN_DECISIONS``;
* SL006: ``<planner>.policy("x")`` and ``<plan>.decide("planner",
  chosen="x")`` name a policy in ``models/planner.PLANNER_POLICIES``;
* SL007: ``<doctor>.run_rule("x")``, ``.alert("x")`` / ``._alert("x")``,
  a ``rule=`` literal on a ``"serve.alert"`` emission, and the first
  argument of ``Finding(`` / ``_rule(`` name a rule in
  ``doctor.DOCTOR_RULES``.

``models/plan.py`` and ``models/planner.py`` are exempt from the check of
their own vocabulary, as in the reference.
"""

from __future__ import annotations

import ast
import pathlib

import pytest

from mpitest_tpu import doctor as ref_doctor
from mpitest_tpu.models import plan as ref_plan
from mpitest_tpu.models import planner as ref_planner
from mpitest_tpu_torch import doctor
from mpitest_tpu_torch.models import plan, planner

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = REPO / "mpitest_tpu_torch"

_PLAN_BASES = ("plan", "sort_plan", "bplan", "splan")
_PLANNER_BASES = ("planner", "planner_mod", "sort_planner", "tuner")
_DOCTOR_BASES = ("doctor", "doctor_mod", "sort_doctor")
_EXEMPT = {"SL005": "mpitest_tpu_torch/models/plan.py",
           "SL006": "mpitest_tpu_torch/models/planner.py"}


def _base_name(f: ast.Attribute) -> str:
    base = f.value
    return base.id if isinstance(base, ast.Name) else \
        base.attr if isinstance(base, ast.Attribute) else ""


def _literal(node: ast.AST | None) -> str | None:
    return node.value if isinstance(node, ast.Constant) and \
        isinstance(node.value, str) else None


def scan(rel: str, src: str) -> list[tuple[str, int, str]]:
    """``(rule, line, message)`` for every unregistered or unreadable name."""
    out: list[tuple[str, int, str]] = []
    for node in ast.walk(ast.parse(src)):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        first = node.args[0] if node.args else None
        lit = _literal(first)
        if isinstance(f, ast.Name):
            # the doctor's own findings and rule registrations too
            if f.id in ("Finding", "_rule") and lit is not None \
                    and lit not in doctor.DOCTOR_RULES:
                out.append(("SL007", node.lineno, f"rule {lit!r}"))
            continue
        if not isinstance(f, ast.Attribute):
            continue
        base = _base_name(f)
        if f.attr in ("decide", "actual", "bump") and base in _PLAN_BASES \
                and first is not None and rel != _EXEMPT["SL005"]:
            if lit is None:
                out.append(("SL005", node.lineno, "non-literal decision name"))
            elif lit not in plan.PLAN_DECISIONS:
                out.append(("SL005", node.lineno, f"decision {lit!r}"))
        if f.attr == "decide" and base in _PLAN_BASES and lit == "planner":
            for kw in node.keywords:
                chosen = _literal(kw.value) if kw.arg == "chosen" else None
                if chosen is not None and chosen not in planner.PLANNER_POLICIES:
                    out.append(("SL006", node.lineno, f"policy {chosen!r}"))
        if f.attr == "policy" and base in _PLANNER_BASES and lit is not None \
                and rel != _EXEMPT["SL006"] and lit not in planner.PLANNER_POLICIES:
            out.append(("SL006", node.lineno, f"policy {lit!r}"))
        if lit is not None and ((f.attr == "run_rule" and base in _DOCTOR_BASES)
                                or f.attr in ("alert", "_alert")) \
                and lit not in doctor.DOCTOR_RULES:
            out.append(("SL007", node.lineno, f"rule {lit!r}"))
        if f.attr in ("record", "event", "emit") and lit == "serve.alert":
            for kw in node.keywords:
                rule = _literal(kw.value) if kw.arg == "rule" else None
                if rule is not None and rule not in doctor.DOCTOR_RULES:
                    out.append(("SL007", node.lineno, f"rule {rule!r}"))
    return out


def _names(src: str, attr: str, bases: tuple[str, ...]) -> set[str]:
    """Literal first arguments of ``<base>.<attr>(`` calls."""
    found = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr == attr and _base_name(node.func) in bases:
            lit = _literal(node.args[0]) if node.args else None
            if lit is not None:
                found.add(lit)
    return found


def test_every_literal_plan_planner_and_doctor_name_is_registered():
    bad, decided = [], set()
    for f in sorted(PACKAGE.rglob("*.py")):
        rel = f.relative_to(REPO).as_posix()
        src = f.read_text()
        bad += [f"{rel}:{line}: {rule} {msg}" for rule, line, msg in scan(rel, src)]
        decided |= _names(src, "decide", _PLAN_BASES)
    assert not bad, bad
    # the scan reaches the stamps of every chokepoint layer
    assert {"algo", "cap", "restage", "engine", "exchange_engine", "passes",
            "ladder", "planner", "external"} <= decided


@pytest.mark.parametrize("src,rule", [
    ("def f(plan):\n    plan.decide('algo', chosen='radix')\n", None),
    ("def f(plan):\n    plan.decide('algoo', chosen='radix')\n", "SL005"),
    ("def f(self):\n    self.plan.bump('caps', 'regrows')\n", "SL005"),
    ("def f(plan, k):\n    plan.actual(k, x=1)\n", "SL005"),
    ("def f(tracer):\n    tracer.plan.actual('ladder', misses=1)\n", None),
    ("def f(plan):\n    plan.decide('planner', chosen='magic')\n", "SL006"),
    ("def f(plan):\n    plan.decide('planner', chosen='static')\n", None),
    ("def f():\n    planner_mod.policy('radix_wide')\n", "SL006"),
    ("def f():\n    doctor.run_rule('skew', {})\n", "SL007"),
    ("def f(s):\n    s.alert('deadline_burn')\n", None),
    ("def f(log):\n    log.record('serve.alert', 0.0, 0.0, rule='flap')\n", "SL007"),
    ("def f():\n    return Finding('cap_trash', 'warn', 's')\n", "SL007"),
    ("def f(other):\n    other.decide('anything')\n", None),
], ids=["decision", "decision-typo", "bump-typo", "non-literal", "tracer-plan",
        "policy-typo", "policy", "policy-lookup", "run-rule", "alert",
        "serve-alert", "finding", "unrelated-receiver"])
def test_scan_catches_unregistered_names(src, rule):
    """The scanner itself: each planted unregistered name is caught under
    its rule, registered ones and unrelated receivers pass."""
    got = {r for r, _, _ in scan("x.py", src)}
    assert got == ({rule} if rule else set())


@pytest.mark.parametrize("name,mine,ref", [
    ("PLAN_DECISIONS", plan.PLAN_DECISIONS, ref_plan.PLAN_DECISIONS),
    ("PLANNER_POLICIES", planner.PLANNER_POLICIES, ref_planner.PLANNER_POLICIES),
    ("DOCTOR_RULES", doctor.DOCTOR_RULES, ref_doctor.DOCTOR_RULES),
])
def test_vocabularies_are_the_references(name, mine, ref):
    """The same registered names, in the same order (each entry's doc line
    is worded for the port)."""
    assert list(mine) == list(ref), name
    assert all(isinstance(v, str) and v for v in mine.values())
