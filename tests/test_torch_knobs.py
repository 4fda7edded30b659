"""The port's knob tooling against the reference's: ``scoped_env``, the
generated table (``reference_table``, ``python -m
mpitest_tpu_torch.utils.knobs``) and README's block of it.

Every knob both packages register has the reference's name, type,
default and "validates" spec; the description may be worded for the port.
One default is rendered differently on purpose: the port's flight
recorder directory lives in the process's temp dir (ROADMAP Queue 3), so
its row shows ``$TMPDIR`` where the reference's shows ``/tmp``.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mpitest_tpu.utils import knobs as ref_knobs
from mpitest_tpu_torch.utils import knobs

REPO = Path(__file__).resolve().parent.parent

BEGIN = ("<!-- torch-knob-table:begin (generated by `python -m "
         "mpitest_tpu_torch.utils.knobs`; edit mpitest_tpu_torch/utils/knobs.py, "
         "not this block) -->")
END = "<!-- torch-knob-table:end -->"

#: The reference's knobs that belong to its bench, native runtime and XLA
#: (ROADMAP, "Not to port").
NOT_PORTED = re.compile(r"^(BENCH_|COMM_|MINIMPI_NP$|XLA_FLAGS$|F64_|FIX_PARTS$|"
                        r"MESHB_|PROBE_|SKEW_|STRESS64_)")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows(table: str) -> dict[str, list[str]]:
    """name -> [type, default, validates, description] of a rendered table."""
    out = {}
    for line in table.splitlines()[2:]:
        cells = [c.strip() for c in re.split(r"(?<!\\)\|", line)[1:-1]]
        out[cells[0].strip("`")] = cells[1:]
    return out


SHARED = sorted(k.name for k in knobs.iter_knobs())


def test_the_port_registers_every_reference_knob_but_the_unported():
    ref = {k.name for k in ref_knobs.iter_knobs()}
    assert set(SHARED) <= ref
    assert len(SHARED) == 63
    missing = sorted(ref - set(SHARED))
    assert missing and all(NOT_PORTED.match(n) for n in missing), missing


@pytest.mark.parametrize("name", SHARED)
def test_table_row_equals_reference(name):
    """Type, default and validates columns are the reference's row's."""
    got = _rows(knobs.reference_table())[name]
    want = _rows(ref_knobs.reference_table())[name]
    if name == "SORT_FLIGHT_RECORDER_DIR":
        want[1] = want[1].replace("/tmp/", "$TMPDIR/")
    assert got[:3] == want[:3]
    assert got[3]  # every port knob has its own nonempty description
    k, r = knobs._REGISTRY[name], ref_knobs._REGISTRY[name]
    assert (k.kind, k.spec) == (r.kind, r.spec)
    # the reference's C backends validate none of them: the port needs no
    # ``consumer`` field, every knob it registers is read by Python
    assert r.consumer == "python"


def test_every_table_row_has_five_cells():
    """Literal pipes in any column are escaped, so each row renders as
    exactly the header's five cells."""
    for line in knobs.reference_table().splitlines():
        assert len(re.split(r"(?<!\\)\|", line)[1:-1]) == 5, line


def test_main_prints_the_table():
    out = subprocess.run([sys.executable, "-m", "mpitest_tpu_torch.utils.knobs"],
                         capture_output=True, text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout == knobs.reference_table() + "\n"
    assert "| `SORT_ALGO` | enum | sample | sample \\| radix |" in out.stdout


def test_readme_block_is_the_generated_table():
    """SL031 for the port: README's block between the port's markers is
    the table byte for byte, so every registered knob is documented; it
    is not the reference's ``knob-table`` block."""
    readme = (REPO / "README.md").read_text()
    assert readme.count(BEGIN) == 1 and readme.count(END) == 1
    block = readme.split(BEGIN, 1)[1].split(END, 1)[0]
    assert block == "\n" + knobs.reference_table() + "\n"
    ref_block = readme.split("<!-- knob-table:begin", 1)[1].split(
        "<!-- knob-table:end -->", 1)[0]
    assert BEGIN not in ref_block and ref_knobs.reference_table() in ref_block


def test_register_refuses_an_empty_doc_and_a_second_registration():
    with pytest.raises(ValueError, match="doc must be nonempty"):
        knobs.register("SORT_X_TEST", "int", 0, "an integer", "", int)
    with pytest.raises(ValueError, match="registered twice"):
        knobs.register("SORT_ALGO", "enum", "sample", "sample | radix", "d", str)


_SCOPES = [
    ("set a fresh name", {"A": None}, {"A": "1"}),
    ("override a set name", {"A": "0"}, {"A": "1"}),
    ("unset a set name", {"A": "0"}, {"A": None}),
    ("unset an unset name", {"A": None}, {"A": None}),
    ("several at once", {"A": "x", "B": None}, {"A": None, "B": "y"}),
]


def _env_after(mod, before: dict, overrides: dict, raise_inside: bool):
    """(env inside the block, env after it) for one module's scoped_env."""
    names = {f"SORT_SCOPED_TEST_{k}": v for k, v in before.items()}
    over = {f"SORT_SCOPED_TEST_{k}": v for k, v in overrides.items()}
    for k, v in names.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    inside = None
    try:
        with mod.scoped_env(**over):
            inside = {k: os.environ.get(k) for k in names}
            if raise_inside:
                raise KeyError("inside")
    except KeyError:
        assert raise_inside
    after = {k: os.environ.get(k) for k in names}
    for k in names:
        os.environ.pop(k, None)
    return inside, after


@pytest.mark.parametrize("raise_inside", [False, True], ids=["clean", "exception"])
@pytest.mark.parametrize("label,before,overrides", _SCOPES, ids=[s[0] for s in _SCOPES])
def test_scoped_env_equals_reference(label, before, overrides, raise_inside):
    """Set, unset (``None``) and restore on exit, an exception included,
    exactly as the reference's ``scoped_env``."""
    got = _env_after(knobs, before, overrides, raise_inside)
    want = _env_after(ref_knobs, before, overrides, raise_inside)
    assert got == want
    inside, after = got
    assert after == {f"SORT_SCOPED_TEST_{k}": v for k, v in before.items()}
    assert inside == {f"SORT_SCOPED_TEST_{k}": v for k, v in overrides.items()}


def test_scoped_env_flips_what_knobs_read():
    with knobs.scoped_env(SORT_ALGO="radix"):
        assert knobs.get("SORT_ALGO") == "radix"
        with knobs.scoped_env(SORT_ALGO=None):
            assert knobs.get("SORT_ALGO") == "sample"
        assert knobs.get("SORT_ALGO") == "radix"
