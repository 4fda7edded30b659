"""The port stands alone: importing it (the store included) pulls in
neither ``jax`` nor the reference package, no source file of it (nor
``chip_smoke.py``) imports them, and ``sort()`` never falls back to the
CPU on its own."""

from __future__ import annotations

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|mpitest_tpu)(\.|\s|$|,)",
                        re.MULTILINE)


def test_import_pulls_in_no_jax():
    code = ("import sys, mpitest_tpu_torch, mpitest_tpu_torch.ops.kernels, "
            "mpitest_tpu_torch.ops.radix, mpitest_tpu_torch.utils.io, "
            "mpitest_tpu_torch.utils.native_encode, mpitest_tpu_torch.cli, "
            "mpitest_tpu_torch.ops.pack, mpitest_tpu_torch.ops.exchange, "
            "mpitest_tpu_torch.parallel.mesh, mpitest_tpu_torch.parallel.collectives, "
            "mpitest_tpu_torch.models.radix_sort, mpitest_tpu_torch.models.sample_sort, "
            "mpitest_tpu_torch.store.external, mpitest_tpu_torch.store.merge, "
            "mpitest_tpu_torch.store.runs, mpitest_tpu_torch.store.compress, "
            "mpitest_tpu_torch.store.aio, mpitest_tpu_torch.store.manifest, "
            "mpitest_tpu_torch.models.records, mpitest_tpu_torch.models.segmented, "
            "mpitest_tpu_torch.models.ingest, mpitest_tpu_torch.utils.spans, "
            "mpitest_tpu_torch.utils.trace, mpitest_tpu_torch.utils.metrics, "
            "mpitest_tpu_torch.utils.timeline, mpitest_tpu_torch.utils.span_schema, "
            "mpitest_tpu_torch.utils.flight_recorder, mpitest_tpu_torch.faults, "
            "mpitest_tpu_torch.models.supervisor, mpitest_tpu_torch.models.plan, "
            "mpitest_tpu_torch.models.planner, mpitest_tpu_torch.doctor, "
            "mpitest_tpu_torch.report\n"
            "mpitest_tpu_torch.external_sort\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'mpitest_tpu' or "
            "m.startswith('mpitest_tpu.'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_source_imports_jax_or_reference():
    files = sorted((REPO / "mpitest_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    names = {f.relative_to(REPO).as_posix() for f in files}
    assert {"mpitest_tpu_torch/ops/radix.py", "mpitest_tpu_torch/utils/io.py",
            "mpitest_tpu_torch/utils/native_encode.py",
            "mpitest_tpu_torch/cli.py", "mpitest_tpu_torch/ops/pack.py",
            "mpitest_tpu_torch/ops/exchange.py", "mpitest_tpu_torch/parallel/mesh.py",
            "mpitest_tpu_torch/parallel/collectives.py",
            "mpitest_tpu_torch/models/radix_sort.py",
            "mpitest_tpu_torch/models/sample_sort.py",
            "mpitest_tpu_torch/store/__init__.py", "mpitest_tpu_torch/store/external.py",
            "mpitest_tpu_torch/faults.py",
            "mpitest_tpu_torch/store/merge.py", "mpitest_tpu_torch/store/runs.py",
            "mpitest_tpu_torch/store/compress.py", "mpitest_tpu_torch/store/aio.py",
            "mpitest_tpu_torch/store/manifest.py", "mpitest_tpu_torch/models/records.py",
            "mpitest_tpu_torch/models/segmented.py",
            "mpitest_tpu_torch/models/ingest.py", "mpitest_tpu_torch/utils/spans.py",
            "mpitest_tpu_torch/utils/trace.py", "mpitest_tpu_torch/utils/metrics.py",
            "mpitest_tpu_torch/utils/timeline.py",
            "mpitest_tpu_torch/utils/span_schema.py",
            "mpitest_tpu_torch/utils/flight_recorder.py",
            "mpitest_tpu_torch/models/plan.py", "mpitest_tpu_torch/models/planner.py",
            "mpitest_tpu_torch/doctor.py", "mpitest_tpu_torch/report.py"} <= names
    for f in files:
        hits = _FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f.relative_to(REPO)} imports {hits}"


@pytest.mark.parametrize("rel", ["mpitest_tpu_torch/models/plan.py",
                                 "mpitest_tpu_torch/models/planner.py",
                                 "mpitest_tpu_torch/doctor.py"])
def test_vocabulary_modules_load_standalone_on_the_stdlib(rel):
    """plan.py, planner.py and doctor.py load by file path, with no
    package context, and import neither torch nor numpy (as in the
    reference: their registries must resolve without the package)."""
    code = ("import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location('m', {rel!r})\n"
            "m = importlib.util.module_from_spec(spec)\n"
            "sys.modules['m'] = m\n"
            "spec.loader.exec_module(m)\n"
            "print(sorted(k for k in sys.modules if k.split('.')[0] in "
            "('torch', 'numpy', 'jax', 'mpitest_tpu', 'mpitest_tpu_torch')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_pattern_catches_forbidden_imports():
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("from mpitest_tpu.ops import keys")
    assert _FORBIDDEN.search("    import mpitest_tpu")
    assert not _FORBIDDEN.search("from mpitest_tpu_torch.ops import keys")


def test_sort_without_device_needs_cuda(monkeypatch):
    import mpitest_tpu_torch as mt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        mt.sort(np.arange(10, dtype=np.int32))
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        mt.sort(torch.arange(10, dtype=torch.int32))
    assert mt.sort(np.arange(10, dtype=np.int32)[::-1],
                   device="cpu").tolist() == list(range(10))


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card the smoke script exits non-zero and prints no result
    line; alone in a directory (without the package) it fails too."""
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
