"""``mpitest_tpu_torch.sort`` takes the reference's positional order:
``sort(x, algorithm, mesh, digit_bits, cap_factor, oversample, tracer,
return_result, pack, exchange_engine, payload)``, with ``device``
keyword-only.

Both packages are called positionally on the same keys and must give the
same bytes and the same result ``Fingerprint``: on a 2-rank mesh (the
port's ``cpu`` ranks against the reference's cpu:2 mesh) and on one rank.
The reference's exchange engine is named in its interpreter form
(``pallas_interpret``), whose caps align to 1024 as the port's do.
"""

from __future__ import annotations

import inspect

import numpy as np
import pytest

import mpitest_tpu_torch as mt
from mpitest_tpu.models import api as ref_api
from mpitest_tpu.models import verify as ref_vfy
from mpitest_tpu.parallel.mesh import make_mesh as ref_mesh
from mpitest_tpu.utils.trace import Tracer as RefTracer
from mpitest_tpu_torch.models import verify
from mpitest_tpu_torch.parallel.mesh import make_mesh
from mpitest_tpu_torch.utils.trace import Tracer

_X = np.random.default_rng(606).integers(-2**31, 2**31 - 1, 1 << 13,
                                         dtype=np.int32)


@pytest.fixture(autouse=True)
def _engine(monkeypatch):
    monkeypatch.setenv("SORT_LOCAL_ENGINE", "lax")


def _ref_fingerprint(res) -> verify.Fingerprint:
    """The reference verifier's output-side fingerprint of its result."""
    n_words = len(res.words)
    if res.counts is None:
        total = int(res.words[0].shape[0])
        _, xors, sums = ref_vfy._compile_contig(
            n_words, min(res.n_valid, total), total, True)(*res.words)
        count = res.n_valid
    else:
        _, count, xors, sums = ref_vfy._compile_ragged(
            n_words, res.n_valid, res.shard_slots, len(res.counts))(
            np.asarray(res.counts, np.int32), *res.words)
    return verify.Fingerprint(int(count), tuple(int(v) for v in xors),
                              tuple(int(v) for v in sums))


def test_positional_names_follow_the_reference():
    """Every positional parameter of the port's sort() has the
    reference's name and place, ``payload`` (the record sort) the last of
    them, as in the reference; ``device`` is keyword-only."""
    port = inspect.signature(mt.sort).parameters
    ref = list(inspect.signature(ref_api.sort).parameters)
    positional = [n for n, p in port.items()
                  if p.kind is inspect.Parameter.POSITIONAL_OR_KEYWORD]
    assert positional == ref
    assert positional[-1] == "payload"
    assert port["device"].kind is inspect.Parameter.KEYWORD_ONLY
    for name in positional:
        assert port[name].default == inspect.signature(ref_api.sort).parameters[
            name].default, name


def test_positional_mesh_and_digit_bits_on_two_ranks():
    """``sort(x, "radix", mesh, 8)``: the third argument is the mesh and the
    fourth the digit width, in both packages."""
    got = mt.sort(_X, "radix", make_mesh(2, devices=["cpu"] * 2), 8)
    want = ref_api.sort(_X, "radix", ref_mesh(2), 8)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert got.tobytes() == np.sort(_X).tobytes()


def test_positional_call_to_exchange_engine_on_two_ranks():
    """Every positional slot up to ``exchange_engine``: equal bytes, an
    equal result Fingerprint, and the digit width and engine each
    package reads from its slots."""
    pt, rt = Tracer(), RefTracer()
    got = mt.sort(_X, "radix", make_mesh(2, devices=["cpu"] * 2), 8, 2.0,
                  None, pt, True, None, "pallas")
    want = ref_api.sort(_X, "radix", ref_mesh(2), 8, 2.0, None, rt, True,
                        None, "pallas_interpret")
    assert got.to_numpy().tobytes() == want.to_numpy().tobytes()
    assert verify.result_fingerprint(got) == _ref_fingerprint(want)
    assert pt.counters["digit_bits"] == rt.counters["digit_bits"] == 8
    assert pt.counters["exchange_engine"] == "pallas"
    assert rt.counters["exchange_engine"] == "pallas_interpret"
    assert pt.counters["verify_runs"] == 1


def test_positional_tracer_and_return_result_on_one_rank():
    """``sort(x, "radix", None, None, 2.0, None, tracer, True)``: the
    seventh argument is the tracer and the eighth keeps the result."""
    pt, rt = Tracer(), RefTracer()
    got = mt.sort(_X, "radix", None, None, 2.0, None, pt, True, device="cpu")
    want = ref_api.sort(_X, "radix", ref_mesh(1), None, 2.0, None, rt, True)
    assert got.to_numpy().tobytes() == want.to_numpy().tobytes()
    assert verify.result_fingerprint(got) == _ref_fingerprint(want)
    assert pt.counters["local_engine"] == rt.counters["local_engine"] == "lax"
    assert pt.counters["verify_runs"] == 1


def test_device_is_keyword_only():
    """``device`` in the reference's mesh slot is refused, never read as a
    mesh, and as a keyword it still runs."""
    with pytest.raises(TypeError):
        mt.sort(_X, "radix", None, None, 2.0, None, None, False, None, None, None,
                "cpu")
    assert mt.sort(_X, "radix", device="cpu").tobytes() == np.sort(_X).tobytes()


def test_positional_payload_is_the_record_sort():
    """``payload`` in the eleventh slot: both packages run the record sort
    and return equal keys and payload bytes."""
    pay = np.random.default_rng(607).integers(0, 256, (_X.size, 6), dtype=np.uint8)
    got = mt.sort(_X, "radix", None, None, 2.0, None, None, False, None, None, pay,
                  device="cpu")
    want = ref_api.sort(_X, "radix", None, None, 2.0, None, None, False, None, None,
                        pay)
    assert got[0].tobytes() == want[0].tobytes()
    assert got[1].tobytes() == want[1].tobytes()
    order = np.argsort(_X, kind="stable")
    assert got[1].tobytes() == pay[order].tobytes()
