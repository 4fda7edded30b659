"""Key files in the port (``utils/io.py`` over ``utils/native_encode.py``)
against the reference readers (``mpitest_tpu/utils/io.py``).

The port reads text under both ``SORT_NATIVE_ENCODE`` engines (the C
parser built from ``native/encode.c``, and numpy); the reference reads
with its numpy engine, the oracle of its own parity suite.  Tolerance:
exact bytes, and the same exception types and header messages.
"""

from __future__ import annotations

import numpy as np
import pytest

from mpitest_tpu.utils import io as ref_io
from mpitest_tpu_torch.utils import io as kio
from mpitest_tpu_torch.utils import native_encode

DTYPES = [np.int8, np.uint16, np.int32, np.uint32, np.int64, np.uint64,
          np.float32, np.float64]


@pytest.fixture(scope="module")
def native_built():
    if not native_encode.build():
        pytest.skip(f"no C compiler built the parser: {native_encode.unavailable_reason()}")
    return True


@pytest.fixture(params=["native", "off"])
def engine(request, monkeypatch):
    """The port's engine; the reference always reads with numpy."""
    if request.param == "native":
        request.getfixturevalue("native_built")
        monkeypatch.setenv("SORT_NATIVE_ENCODE", "on")
    else:
        monkeypatch.setenv("SORT_NATIVE_ENCODE", "off")
    return request.param


def _ref(fn, monkeypatch, *args, **kw):
    """``fn`` of the reference with its numpy engine; the port's engine
    setting is restored after."""
    import os

    old = os.environ.get("SORT_NATIVE_ENCODE")
    monkeypatch.setenv("SORT_NATIVE_ENCODE", "off")
    try:
        return fn(*args, **kw)
    finally:
        if old is None:
            monkeypatch.delenv("SORT_NATIVE_ENCODE")
        else:
            monkeypatch.setenv("SORT_NATIVE_ENCODE", old)


def _keys(dtype, n, seed):
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        x = (rng.standard_normal(n) * 10.0 ** rng.integers(-20, 20, n)).astype(dt)
        x[:3] = [0.0, -0.0, 1e-30]
        return x
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_text_read_matches_reference(dtype, engine, tmp_path, monkeypatch):
    x = _keys(dtype, 3000, seed=np.dtype(dtype).itemsize)
    path = str(tmp_path / "k.txt")
    ref_io.write_keys_text(path, x)
    got_auto = kio.read_keys_auto(path, dtype=dtype)
    _same(got_auto, _ref(ref_io.read_keys_auto, monkeypatch, path, dtype=dtype))
    _same(kio.read_keys_text(path, dtype=dtype),
          _ref(ref_io.read_keys_text, monkeypatch, path, dtype=dtype))
    _same(got_auto, x)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_text_writer_matches_reference(dtype, tmp_path):
    x = _keys(dtype, 700, seed=3)
    kio.write_keys_text(str(tmp_path / "p.txt"), x, chunk_elems=64)
    ref_io.write_keys_text(str(tmp_path / "r.txt"), x)
    assert (tmp_path / "p.txt").read_bytes() == (tmp_path / "r.txt").read_bytes()


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_sortbin1_round_trip_both_ways(dtype, engine, tmp_path, monkeypatch):
    x = _keys(dtype, 1001, seed=5)
    mine, theirs = str(tmp_path / "p.bin"), str(tmp_path / "r.bin")
    kio.write_keys_binary(mine, x)
    ref_io.write_keys_binary(theirs, x)
    assert (tmp_path / "p.bin").read_bytes() == (tmp_path / "r.bin").read_bytes()
    for path in (mine, theirs):
        assert kio.sniff_format(path) == ref_io.sniff_format(path) == "binary"
        _same(kio.read_keys_binary(path, dtype), x)
        _same(kio.read_keys_auto(path, dtype), x)
        mm = kio.read_keys_auto(path, dtype, mmap=True)
        assert isinstance(mm, np.memmap)
        _same(np.asarray(mm), x)
        _same(kio.read_keys_text(path, dtype), x)  # the sniff inside the text reader


def test_sniff_text(tmp_path):
    p = tmp_path / "k.txt"
    p.write_text("1 2 3\n")
    assert kio.sniff_format(str(p)) == ref_io.sniff_format(str(p)) == "text"


@pytest.mark.parametrize("kind", ["binary", "text"])
def test_iter_key_chunks_matches_reference(kind, engine, tmp_path, monkeypatch):
    x = _keys(np.int64, 5000, seed=11)
    path = str(tmp_path / "k")
    (kio.write_keys_binary if kind == "binary" else kio.write_keys_text)(path, x)
    got = list(kio.iter_key_chunks(path, np.int64, chunk_elems=777, threads=3))
    want = _ref(lambda: list(ref_io.iter_key_chunks(path, np.int64, chunk_elems=777,
                                                    threads=3)), monkeypatch)
    _same(np.concatenate(got), np.concatenate(want))
    _same(np.concatenate(got), x)
    if kind == "binary":
        assert [c.size for c in got] == [c.size for c in want]


def test_text_chunk_boundaries_never_split_a_key(engine, tmp_path, monkeypatch):
    """Irregular whitespace and a tiny chunk: every block ends on a token
    boundary, so no key is cut in two."""
    rng = np.random.default_rng(4)
    x = rng.integers(-(10**12), 10**12, 2000, dtype=np.int64)
    seps = rng.choice([" ", "\n", "\t", "  \r\n"], x.size)
    (tmp_path / "k.txt").write_text("".join(f"{v}{s}" for v, s in zip(x, seps)))
    monkeypatch.setenv("SORT_INGEST_CHUNK", "7")
    got = kio.read_keys_auto(str(tmp_path / "k.txt"), np.int64)
    _same(got, x)


def test_empty_and_whitespace_only_text(engine, tmp_path):
    (tmp_path / "e.txt").write_text("")
    (tmp_path / "w.txt").write_text(" \n\t \n")
    for name in ("e.txt", "w.txt"):
        out = kio.read_keys_auto(str(tmp_path / name), np.int32)
        assert out.size == 0 and out.dtype == np.int32


def test_bad_tokens_raise_the_reference_types(engine, tmp_path, monkeypatch):
    cases = {"bad.txt": ("1 2 x3 4\n", ValueError),
             "big.txt": ("1 99999999999999999999 3\n", OverflowError)}
    for name, (text, exc) in cases.items():
        p = tmp_path / name
        p.write_text(text)
        with pytest.raises(exc):
            kio.read_keys_auto(str(p), np.int64)
        with pytest.raises(exc):
            _ref(ref_io.read_keys_auto, monkeypatch, str(p), np.int64)


def test_header_errors_match_reference(engine, tmp_path, monkeypatch):
    p = str(tmp_path / "k.bin")
    kio.write_keys_binary(p, np.arange(10, dtype=np.int32))
    for reader in ("read_keys_binary", "read_keys_auto"):
        with pytest.raises(ValueError) as mine:
            getattr(kio, reader)(p, np.int64)
        with pytest.raises(ValueError) as theirs:
            _ref(getattr(ref_io, reader), monkeypatch, p, np.int64)
        assert str(mine.value) == str(theirs.value) == f"'{p}' holds i32 keys, not int64"
    t = tmp_path / "k.txt"
    t.write_text("1 2 3\n")
    with pytest.raises(ValueError) as mine:
        kio.read_keys_binary(str(t), np.int32)
    with pytest.raises(ValueError) as theirs:
        _ref(ref_io.read_keys_binary, monkeypatch, str(t), np.int32)
    assert str(mine.value) == str(theirs.value)
    with pytest.raises(ValueError) as mine:
        native_encode.check_bin_header(b"SORTBIN1\xff\x04" + b"\0" * 6, "f",
                                       np.dtype(np.int32))
    assert str(mine.value) == "'f' holds \xff32 keys, not int32"


def test_engine_knob_semantics(monkeypatch, tmp_path):
    """auto: native when the library loads, else numpy; on: raises when
    it does not; off: numpy."""
    # every cached load field is patched, so the real verdict comes back
    for name, value in (("LIB_PATH", tmp_path / "missing.so"), ("_LOADED", False),
                        ("_LIB", None), ("_LIB_ERR", None)):
        monkeypatch.setattr(native_encode, name, value)
    monkeypatch.setenv("SORT_NATIVE_ENCODE", "auto")
    assert native_encode.engine() == "python"
    assert "not built" in native_encode.unavailable_reason()
    monkeypatch.setenv("SORT_NATIVE_ENCODE", "on")
    with pytest.raises(RuntimeError, match="SORT_NATIVE_ENCODE=on"):
        native_encode.engine()
    monkeypatch.setenv("SORT_NATIVE_ENCODE", "off")
    assert native_encode.engine() == "python"
    monkeypatch.setenv("SORT_NATIVE_ENCODE", "maybe")
    with pytest.raises(ValueError, match="SORT_NATIVE_ENCODE='maybe'"):
        native_encode.engine()


def test_auto_picks_native_once_built(native_built, monkeypatch):
    monkeypatch.setenv("SORT_NATIVE_ENCODE", "auto")
    assert native_encode.engine() == "native"
    assert native_encode.LIB_PATH.parts[-3:] == ("build", "native", "libencode.so")
