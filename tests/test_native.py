"""Native C++ library tests (skipped when the .so is not built)."""

import io
import os
import subprocess

import numpy as np
import pytest

from hiphase_jax.io import native
from hiphase_jax.io.bgzf import BGZF_EOF, BgzfBatchWriter, BgzfReader

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library not built")


def test_native_bgzf_roundtrip_with_python_reader():
    rng = np.random.default_rng(0)
    payloads = [rng.integers(0, 256, size=30000, dtype=np.uint8).tobytes()
                for _ in range(8)]
    blob = native.bgzf_compress_blocks(payloads, threads=2)
    r = BgzfReader(io.BytesIO(blob + BGZF_EOF))
    assert r.read_all() == b"".join(payloads)


def test_build_is_current_after_load():
    assert os.path.exists(native.SO_PATH)
    assert not native._is_stale()


def test_zlib_only_build_round_trips(tmp_path, monkeypatch):
    """The build without libdeflate (hosts that lack it) writes BGZF that
    the Python reader inflates, and inflates the Python writer's BGZF."""
    so = tmp_path / "libhiphase_native_zlib.so"
    subprocess.run(["make", "-s", "-B", "-C", native.NATIVE_DIR,
                    f"TARGET={so}", "HAVE_LIBDEFLATE=0"],
                   check=True, capture_output=True)
    monkeypatch.setattr(native, "SO_PATH", str(so))
    monkeypatch.setattr(native, "_is_stale", lambda: False)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    assert native.available() and not native.has_libdeflate()
    test_native_bgzf_roundtrip_with_python_reader()
    test_native_decompress_python_stream(tmp_path)


def test_native_decompress_python_stream(tmp_path):
    path = str(tmp_path / "x.gz")
    data = b"".join(f"row {i}\n".encode() for i in range(100000))
    w = BgzfBatchWriter(path)
    w.write(data)
    w.close()
    out = native.bgzf_decompress_all(open(path, "rb").read())
    assert out == data


def test_batch_writer_voffsets(tmp_path):
    """Deferred voffset conversion must land on exact record boundaries."""
    path = str(tmp_path / "v.gz")
    w = BgzfBatchWriter(path)
    marks = []
    for i in range(200000):
        marks.append(w.upos)
        w.write(f"record-{i}\n".encode())
    w.close()
    r = BgzfReader(path)
    for i in (0, 1, 77777, 199999):
        r.seek_virtual(w.voffset(marks[i]))
        assert r.readline() == f"record-{i}\n".encode()


def test_native_edit_distance_matches_python():
    from hiphase_jax.align.edit_distance import edit_distance
    rng = np.random.default_rng(1)
    Q = rng.choice(list(b"ACGT"), size=(100, 40)).astype(np.uint8)
    T = rng.choice(list(b"ACGT"), size=(100, 35)).astype(np.uint8)
    ql = rng.integers(0, 41, 100).astype(np.int32)
    tl = rng.integers(0, 36, 100).astype(np.int32)
    got = native.edit_distance_batch_native(Q, ql, T, tl, threads=2)
    for i in range(100):
        assert got[i] == edit_distance(bytes(Q[i, :ql[i]]), bytes(T[i, :tl[i]]))
