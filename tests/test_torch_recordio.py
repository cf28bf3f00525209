"""The RecordIO container (`paddle_tpu_torch.data.recordio` over
csrc/recordio.cc) and the reader layers over it, against the JAX package
on the CPU.

- Files written by either package, plain, compressed and in many chunks,
  are byte-for-byte equal, and each package reads the other's.
- The JAX tests' failure modes on the port: a corrupt chunk resyncs (the
  same records survive as in the JAX scanner), a truncated file counts
  its skipped chunk, a huge `comp_len` header is bounded by the file, a
  missing file raises NotFoundError, a writer flushes its tail on
  `__del__`, the threaded loader closes early without a deadlock.
- `layers.io.open_recordio_file` / `open_files` give the JAX package's
  feeds; a misconfigured shape raises ValueError.
- The library is built with g++ into the build dir; a failed build
  raises.
"""

import gc
import os
import struct

import numpy as np
import pytest

from paddle_tpu.data import recordio as jrio
from paddle_tpu.layers import io as jio

from paddle_tpu_torch.core.enforce import NotFoundError
from paddle_tpu_torch.data import recordio as trio
from paddle_tpu_torch.layers import io as tio


def _write(mod, path, records, **kw):
    with mod.RecordIOWriter(path, **kw) as w:
        for r in records:
            w.write(r)


def _read(mod, path):
    with mod.RecordIOScanner(path) as s:
        return list(s), s.skipped_chunks


KINDS = {
    "plain": (lambda: [b"hello", b"", b"x" * 10000, b"world"], {}),
    "compressed": (lambda: [bytes(np.random.RandomState(i).randint(
        0, 256, 100).astype(np.uint8)) for i in range(50)] + [b"a" * 50000],
        {"compress": True}),
    "multi_chunk": (lambda: [bytes([i % 256]) * 1000 for i in range(100)],
                    {"max_chunk_bytes": 8192}),
}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_files_are_byte_equal_and_cross_read(kind, tmp_path):
    make, kw = KINDS[kind]
    recs = make()
    jpath, tpath = str(tmp_path / "j.rio"), str(tmp_path / "t.rio")
    _write(jrio, jpath, recs, **kw)
    _write(trio, tpath, recs, **kw)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    assert _read(trio, jpath) == (recs, 0)
    assert _read(jrio, tpath) == (recs, 0)


@pytest.mark.parametrize("compress", [False, True])
def test_numpy_records_cross_read(compress, tmp_path):
    rng = np.random.RandomState(0)
    data = [(rng.rand(8, 4).astype("float32"),
             np.array([i], dtype="int64")) for i in range(20)]
    jpath, tpath = str(tmp_path / "j.rio"), str(tmp_path / "t.rio")
    assert trio.write_numpy_records(tpath, iter(data), compress) == 20
    jrio.write_numpy_records(jpath, iter(data), compress)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    with trio.RecordIOScanner(jpath) as s:
        got = list(trio.read_numpy_records(s))
    with jrio.RecordIOScanner(tpath) as s:
        back = list(jrio.read_numpy_records(s))
    for (a, b), (x, y), (u, v) in zip(data, got, back):
        assert a.tobytes() == x.tobytes() == u.tobytes()
        assert b.tobytes() == y.tobytes() == v.tobytes()


def _damaged(path, how):
    recs = [bytes([i]) * 512 for i in range(64)]
    _write(trio, path, recs, max_chunk_bytes=2048)
    data = bytearray(open(path, "rb").read())
    if how == "payload":
        data[len(data) // 2] ^= 0xFF
    elif how == "truncated":
        data = data[:len(data) - 100]
    elif how == "comp_len":
        data[12:16] = struct.pack("<I", len(data) * 2)
    elif how == "huge_comp_len":
        data[12:16] = struct.pack("<I", 0xFFFFFFF0)
    open(path, "wb").write(bytes(data))
    return recs


@pytest.mark.parametrize("how", ["payload", "truncated", "comp_len",
                                 "huge_comp_len"])
def test_damaged_files_resync_as_in_jax(how, tmp_path):
    path = str(tmp_path / "d.rio")
    recs = _damaged(path, how)
    got, skipped = _read(trio, path)
    assert skipped >= 1 and 0 < len(got) < len(recs)
    assert all(g in recs for g in got)
    assert (got, skipped) == _read(jrio, path)


def test_missing_files_raise(tmp_path):
    with pytest.raises(NotFoundError):
        trio.RecordIOScanner(str(tmp_path / "nope.rio"))
    ok = str(tmp_path / "ok.rio")
    _write(trio, ok, [b"x"])
    with pytest.raises(NotFoundError):
        trio.ParallelRecordLoader([ok, str(tmp_path / "nope.rio")])
    with pytest.raises(Exception):
        trio.ParallelRecordLoader([])


def test_writer_del_flushes_the_tail(tmp_path):
    path = str(tmp_path / "d.rio")
    w = trio.RecordIOWriter(path)
    w.write(b"tail-record")
    del w
    gc.collect()
    assert _read(trio, path) == ([b"tail-record"], 0)


def test_parallel_loader_reads_every_record(tmp_path):
    paths, expect = [], set()
    for i in range(6):
        p = str(tmp_path / f"f{i}.rio")
        recs = [f"{i}:{j}".encode() for j in range(200)]
        _write(trio, p, recs, max_chunk_bytes=512,
               compress=bool(i % 2))
        expect.update(recs)
        paths.append(p)
    with trio.ParallelRecordLoader(paths, num_threads=3,
                                   queue_capacity=32) as ld:
        got = list(ld)
        assert ld.skipped_chunks == 0
    with jrio.ParallelRecordLoader(paths, num_threads=3) as ld:
        jgot = list(ld)
    assert len(got) == len(expect) and set(got) == expect == set(jgot)


def test_loader_early_close_does_not_deadlock(tmp_path):
    p = str(tmp_path / "f.rio")
    _write(trio, p, [b"r" * 100] * 1000, max_chunk_bytes=512)
    ld = trio.ParallelRecordLoader([p], num_threads=2, queue_capacity=4)
    it = iter(ld)
    assert next(it) == b"r" * 100
    ld.close()      # producers blocked on the full queue must exit
    ld.close()


def _flat_records(path, mod, n=10):
    rng = np.random.RandomState(1)
    xs = [rng.rand(3, 4).astype("float32") for _ in range(n)]
    ys = [rng.randint(0, 5, (1,)).astype("int64") for _ in range(n)]
    _write(mod, path, [x.tobytes() + y.tobytes() for x, y in zip(xs, ys)])


def test_open_recordio_file_and_open_files_match_jax(tmp_path):
    paths = [str(tmp_path / f"{i}.recordio") for i in range(2)]
    _flat_records(paths[0], trio)
    _flat_records(paths[1], jrio, 4)
    args = dict(shapes=[(3, 4), (1,)], dtypes=["float32", "int64"],
                names=["x", "y"])
    for treader, jreader in (
            (tio.open_recordio_file(paths[0], **args),
             jio.open_recordio_file(paths[0], **args)),
            (tio.open_files(paths, thread_num=2, **args),
             jio.open_files(paths, thread_num=2, **args))):
        got, want = list(treader()), list(jreader())
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert sorted(g) == ["x", "y"]
            for k in g:
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
                assert g[k].tobytes() == w[k].tobytes()
    batched = list(tio.batch(tio.open_files(paths, **args), 7)())
    assert [b["x"].shape for b in batched] == [(7, 3, 4), (7, 3, 4)]


def test_open_recordio_rejects_mismatched_shapes(tmp_path):
    path = str(tmp_path / "d.recordio")
    _write(trio, path, [np.zeros(12, "float32").tobytes()])
    bad = tio.open_recordio_file(path, shapes=[(4,)], dtypes=["float32"],
                                 names=["x"])
    with pytest.raises(ValueError, match="misconfiguration"):
        list(bad())
    jbad = jio.open_recordio_file(path, shapes=[(4,)], dtypes=["float32"],
                                  names=["x"])
    with pytest.raises(ValueError, match="misconfiguration"):
        list(jbad())


def test_library_is_built_into_the_build_dir_and_a_failed_build_raises(
        tmp_path, monkeypatch):
    from paddle_tpu_torch import kernels
    path = trio.build()
    assert os.path.dirname(path) == kernels.build_dir()
    assert os.path.basename(path).startswith("recordio-")
    bad = tmp_path / "broken.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(trio, "_SRC", str(bad))
    monkeypatch.setenv("PTT_KERNEL_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="recordio build failed"):
        trio.build()
    assert not [f for f in os.listdir(tmp_path / "build")
                if f.endswith(".so")]
