"""tpu_orc_torch ``demux/demux.py::_BinWriters``: stage 02's bin files
written by a pool of writer threads.

The pooled writers against the inline ones (one usable CPU): every
``.gz`` the same bytes but the gzip header's MTIME, one member each. A
writer's error raises in the caller, at the next ``write`` or at
``close``; a stream that fails part way raises its own error at once.
No writer thread outlives ``close`` or ``abort``. Shared counters under
more threads than cores, and the bound on the text in flight.
"""
import os
import random
import sys
import threading
import time
import zlib

import pytest
import torch

from tpu_orc_torch import synthetic
from tpu_orc_torch.demux import demux as D
from tpu_orc_torch.demux.adapters import AdapterBank
from tpu_orc_torch.io.fastq import Record
from tpu_orc_torch.utils.profiling import recording

# One intra-op thread: PyTorch's OpenMP workers spin between ops and
# starve the other pytest-xdist workers on a shared CPU.
torch.set_num_threads(1)

TIMEOUT_S = 120


def writer_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("demux-writer-")]


def wait_for(cond) -> None:
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < TIMEOUT_S
        time.sleep(0.01)


def use_writers(monkeypatch, n: int) -> None:
    """``n`` writer threads (0: inline, as on one usable CPU)."""
    monkeypatch.setattr(D, "_usable_cpus", lambda: n + 1)
    monkeypatch.setattr(D, "MAX_WRITERS", max(n, 1))


def random_chunks(seed: int, n_chunks: int = 12, n_bins: int = 9):
    """Chunks of (bin name, records) over a random mix of bins, some
    writes past the gzip writer's 128 KiB buffer, some of one record."""
    rng = random.Random(seed)
    k = 0
    chunks = []
    for _ in range(n_chunks):
        bins = []
        for b in rng.sample(range(n_bins), rng.randint(1, n_bins)):
            recs = []
            for _ in range(rng.choice((1, 3, 40, 200))):
                n = rng.randint(0, 900)
                seq = "".join(rng.choice("ACGTN") for _ in range(n))
                qual = "".join(chr(33 + rng.randint(0, 40)) for _ in range(n))
                recs.append(Record(f"r{k}", f"r{k} rc" if k % 3 else f"r{k}",
                                   seq, qual))
                k += 1
            bins.append((f"b{b}", recs))
        chunks.append(bins)
    return chunks


def write_all(root, chunks, fmt):
    ext = ".fastq.gz" if fmt == "fastq" else ".fasta.gz"
    w = D._BinWriters(fmt)
    for bins in chunks:
        w.write([(os.path.join(root, "SP5" if name < "b5" else "SP27",
                               name + ext), recs) for name, recs in bins])
    w.close()


def gz_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("fmt", ["fastq", "fasta"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_pooled_writes_same_bytes_as_inline(tmp_path, monkeypatch, fmt, n):
    chunks = random_chunks(seed=n)
    use_writers(monkeypatch, 0)
    write_all(str(tmp_path / "inline"), chunks, fmt)
    use_writers(monkeypatch, n)
    with recording() as rec:
        write_all(str(tmp_path / "pooled"), chunks, fmt)
    assert not writer_threads()
    names = gz_files(tmp_path / "inline")
    assert names == gz_files(tmp_path / "pooled")
    assert len(names) == len({b for c in chunks for b, _ in c})
    text = 0
    for name in names:
        a = (tmp_path / "inline" / name).read_bytes()
        b = (tmp_path / "pooled" / name).read_bytes()
        assert a[:4] + a[8:] == b[:4] + b[8:], name     # MTIME aside
        d = zlib.decompressobj(wbits=31)
        text += len(d.decompress(b))
        assert d.eof and d.unused_data == b"", name     # one member
    c, s = rec.counters(), rec.spans()
    assert c["demux.write_offloaded_bytes"] == c["demux.text_bytes"] == text
    assert c["demux.write_jobs"] == sum(len(bins) for bins in chunks)
    assert s["demux.gzip"]["n"] == c["demux.write_jobs"]
    assert s["demux.gzip"]["parent"] is None
    assert s["demux.write_wait"]["n"] == len(chunks)
    assert s["demux.drain"]["n"] == 1


def test_inline_writes_on_the_callers_thread(tmp_path, monkeypatch):
    """One usable CPU: no thread, ``demux.gzip`` under the caller's
    span, nothing offloaded, no wait."""
    use_writers(monkeypatch, 0)
    chunks = random_chunks(seed=5, n_chunks=3)
    with recording() as rec:
        with D.span("demux.write"):
            w = D._BinWriters("fastq")
            for bins in chunks:
                w.write([(str(tmp_path / (b + ".fastq.gz")), r)
                         for b, r in bins])
                assert not writer_threads()
        w.close()
    c, s = rec.counters(), rec.spans()
    assert s["demux.gzip"]["parent"] == "demux.write"
    assert "demux.write_wait" not in s
    assert "demux.write_offloaded_bytes" not in c
    assert "demux.write_backlog" not in c
    assert c["demux.text_bytes"] > 0


@pytest.mark.parametrize("when", ["next_write", "close"])
def test_writer_error_raises_in_caller(tmp_path, monkeypatch, when):
    """A bin under a path whose parent is a plain file: its writer fails,
    the caller raises that error, and every thread and file is done."""
    use_writers(monkeypatch, 2)
    (tmp_path / "plain").write_text("")
    bad = str(tmp_path / "plain" / "SP5" / "b0.fastq.gz")
    good = str(tmp_path / "ok" / "b1.fastq.gz")
    recs = random_chunks(seed=7, n_chunks=1)[0][0][1]
    w = D._BinWriters("fastq")
    w.write([(good, recs)])
    wait_for(lambda: w._queued == 0)
    w.write([(bad, recs)])
    if when == "next_write":
        wait_for(lambda: w._error is not None)
        with pytest.raises(OSError):
            w.write([(good, recs)])
        w.abort()
    else:
        with pytest.raises(OSError):
            w.close()
    assert not writer_threads()
    assert not os.path.exists(bad)
    d = zlib.decompressobj(wbits=31)    # the good file closed whole
    d.decompress(open(good, "rb").read())
    assert d.eof


@pytest.fixture(scope="module")
def banks(tmp_path_factory):
    d = synthetic.write_adapter_dir(str(tmp_path_factory.mktemp("adapters")))
    f = lambda n: os.path.join(d, synthetic.FILES[n])
    return (AdapterBank.from_fasta(f(0), 0.1, "cpu"),
            AdapterBank.from_fasta(f(1), 0.1, "cpu"))


@pytest.mark.parametrize("fail_at", [3, 17])
def test_stream_failure_propagates_and_stops_writers(banks, tmp_path,
                                                     monkeypatch, fail_at):
    """An input that raises in its first chunk or after two written
    chunks: ``dual_round_demux_stream`` raises that error in time and
    leaves no writer thread."""
    sp5, sp27 = banks
    use_writers(monkeypatch, 3)
    recs, _ = synthetic.make_plate(2, n5=3, n27=3, seed=9, insert_len=150)

    def reads():
        for k, r in enumerate(recs):
            if k == fail_at:
                raise RuntimeError("input failed")
            yield r

    out = {}

    def run():
        try:
            D.dual_round_demux_stream(reads(), sp5, sp27, "p",
                                      str(tmp_path / "out"), chunk_size=7)
        except RuntimeError as exc:
            out["exc"] = exc

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=TIMEOUT_S)
    assert not t.is_alive()
    assert str(out["exc"]) == "input failed"
    assert not writer_threads()


def test_shared_counts_under_switching(tmp_path, monkeypatch):
    """More writer threads than cores, switching as often as the
    interpreter allows: every byte accounted, every file whole."""
    n = 2 * (os.cpu_count() or 1) + 2
    use_writers(monkeypatch, n)
    rng = random.Random(11)
    lens = [4 * rng.randint(1, 40) for _ in range(64)]
    recs = [Record(f"r{k}", f"r{k}", "ACGT" * (n // 4), "I" * n)
            for k, n in enumerate(lens)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with recording() as rec:
            w = D._BinWriters("fastq")
            for c in range(40):
                w.write([(str(tmp_path / f"b{b}.fastq.gz"),
                          recs[(b + c) % 64:(b + c) % 64 + 1])
                         for b in range(2 * n)])
            w.close()
    finally:
        sys.setswitchinterval(old)
    assert not writer_threads()
    assert w._queued == 0 and w._jobs == 0
    c = rec.counters()
    assert c["demux.write_jobs"] == 40 * 2 * n
    assert c["demux.write_offloaded_bytes"] == c["demux.text_bytes"]
    got = 0
    for b in range(2 * n):
        d = zlib.decompressobj(wbits=31)
        got += len(d.decompress((tmp_path / f"b{b}.fastq.gz").read_bytes()))
        assert d.eof
    assert got == c["demux.text_bytes"]


def test_text_in_flight_is_bounded(tmp_path, monkeypatch):
    """Writers slower than the caller: ``write`` waits, and the text
    queued never passes the previous chunk's and the current one's."""
    use_writers(monkeypatch, 2)
    append = D._BinWriters._append

    def slow(fh, path, text):
        time.sleep(0.005)
        append(fh, path, text)

    monkeypatch.setattr(D._BinWriters, "_append", staticmethod(slow))
    chunks = random_chunks(seed=13, n_chunks=10)
    w = D._BinWriters("fasta")
    submit = w._submit
    sizes, seen = [0], []

    def watched(path, text):
        submit(path, text)
        sizes[-1] += len(text)
        seen.append(w._queued - sizes[-1] - (sizes[-2] if len(sizes) > 1
                                             else 0))

    w._submit = watched
    with recording() as rec:
        for bins in chunks:
            w.write([(str(tmp_path / (b + ".fasta.gz")), r)
                     for b, r in bins])
            sizes.append(0)
        w.close()
    assert not writer_threads()
    assert max(seen) <= 0
    assert rec.spans()["demux.write_wait"]["total_s"] > 0
